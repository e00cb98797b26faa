"""The collectives of the port's rank grid (parallel/mesh.py).

Serving (over the tp group):

- ``all_gather_heads``: the dense path's head gather after the
  head-sharded paged attention (JAX transformer/attention.py
  ``_replicate_heads``);
- ``psum``: the all-reduce sum of the MLA path's two phases (JAX
  parallel/collectives.py ``psum`` over the tp axis);
- ``broadcast_object``: the lead rank's per-step host decisions
  (inference/dynamic_engine.py keeps the ranks in step with it).

Training (Megatron's tensor-parallel maps, as ``torch.autograd``
Functions, and the dp reductions of flat fp32 buffers):

- ``copy_to_tp``: identity forward, all-reduce backward (the input of a
  column-parallel projection);
- ``reduce_from_tp``: all-reduce forward, identity backward (the output
  of a row-parallel projection and of the vocab-parallel embedding);
  bf16 partials are summed in fp32;
- ``gather_from_tp``: all-gather along the last dimension, the backward
  keeps this rank's slice;
- ``all_reduce``, ``reduce_scatter``, ``all_gather_into`` and
  ``all_gather_cat`` over one axis ("tp", "dp" or "world").

``calls`` counts each kind a call; ``traffic`` counts calls and result
bytes (JAX's HLO accounting: an all-gather's gathered output, a
reduce-scatter's shard) per "<kind>/<axis>". A group of one rank runs
nothing and counts nothing. Every collective runs under the
group's timeout (``build_mesh(timeout_s=)``): a rank that diverges fails
instead of hanging. Each call inside a traced iteration records one
MegaScan X event (trace/tracer.py ``collective``).

Gloo takes CUDA tensors for every collective used here (all-reduce sum
and max, all-gather, all_gather_into_tensor, reduce_scatter_tensor,
broadcast: chip_smoke.py's train_tp probes each on torch 2.11) and stages
them through host memory itself.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

calls: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0,
                         "reduce_scatter": 0}
traffic: Dict[str, Dict[str, int]] = {}

_EVENT = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter"}


def reset_counts() -> None:
    """Zero ``calls`` and empty ``traffic``."""
    calls.update(dict.fromkeys(calls, 0))
    traffic.clear()


def _axis(ctx, axis: str) -> Tuple[Any, List[int]]:
    """(process group, its global ranks) of `axis` for this rank."""
    if axis == "tp":
        return ctx.group, ctx.tp_ranks
    if axis == "dp":
        return ctx.dp_group, ctx.dp_ranks
    if axis == "world":
        return ctx.world_group, list(range(ctx.world))
    raise ValueError(f"axis {axis!r}: takes 'tp', 'dp' or 'world'")


def _count(kind: str, axis: str, nbytes: int) -> None:
    calls[kind] += 1
    t = traffic.setdefault(f"{kind}/{axis}", {"calls": 0, "bytes": 0})
    t["calls"] += 1
    t["bytes"] += int(nbytes)


@contextlib.contextmanager
def _traced(kind: str, axis: str, nbytes: int, ranks: List[int]):
    from megatronapp_tpu_torch.trace.tracer import get_tracer
    with get_tracer().collective(_EVENT[kind], group=ranks,
                                 bytes=int(nbytes), axes=axis):
        yield


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(x: torch.Tensor, ctx, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """x reduced over `axis` in place ("sum" or "max"); every rank gets
    the same bits."""
    group, ranks = _axis(ctx, axis)
    if len(ranks) == 1:
        return x
    _count("all_reduce", axis, _nbytes(x))
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    with _traced("all_reduce", axis, _nbytes(x), ranks):
        dist.all_reduce(x, op=red, group=group)
    return x


def reduce_scatter(flat: torch.Tensor, ctx, axis: str = "dp"
                   ) -> torch.Tensor:
    """This rank's chunk of the sum over `axis` of the 1-D `flat` (its
    length a multiple of the axis size): chunk i goes to the axis' rank
    i."""
    group, ranks = _axis(ctx, axis)
    n = len(ranks)
    if n == 1:
        return flat
    out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                      device=flat.device)
    _count("reduce_scatter", axis, _nbytes(out))
    with _traced("reduce_scatter", axis, _nbytes(out), ranks):
        dist.reduce_scatter_tensor(out, flat, group=group)
    return out


def all_gather_into(out: torch.Tensor, shard: torch.Tensor, ctx,
                    axis: str = "dp") -> torch.Tensor:
    """Every rank's 1-D `shard` written into `out` in the axis' rank
    order (out holds axis-size shards)."""
    group, ranks = _axis(ctx, axis)
    if len(ranks) == 1:
        out.copy_(shard)
        return out
    _count("all_gather", axis, _nbytes(out))
    with _traced("all_gather", axis, _nbytes(out), ranks):
        dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return out


def all_gather_cat(x: torch.Tensor, ctx, axis: str, dim: int
                   ) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in the axis' rank order; a
    bf16 tensor travels as its raw bytes."""
    group, ranks = _axis(ctx, axis)
    if len(ranks) == 1:
        return x
    x = x.contiguous()
    raw = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
    parts = [torch.empty_like(raw) for _ in ranks]
    _count("all_gather", axis, _nbytes(x) * len(ranks))
    with _traced("all_gather", axis, _nbytes(x) * len(ranks), ranks):
        dist.all_gather(parts, raw, group=group)
    if raw is not x:
        parts = [p.view(x.dtype) for p in parts]
    return torch.cat(parts, dim=dim)


def psum(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum of x over the tp ranks, in place on x (a fresh partial the
    caller owns); every rank gets the same bits."""
    return all_reduce(x, ctx, "tp")


def all_gather_heads(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """Concatenate every tp rank's x along `dim` in rank order (each rank
    holds a contiguous share of the heads)."""
    return all_gather_cat(x, ctx, "tp", dim)


def broadcast_object(obj: Any, ctx) -> Any:
    """The lead rank's obj on every rank (pickled through the group)."""
    calls["broadcast"] += 1
    box = [obj if ctx.is_lead else None]
    dist.broadcast_object_list(box, src=0, group=ctx.group)
    return box[0]


# ---- the tensor-parallel maps ----------------------------------------------

def _reduce_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    """A new tensor: x summed over tp (bf16 and fp16 in fp32)."""
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) \
        else x.clone()
    y = all_reduce(y.contiguous(), ctx, "tp")
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.mesh = ctx
        return x

    @staticmethod
    def backward(fctx, g):
        return _reduce_tp(g, fctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return _reduce_tp(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.mesh, fctx.n = ctx, x.shape[-1]
        return all_gather_cat(x, ctx, "tp", -1)

    @staticmethod
    def backward(fctx, g):
        r, n = fctx.mesh.tp_rank, fctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def copy_to_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    if ctx is None or ctx.tp == 1:
        return x
    return _CopyToTP.apply(x, ctx)


def reduce_from_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    if ctx is None or ctx.tp == 1:
        return x
    return _ReduceFromTP.apply(x, ctx)


def gather_from_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    if ctx is None or ctx.tp == 1:
        return x
    return _GatherFromTP.apply(x, ctx)
