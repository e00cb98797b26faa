"""The collectives of tensor-parallel serving, over the tp group of a
``MeshContext`` (parallel/mesh.py).

- ``all_gather_heads``: the dense path's head gather after the
  head-sharded paged attention (JAX transformer/attention.py
  ``_replicate_heads``);
- ``psum``: the all-reduce sum of the MLA path's two phases (JAX
  parallel/collectives.py ``psum`` over the tp axis);
- ``broadcast_object``: the lead rank's per-step host decisions
  (inference/dynamic_engine.py keeps the ranks in step with it).

``calls`` counts each kind a call, so tests and chip_smoke.py can count
the collectives of a step. Every collective runs under the group's
timeout (``build_mesh(timeout_s=)``): a rank that diverges fails instead
of hanging. Gloo takes CUDA tensors itself (it stages them through host
memory); a bf16 head gather travels as its raw bytes.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

calls: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def psum(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum of x over the tp ranks, in place on x (a fresh partial the
    caller owns); every rank gets the same bits."""
    calls["all_reduce"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ctx.group)
    return x


def all_gather_heads(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """Concatenate every rank's x along `dim` in rank order (each rank
    holds a contiguous share of the heads)."""
    calls["all_gather"] += 1
    x = x.contiguous()
    raw = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
    parts = [torch.empty_like(raw) for _ in range(ctx.tp)]
    dist.all_gather(parts, raw, group=ctx.group)
    if raw is not x:
        parts = [p.view(x.dtype) for p in parts]
    return torch.cat(parts, dim=dim)


def broadcast_object(obj: Any, ctx) -> Any:
    """The lead rank's obj on every rank (pickled through the group)."""
    calls["broadcast"] += 1
    box = [obj if ctx.is_lead else None]
    dist.broadcast_object_list(box, src=0, group=ctx.group)
    return box[0]
