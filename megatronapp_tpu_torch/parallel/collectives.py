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
  ``all_gather_cat`` over one axis ("tp", "dp", "pp", "embed" or
  "world").

Pipelines: ``stage_hop``, a slot's hand-off on the stage ring
(parallel/pipeline.py): this rank's send to one neighbour stage and its
receive from the other, both posted (the receive first) and waited under
the grid's timeout. The caller derives from the schedule's tables which
slots carry a hop on either side, so every send meets its receive and no
slot ships masked data. Gloo's send of a CUDA tensor fails (its TCP pair
writes the device pointer: "writev ... Bad address"; PERF.md §6 has
the probe), so a hop stages through host memory: the sender
copies its tensor to the host, the receiver copies what arrived to its
device; on the CPU the copies are the tensors themselves. A hop inside
a traced iteration records one MegaScan span pair 'pp-overlap-permute'
(B before the hop, E after it) with JAX's args: op ("pp-schedule" on
the forward, "pp-zb-bwd" on the zero-bubble backward, "pp-1f1b-bwd" on
the 1F1B backward, a timeline of its own), rank (the stage) and step
(the slot); trace/detect.py ``stage_step_gaps`` mines the gaps between
them.

MegaFBD (parallel/fbd.py): ``twin_hop``, one tensor between a rank and
its twin in the other half of the world: a forward rank's stage input
(kind "fbd") or a backward rank's updated flat params (kind
"fbd-params"), host-staged as the stage hop is, under a gloo tag of its
own a kind (the stage hops take 0 and 1), so it never matches a stage
hop between the same two processes.

Context parallelism (ops/context_parallel.py), each counted under axis
"cp" (or "cp_a2a", the inner all-to-all group of 'a2a+p2p'):

- ``ring_hop``: a ring step's exchange, this rank's tensors to one
  neighbour and the same shapes from the other, packed into one byte
  buffer each way. It is issued (``RingHop``) before the compute it
  rides under and waited after it. Like the stage hop it stages through
  host memory (gloo's CUDA send aborts), under gloo tags of its own
  (``CP_TAGS``: the K/V blocks and the backward's dK/dV accumulators),
  counted as "send/cp" and "recv/cp";
- ``all_to_all``: a tensor split along dim 0 over the group's ranks
  (Ulysses' head scatter and its inverse). A CUDA tensor stages through
  host memory: this module does not rely on gloo's all-to-all taking
  device pointers;
- ``all_gather_cat`` over "cp" (the allgather mode's K/V, the segment
  ids) and ``reduce_scatter`` over "cp" (its backward).

Expert parallelism (transformer/moe.py's all-to-all dispatch), counted
under axis "ep", each an autograd Function whose backward is JAX's
transpose:

- ``ep_all_to_all``: the bulk exchange of the [ep, ...] send buffers
  (``all_to_all`` over the ep group; its backward is the same exchange of
  the grads);
- ``EpHop``: one hop of the chunked exchange, to the ep rank `shift`
  ahead and from the one `shift` behind, issued before the compute it
  rides under and taken (``result``) after it; staged through host
  memory like the cp ring's hops (``RingHop``, gloo tags ``EP_TAGS``: the
  outbound and the return hops), counted as "send/ep" and "recv/ep". Its
  backward is the inverse permutation hop of the grads.

TP overlap (parallel/overlap.py's rings), counted under axis "tp", and
the ZeRO-1 ring param return under "dp" (or "batch"):

- ``axis_ring_hop``: one step of a ring over an axis' group, rank r
  sending to r − 1 and receiving from r + 1 (JAX's ``_ring_perm``),
  issued before the GEMM it rides under and waited after it, staged
  through host memory like the cp ring's hops (a bf16 or e4m3 payload
  travels as its bytes), under gloo tags of its own (``RING_TAGS``).

FSDP (parallel/sharding.py ``FSDP_RULES``), counted under axis "dp":

- ``fsdp_gather``: a group of leaves' shards gathered whole over the
  stage's dp group along each leaf's 'embed' dimension, in one
  all-gather (an autograd Function); its backward reduce-scatters
  (sums) the whole leaves' grads back to the shards in one call.

The "batch" axis is the dp × ep group, the ranks that split the tokens:
the router statistics' mean, the token mean of the cross entropy and the
grads of the leaves that are not experts reduce over it.

``calls`` counts each kind a call; ``traffic`` counts calls and result
bytes (JAX's HLO accounting: an all-gather's gathered output, a
reduce-scatter's shard; a hop's sent and received tensors) per
"<kind>/<axis>". A group of one rank runs
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
import datetime
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

calls: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0,
                         "reduce_scatter": 0, "send": 0, "recv": 0,
                         "all_to_all": 0}
traffic: Dict[str, Dict[str, int]] = {}

_EVENT = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "ring_hop": "collective-permute"}


def reset_counts() -> None:
    """Zero ``calls`` and empty ``traffic``."""
    calls.update(dict.fromkeys(calls, 0))
    traffic.clear()


def _axis_name(ctx, axis: str) -> str:
    """The axis a collective runs and is counted on: "batch" is "dp" at
    ep 1 (the same group)."""
    return "dp" if axis == "batch" and ctx.ep == 1 else axis


def _axis(ctx, axis: str) -> Tuple[Any, List[int]]:
    """(process group, its global ranks) of `axis` for this rank."""
    if axis == "tp":
        return ctx.group, ctx.tp_ranks
    if axis == "dp":
        return ctx.dp_group, ctx.dp_ranks
    if axis == "pp":
        return ctx.pp_group, ctx.pp_ranks
    if axis == "cp":
        return ctx.cp_group, ctx.cp_ranks
    if axis == "cp_a2a":
        return ctx.cp_a2a_group, ctx.cp_a2a_ranks
    if axis == "ep":
        return ctx.ep_group, ctx.ep_ranks
    if axis == "batch":
        return ctx.batch_group, ctx.batch_ranks
    if axis == "embed":
        return ctx.embed_group, ctx.embed_ranks
    if axis == "world":
        return ctx.world_group, ctx.world_ranks
    if axis == "fbd":
        return dist.group.WORLD, list(range(dist.get_world_size()))
    raise ValueError(f"axis {axis!r}: takes 'tp', 'dp', 'pp', 'cp', "
                     "'cp_a2a', 'ep', 'batch', 'embed', 'world' or 'fbd'")


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
    axis = _axis_name(ctx, axis)
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
    axis = _axis_name(ctx, axis)
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
    axis = _axis_name(ctx, axis)
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
    axis = _axis_name(ctx, axis)
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


PP_HOP_EVENT = "pp-overlap-permute"


def _raw(t: torch.Tensor) -> torch.Tensor:
    """t's bytes on the host (a bf16 tensor travels as its raw bytes)."""
    t = t.detach().contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.uint8)
    return t.to("cpu")


def stage_hop(ctx, send: Optional[torch.Tensor], send_to: Optional[int],
              recv_like: Optional[torch.Tensor], recv_from: Optional[int],
              *, op: str, step: int, tag: int = 0
              ) -> Optional[torch.Tensor]:
    """One slot's hand-off on the stage ring: `send` to global rank
    `send_to` and a tensor shaped like `recv_like` from `recv_from` (each
    None when this slot carries no hop on that side). Returns what was
    received, on recv_like's device (None without a receive). op and
    step: the MegaScan span's args (module docstring); tag: one per
    direction of the ring."""
    if send is None and recv_like is None:
        return None
    from megatronapp_tpu_torch.trace.tracer import get_tracer
    timeout = datetime.timedelta(seconds=ctx.timeout_s)
    with get_tracer().scope(PP_HOP_EVENT, op=op, rank=ctx.pp_rank,
                            step=int(step)):
        works, buf = [], None
        if recv_like is not None:
            buf = _raw(torch.empty_like(recv_like, device="cpu"))
            works.append(dist.irecv(buf, src=recv_from, tag=tag))
            _count("recv", "pp", _nbytes(buf))
        if send is not None:
            raw = _raw(send)
            works.append(dist.isend(raw, dst=send_to, tag=tag))
            _count("send", "pp", _nbytes(raw))
        for w in works:
            w.wait(timeout=timeout)
        if buf is None:
            return None
        if recv_like.dtype in (torch.bfloat16, torch.float16):
            buf = buf.view(recv_like.dtype)
        return buf.view(recv_like.shape).to(recv_like.device)


# The twin hops' gloo tags (stage_hop's callers take 0 and 1).
TWIN_TAGS = {"fbd": 2, "fbd-params": 3}


def twin_hop(ctx, send: Optional[torch.Tensor] = None,
             recv_into: Optional[torch.Tensor] = None, *,
             kind: str = "fbd") -> Optional[torch.Tensor]:
    """Send `send` to this rank's twin (ctx.twin_rank), or receive from
    it into `recv_into` (a tensor of the sent shape and dtype, on any
    device), which is returned; exactly one of the two is given. Counted
    as "send/<kind>" or "recv/<kind>" with the bytes moved."""
    if (send is None) == (recv_into is None):
        raise ValueError("twin_hop: give send or recv_into, not both")
    timeout = datetime.timedelta(seconds=ctx.timeout_s)
    tag = TWIN_TAGS[kind]
    if send is not None:
        raw = _raw(send)
        _count("send", kind, _nbytes(raw))
        dist.isend(raw, dst=ctx.twin_rank, tag=tag).wait(timeout=timeout)
        return None
    buf = _raw(torch.empty(recv_into.shape, dtype=recv_into.dtype))
    _count("recv", kind, _nbytes(buf))
    dist.irecv(buf, src=ctx.twin_rank, tag=tag).wait(timeout=timeout)
    if recv_into.dtype in (torch.bfloat16, torch.float16):
        buf = buf.view(recv_into.dtype)
    recv_into.copy_(buf.view(recv_into.shape))
    return recv_into


def all_to_all(x: torch.Tensor, ctx, axis: str = "cp") -> torch.Tensor:
    """x [n, ...] (n: the axis' ranks): chunk j goes to the axis' rank j;
    returns [n, ...] whose chunk i came from rank i. A CUDA tensor stages
    through host memory; a bf16 one travels as its raw bytes."""
    axis = _axis_name(ctx, axis)
    group, ranks = _axis(ctx, axis)
    if len(ranks) == 1:
        return x
    if x.shape[0] != len(ranks):
        raise ValueError(f"all_to_all over {axis}: dim 0 is {x.shape[0]}, "
                         f"the group has {len(ranks)} ranks")
    raw = _raw(x)
    out = torch.empty_like(raw)
    _count("all_to_all", axis, _nbytes(out))
    with _traced("all_to_all", axis, _nbytes(out), ranks):
        dist.all_to_all_single(out, raw, group=group)
    if x.dtype in (torch.bfloat16, torch.float16):
        out = out.view(x.dtype)
    return out.view(x.shape).to(x.device)


# The cp ring's gloo tags: the K/V blocks (and their segment ids) and the
# backward's dK/dV accumulators (the stage hops take 0 and 1, the twin
# hops 2 and 3).
CP_TAGS = {"kv": 4, "dkv": 5}


class RingHop:
    """One ring step's exchange in flight (``ring_hop``, ``EpHop``):
    ``wait()`` returns the received tensors, shaped and typed like the
    sent ones, on their device. Counted under `axis`."""

    def __init__(self, ctx, tensors: List[torch.Tensor], dst: int,
                 src: int, ranks: List[int], tag: int, axis: str = "cp"):
        self.ctx = ctx
        self.like = [(t.shape, t.dtype, t.device) for t in tensors]
        parts = [t.detach().contiguous().reshape(-1).view(torch.uint8)
                 for t in tensors]
        self.sizes = [p.numel() for p in parts]
        send = torch.cat(parts).to("cpu")
        self.buf = torch.empty_like(send)
        n = _nbytes(send)
        _count("send", axis, n)
        _count("recv", axis, n)
        self._event = contextlib.ExitStack()
        self._event.enter_context(_traced("ring_hop", axis, n, ranks))
        self.works = [dist.irecv(self.buf, src=src, tag=tag),
                      dist.isend(send, dst=dst, tag=tag)]

    def wait(self) -> List[torch.Tensor]:
        timeout = datetime.timedelta(seconds=self.ctx.timeout_s)
        for w in self.works:
            w.wait(timeout=timeout)
        self._event.close()
        dev = self.like[0][2]
        buf = self.buf.to(dev)
        out, a = [], 0
        for (shape, dtype, _), n in zip(self.like, self.sizes):
            out.append(buf[a:a + n].clone().view(dtype).view(shape))
            a += n
        return out


def ring_hop(ctx, tensors: List[torch.Tensor], dst: int, src: int,
             ranks: List[int], tag: str = "kv") -> RingHop:
    """Issue a ring step's exchange: `tensors` to global rank dst, the
    same shapes from src (``ranks``: the ring, for the MegaScan event).
    Every rank of the ring issues it in the same step."""
    return RingHop(ctx, tensors, dst, src, ranks, CP_TAGS[tag])


# The TP overlap rings' and the ZeRO-1 ring's gloo tags (each ring's
# hops are waited one at a time, so one tag a ring suffices).
RING_TAGS = {"tp": 8, "dp": 9, "batch": 9}


def axis_ring_hop(ctx, tensors: List[torch.Tensor], axis: str) -> RingHop:
    """Issue one ring step over `axis`: `tensors` to the axis' rank r − 1,
    the same shapes from rank r + 1 (every rank of the axis issues it in
    the same step). Counted as "send/<axis>" and "recv/<axis>"."""
    axis = _axis_name(ctx, axis)
    _, ranks = _axis(ctx, axis)
    n = len(ranks)
    me = ranks.index(ctx.rank)
    return RingHop(ctx, tensors, ranks[(me - 1) % n], ranks[(me + 1) % n],
                   ranks, RING_TAGS[axis], axis=axis)


# The ep hops' gloo tags: the outbound hops and the return hops (either
# may be in flight beside the other; each hop's backward reuses its tag
# once the forward's hops are done).
EP_TAGS = {"out": 6, "ret": 7}


def _ep_ring_hop(ctx, x: torch.Tensor, shift: int, kind: str) -> RingHop:
    ranks, me = ctx.ep_ranks, ctx.ep_rank
    n = len(ranks)
    return RingHop(ctx, [x], ranks[(me + shift) % n], ranks[(me - shift) % n],
                   ranks, EP_TAGS[kind], axis="ep")


class _EpHopFn(torch.autograd.Function):
    """The received side of an issued ep hop, linked to the sent tensor:
    its backward sends the grad back where the tensor came from and
    receives the sent tensor's grad from where it went."""

    @staticmethod
    def forward(fctx, x, hop):
        fctx.mesh, fctx.shift, fctx.kind = hop.ctx, hop.shift, hop.kind
        return hop.wait()

    @staticmethod
    def backward(fctx, g):
        back = _ep_ring_hop(fctx.mesh, g.contiguous(), -fctx.shift,
                            fctx.kind).wait()[0]
        return back, None


class EpHop:
    """One hop of the ep group, issued when made: x to the ep rank `shift`
    ahead, a tensor of x's shape from the one `shift` behind (kind "out"
    or "ret": the gloo tag; on_wait: called when it arrives). Every ep
    rank issues it in the same step. ``result()`` waits for it and returns
    what arrived, differentiable with respect to what was sent."""

    def __init__(self, ctx, x: torch.Tensor, shift: int, kind: str,
                 on_wait=None):
        self.ctx, self.x, self.shift, self.kind = ctx, x, shift, kind
        self.on_wait = on_wait
        self._hop = _ep_ring_hop(ctx, x, shift, kind)

    def wait(self) -> torch.Tensor:
        out = self._hop.wait()[0]
        if self.on_wait is not None:
            self.on_wait()
        return out

    def result(self) -> torch.Tensor:
        return _EpHopFn.apply(self.x, self)


class _EpAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.mesh = ctx
        return all_to_all(x, ctx, "ep")

    @staticmethod
    def backward(fctx, g):
        return all_to_all(g.contiguous(), fctx.mesh, "ep"), None


def ep_all_to_all(x: torch.Tensor, ctx) -> torch.Tensor:
    """x [ep, ...]: chunk j to ep rank j; returns chunk i from ep rank i
    (differentiable: the backward exchanges the grads the same way)."""
    return _EpAllToAll.apply(x.contiguous(), ctx)


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


# ---- FSDP -------------------------------------------------------------------

class _FsdpGather(torch.autograd.Function):
    """Whole leaves from this rank's shards (one all-gather over dp of the
    shards flattened together); the backward reduce-scatters the whole
    leaves' grads (fp32 sums) back to the shards in one call."""

    @staticmethod
    def forward(fctx, ctx, dims, *shards):
        fctx.mesh, fctx.dims = ctx, dims
        fctx.shapes = [s.shape for s in shards]
        dp = ctx.dp
        flat = torch.cat([s.reshape(-1) for s in shards])
        every = all_gather_into(
            torch.empty(dp * flat.numel(), dtype=flat.dtype,
                        device=flat.device), flat, ctx, "dp").view(dp, -1)
        sizes = [s.numel() for s in shards]
        per_rank = [list(every[r].split(sizes)) for r in range(dp)]
        return tuple(torch.cat([per_rank[r][j].view(fctx.shapes[j])
                                for r in range(dp)], dim=d)
                     for j, d in enumerate(dims))

    @staticmethod
    def backward(fctx, *grads):
        ctx, dp = fctx.mesh, fctx.mesh.dp
        parts = []
        for r in range(dp):
            for g, shape, d in zip(grads, fctx.shapes, fctx.dims):
                k = shape[d]
                parts.append(g.narrow(d, r * k, k).float().reshape(-1))
        mine = reduce_scatter(torch.cat(parts), ctx, "dp")
        out = [m.view(shape) for m, shape in zip(
            mine.split([s.numel() for s in fctx.shapes]), fctx.shapes)]
        return (None, None, *out)


def fsdp_gather(shards: List[torch.Tensor], dims: List[int], ctx
                ) -> List[torch.Tensor]:
    """The whole leaves of fp32 `shards` (leaf j split over the dp ranks
    along dims[j], rank order), differentiable: the grads return to the
    shards summed over dp (module docstring)."""
    if not shards:
        return []
    return list(_FsdpGather.apply(ctx, tuple(dims), *shards))
