"""The pipeline executor: the port's counterpart of the JAX package's
parallel/pipeline.py ``spmd_pipeline``, as the per-rank (MPMD) runtime
that parallel/schedule.py describes.

JAX runs the whole pipeline as one program over the pp axis: a scan over
clocked instruction tables, one ring ``ppermute`` a slot, and the
backward as the scan's transpose (or, for zero-bubble, a hand-written
B/W scan). The port is one process a rank, so every rank executes the
same validated tables for its own stage (``validate_programs`` runs
before any table does):

- **forward** (``forward_tables``; '1f1b' / 'vpp', interleaved when
  vpp > 1): at slot t the stage runs its instruction F(m, c): stage 0's
  chunk 0 takes microbatch m's injected input (``inject``), every other
  F takes what its producer sent one slot earlier (the previous stage,
  or the last stage's chunk c - 1 for stage 0's chunk c). Then the slot's
  hop: each stage sends its output to the next stage unless it is the
  last chunk of the last stage (whose outputs are collected for the
  head), and receives when its previous stage sends.
- **1F1B / VPP backward**: the reverse of the forward program, slot by
  slot (JAX's scan transpose): each F's output cotangent (the head's, or
  what the consumer stage sent one reverse slot earlier) runs autograd
  back through that F's graph, and the input's cotangent hops to the
  producer stage. The residuals are each F's graph under the layers'
  remat policy, as JAX's scan saves each step's residuals.
- **zero-bubble** (``zb_backward_tables``): the forward runs without
  graphs and keeps each F's input; a B slot recomputes the chunk from
  it and pulls the activation cotangent only (``torch.autograd.grad`` on
  the input), sends it down the reverse ring and keeps the output
  cotangent; a W slot recomputes the chunk and pulls the weight
  cotangent only (the input takes no grad). Every W lies inside the
  program, so every wgrad is done before the optimizer runs.
- **order policy** 'bfc' (breadth-first chunks): vpp sequential passes
  of the single-chunk program, the last stage's outputs of pass c handed
  to stage 0 as pass c + 1's inputs (and their cotangents back) — JAX's
  ``spmd_pipeline`` loop at vpp > 1 with order_policy 'bfc'.

MegaFBD (parallel/fbd.py) hooks in through ``TwinLink``: a forward
rank's pass runs without grad and ships every stage input it consumes to
its twin (stage 0's chunk-0 inputs excepted: the twin embeds the same
rows itself); a backward rank's pass runs no forward program and no
forward hop, takes each of those inputs from its twin instead, and its
backward program (the 1F1B one, in reverse slot order) recomputes each
F from its input with grad just before the F's backward, the last
stage's last chunk together with the head and loss (``head_one``), so
it holds one F's graph at a time. Without a TwinLink nothing changes.

Under context parallelism every rank of a stage holds its cp share of
each microbatch, so a hop carries [mb, S/cp, H]; the ring attention's
collectives run inside F and in zero-bubble's B and W recomputes, and the
cp ranks of a stage execute the same tables, so they meet in the same
order.

JAX's checks carry over: a known schedule, 'vpp' only at vpp > 1,
M % pp == 0 for the interleaved 'dfc' program, and no per-microbatch
aux inputs (packed sequences) under zero-bubble. Every hop is
parallel/collectives.py ``stage_hop`` (host-staged, counted, one
MegaScan span pair); both sides derive from the tables which slots carry
one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from megatronapp_tpu_torch.parallel import schedule as schedlib
from megatronapp_tpu_torch.parallel.collectives import stage_hop, twin_hop

# MegaScan span ops of the hops (trace/detect.py stage_step_gaps keys a
# timeline by op): the forward's and the zero-bubble backward's are
# JAX's; the 1F1B backward, which JAX's traces cannot show, has its own.
OP_FORWARD, OP_ZB_BACKWARD, OP_1F1B_BACKWARD = (
    "pp-schedule", "pp-zb-bwd", "pp-1f1b-bwd")
# One gloo tag a direction of the ring.
_TAG_FORWARD, _TAG_BACKWARD = 0, 1


def check_schedule(pp: int, num_micro: int, vpp: int, schedule: str,
                   order_policy: str, packed: bool) -> None:
    """JAX spmd_pipeline's checks (parallel/pipeline.py:197-218)."""
    if order_policy not in ("dfc", "bfc"):
        raise ValueError(f"order_policy must be 'dfc' or 'bfc', got "
                         f"{order_policy!r}")
    if schedule not in schedlib.SCHEDULES:
        raise ValueError(f"schedule must be one of {schedlib.SCHEDULES}, "
                         f"got {schedule!r}")
    if schedule == "vpp" and vpp <= 1:
        raise ValueError("schedule 'vpp' requires vpp > 1 (it is the "
                         "interleaved schedule; plain 1F1B is '1f1b')")
    if schedule == "zero-bubble" and packed:
        raise NotImplementedError(
            "zero-bubble does not compose with per-microbatch aux "
            "inputs (packed sequences) yet — run --pp-schedule 1f1b "
            "there")
    if vpp > 1 and order_policy == "dfc" and num_micro % pp != 0:
        raise ValueError(
            f"interleaved (dfc) pipeline requires num_microbatches "
            f"({num_micro}) divisible by pipeline_parallel ({pp}); 'bfc' "
            f"has no such constraint")


@dataclasses.dataclass
class StageProgram:
    """What one stage runs: chunk_fn(c, m, x) -> y runs chunk c of this
    stage on microbatch m's input x; on stage 0, inject(m) is microbatch
    m's input (compute dtype) and inject_backward({m: dx}) takes the
    inputs' cotangents; like is a tensor of a hop's shape, dtype and
    device; on the last stage head(outs, grad) turns the collected
    outputs {m: y} into (loss, {m: d loss / d y}) (cotangents only when
    grad), and head_one(m, y) is microbatch m's share of that loss, with
    its graph (MegaFBD's backward ranks)."""
    chunk_fn: Callable[[int, int, torch.Tensor], torch.Tensor]
    inject: Optional[Callable[[int], torch.Tensor]]
    inject_backward: Optional[Callable[[Dict[int, torch.Tensor]], None]]
    like: torch.Tensor
    head: Callable
    head_one: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None


@dataclasses.dataclass
class TwinLink:
    """A MegaFBD rank's link to its twin (module docstring): role
    "forward" ships stage inputs, role "backward" takes them, in the
    forward table's order on both sides (parallel/collectives.py
    ``twin_hop``)."""
    ctx: object
    role: str

    def ship(self, x: torch.Tensor) -> None:
        twin_hop(self.ctx, send=x, kind="fbd")

    def take(self, like: torch.Tensor) -> torch.Tensor:
        return twin_hop(self.ctx, recv_into=torch.empty_like(like),
                        kind="fbd")


class _Pass:
    """One run of the instruction program: every chunk at once ('dfc'),
    or chunk `chunk` alone (a 'bfc' pass, vpp 1). inputs: stage 0's
    chunk-0 inputs {m: x}; outs: the last stage's last-chunk outputs."""

    def __init__(self, ctx, prog: StageProgram, num_micro: int, vpp: int,
                 chunk: Optional[int], zero_bubble: bool,
                 fbd: Optional[TwinLink] = None):
        self.ctx, self.prog, self.M, self.vpp = ctx, prog, num_micro, vpp
        self.chunk = chunk
        self.zb = zero_bubble
        self.fbd = fbd
        # Its last stage's last chunk feeds the head (not the next pass).
        self.final = chunk is None or chunk == ctx.vpp - 1
        # MegaFBD backward: the head's per-microbatch losses {m: loss}.
        self.losses: Dict[int, torch.Tensor] = {}
        self.fwd = schedlib.forward_tables(ctx.pp, num_micro, vpp)
        self.bwd = (schedlib.zb_backward_tables(ctx.pp, num_micro, vpp)
                    if zero_bubble else None)
        schedlib.validate_programs(ctx.pp, num_micro, vpp, self.fwd,
                                   self.bwd)
        self.saved: Dict[Tuple[int, int], tuple] = {}
        self.outs: Dict[int, torch.Tensor] = {}
        self.d_inputs: Dict[int, torch.Tensor] = {}

    def _global_chunk(self, c: int) -> int:
        return c if self.chunk is None else self.chunk

    def _own_input(self, s: int, c: int) -> bool:
        """F(·, c) on stage s takes an injected input, not a hop's (stage
        0's chunk 0 of the whole model)."""
        return s == 0 and self._global_chunk(c) == 0

    def _sends_forward(self, t: int, s: int) -> bool:
        """Stage s's F at slot t hands its output on (to the next stage,
        or the last stage's chunk c to stage 0's chunk c + 1)."""
        active, _, ck = self.fwd
        return bool(active[t, s]) and not (
            s == self.ctx.pp - 1 and ck[t, s] == self.vpp - 1)

    def _sends_backward(self, t: int, s: int, b_slot: bool) -> bool:
        """Stage s's backward instruction at slot t hands an input
        cotangent back (every one but stage 0's chunk 0)."""
        ck = self.bwd[2] if self.zb else self.fwd[2]
        return b_slot and not (s == 0 and ck[t, s] == 0)

    # -- forward -----------------------------------------------------------
    def forward(self, inputs: Dict[int, torch.Tensor], grad: bool) -> None:
        ctx, pp, s = self.ctx, self.ctx.pp, self.ctx.pp_rank
        active, mbt, ckt = self.fwd
        if self.fbd is not None and self.fbd.role == "backward":
            self._take_from_twin(inputs)
            return
        ship = self.fbd is not None and self.fbd.role == "forward"
        state = None
        keep_graph = grad and not self.zb
        for t in range(active.shape[0]):
            y = None
            if active[t, s]:
                m, c = int(mbt[t, s]), int(ckt[t, s])
                x = inputs[m] if (s == 0 and c == 0) else state
                if ship and not self._own_input(s, c):
                    self.fbd.ship(x)
                if keep_graph:
                    x = x.detach().requires_grad_()
                    y = self.prog.chunk_fn(self._global_chunk(c), m, x)
                    self.saved[(m, c)] = (x, y)
                else:
                    with torch.no_grad():
                        y = self.prog.chunk_fn(self._global_chunk(c), m, x)
                    if grad:
                        self.saved[(m, c)] = (x,)
                if s == pp - 1 and c == self.vpp - 1:
                    self.outs[m] = y
            sp = (s - 1) % pp
            state = stage_hop(
                ctx, y.detach() if self._sends_forward(t, s) else None,
                ctx.next_rank, self.prog.like if
                self._sends_forward(t, sp) else None, ctx.prev_rank,
                op=OP_FORWARD, step=t, tag=_TAG_FORWARD)

    def _take_from_twin(self, inputs: Dict[int, torch.Tensor]) -> None:
        """MegaFBD backward: every F's input, from the twin (in the
        forward table's order, as the twin ships them) or injected; no
        compute and no hop."""
        s = self.ctx.pp_rank
        active, mbt, ckt = self.fwd
        for t in range(active.shape[0]):
            if active[t, s]:
                m, c = int(mbt[t, s]), int(ckt[t, s])
                x = (inputs[m] if self._own_input(s, c)
                     else self.fbd.take(self.prog.like))
                self.saved[(m, c)] = (x,)

    # -- backward ----------------------------------------------------------
    def backward(self, d_outs: Dict[int, torch.Tensor]) -> None:
        """d_outs: the last stage's output cotangents {m: dy}; fills
        d_inputs (stage 0's chunk-0 input cotangents)."""
        if self.zb:
            self._backward_zb(d_outs)
        else:
            self._backward_1f1b(d_outs)

    def _backward_1f1b(self, d_outs) -> None:
        ctx, pp, s = self.ctx, self.ctx.pp, self.ctx.pp_rank
        active, mbt, ckt = self.fwd
        state = None
        for t in reversed(range(active.shape[0])):
            dx = None
            if active[t, s]:
                m, c = int(mbt[t, s]), int(ckt[t, s])
                dy = (d_outs.get(m) if (s == pp - 1 and c == self.vpp - 1)
                      else state)
                if self.fbd is not None:
                    x, y = self._recompute(m, c, dy)
                else:
                    x, y = self.saved.pop((m, c))
                    torch.autograd.backward(y, dy)
                del y
                dx = x.grad
                if s == 0 and c == 0:
                    self.d_inputs[m] = dx
            sn = (s + 1) % pp
            state = stage_hop(
                ctx, dx if self._sends_backward(t, s, bool(active[t, s]))
                else None, ctx.prev_rank,
                self.prog.like if self._sends_backward(
                    t, sn, bool(active[t, sn])) else None, ctx.next_rank,
                op=OP_1F1B_BACKWARD, step=t, tag=_TAG_BACKWARD)

    def _recompute(self, m: int, c: int, dy) -> tuple:
        """MegaFBD backward: F(m, c) again from its input with grad, and
        its backward (from the head's loss on the last stage's last
        chunk of the final pass, else from dy). Returns (input, output)."""
        (x,) = self.saved.pop((m, c))
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            y = self.prog.chunk_fn(self._global_chunk(c), m, x)
            if self.ctx.is_last_stage and c == self.vpp - 1 and self.final:
                loss_m = self.prog.head_one(m, y)
                self.losses[m] = loss_m.detach()
                loss_m.backward()
            else:
                torch.autograd.backward(y, dy)
        return x, y

    def _backward_zb(self, d_outs) -> None:
        ctx, pp, s = self.ctx, self.ctx.pp, self.ctx.pp_rank
        kind, bmb, bck = self.bwd
        state = None
        dy_buf: Dict[Tuple[int, int], torch.Tensor] = {}
        for t in range(kind.shape[0]):
            k = int(kind[t, s])
            m, c = int(bmb[t, s]), int(bck[t, s])
            dx = None
            if k == schedlib.KIND_B:
                dy = (d_outs[m] if (s == pp - 1 and c == self.vpp - 1)
                      else state)
                (x,) = self.saved[(m, c)]
                x_ = x.detach().requires_grad_()
                with torch.enable_grad():
                    y = self.prog.chunk_fn(self._global_chunk(c), m, x_)
                (dx,) = torch.autograd.grad(y, x_, dy)
                del y
                dy_buf[(m, c)] = dy
                if s == 0 and c == 0:
                    self.d_inputs[m] = dx
            elif k == schedlib.KIND_W:
                (x,) = self.saved.pop((m, c))
                with torch.enable_grad():
                    y = self.prog.chunk_fn(self._global_chunk(c), m,
                                           x.detach())
                torch.autograd.backward(y, dy_buf.pop((m, c)))
                del y
            sn = (s + 1) % pp
            state = stage_hop(
                ctx, dx if self._sends_backward(
                    t, s, k == schedlib.KIND_B) else None, ctx.prev_rank,
                self.prog.like if self._sends_backward(
                    t, sn, int(kind[t, sn]) == schedlib.KIND_B) else None,
                ctx.next_rank, op=OP_ZB_BACKWARD, step=t,
                tag=_TAG_BACKWARD)


def _hand_over(ctx, tensors: Dict[int, torch.Tensor], num_micro: int,
               like: torch.Tensor, from_last: bool, op: str, tag: int
               ) -> Dict[int, torch.Tensor]:
    """A 'bfc' pass boundary: the last stage's M outputs to stage 0
    (from_last) or stage 0's M input cotangents back to the last stage,
    one hop a microbatch. Returns what this rank received."""
    s, last = ctx.pp_rank, ctx.pp - 1
    src, dst = (last, 0) if from_last else (0, last)
    got = {}
    for m in range(num_micro):
        r = stage_hop(ctx, tensors[m] if s == src else None,
                      ctx.pp_ranks[dst], like if s == dst else None,
                      ctx.pp_ranks[src], op=op, step=m, tag=tag)
        if r is not None:
            got[m] = r
    return got


def run_pipeline(ctx, prog: StageProgram, num_micro: int, *,
                 schedule: str = "1f1b", order_policy: str = "dfc",
                 grad: bool = True, packed: bool = False,
                 fbd: Optional[TwinLink] = None
                 ) -> Optional[torch.Tensor]:
    """Run the stage's program: the forward, the head on the last stage,
    then (grad) the backward, ending with stage 0's inject_backward.
    Returns the head's loss on the last stage, None elsewhere. MegaScan
    spans: 'forward' (the forward program), 'loss' (the head),
    'backward' (the backward program). fbd: this rank's MegaFBD link
    (module docstring); its forward role runs without grad, its backward
    role with it, under the 1F1B program only."""
    from megatronapp_tpu_torch.trace.tracer import get_tracer
    tracer = get_tracer()
    vpp, pp = ctx.vpp, ctx.pp
    check_schedule(pp, num_micro, vpp, schedule, order_policy, packed)
    zb = schedule == "zero-bubble"
    taking = fbd is not None and fbd.role == "backward"
    if fbd is not None and (zb or grad != taking):
        raise ValueError("MegaFBD runs the 1F1B program: its forward "
                         "ranks without grad, its backward ranks with it")
    if vpp > 1 and order_policy == "bfc":
        passes = [_Pass(ctx, prog, num_micro, 1, c, zb, fbd)
                  for c in range(vpp)]
    else:
        passes = [_Pass(ctx, prog, num_micro, vpp, None, zb, fbd)]
    with tracer.scope("forward"):
        inputs = ({m: prog.inject(m) for m in range(num_micro)}
                  if ctx.is_first_stage else {})
        for i, ps in enumerate(passes):
            if i and not taking:
                inputs = _hand_over(ctx, passes[i - 1].outs, num_micro,
                                    prog.like, True, OP_FORWARD,
                                    _TAG_FORWARD)
            ps.forward(inputs, grad)
    loss = None
    d_outs: Dict[int, torch.Tensor] = {}
    with tracer.scope("loss"):
        if ctx.is_last_stage and not taking:
            loss, d_outs = prog.head(passes[-1].outs, grad)
    if not grad:
        return loss
    with tracer.scope("backward"):
        op = OP_ZB_BACKWARD if zb else OP_1F1B_BACKWARD
        for i in reversed(range(len(passes))):
            if i < len(passes) - 1:
                d_outs = _hand_over(ctx, passes[i + 1].d_inputs, num_micro,
                                    prog.like, False, op, _TAG_BACKWARD)
            passes[i].backward(d_outs)
        if ctx.is_first_stage:
            prog.inject_backward(passes[0].d_inputs)
    if taking and ctx.is_last_stage:
        losses = passes[-1].losses
        loss = losses[0]
        for m in range(1, num_micro):
            loss = loss + losses[m]
    return loss
