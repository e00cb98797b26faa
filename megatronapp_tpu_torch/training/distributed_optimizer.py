"""The optimizer of a rank grid, with ZeRO-1: the port's counterpart of
the JAX package's training/distributed_optimizer.py
``DistributedOptimizer``.

JAX keeps the same arithmetic as its replicated chain and lets the state
layout carry the sharding: Adam's m and v are dp-sharded, grads reach the
update dp-reduced and the updated params return by all-gather. The port
does the same explicitly, on flat fp32 buffers (``FlatLayout``):

- every trainable param of this rank (its tp shards,
  parallel/sharding.py) lives in one flat buffer, and its ``.grad`` in
  another: autograd accumulates the microbatches' gradients in place
  there;
- ``reduce_grads`` scales them by 1/num_micro, sums the grads of the
  replicated leaves that only see their heads' share over tp
  (``TP_PARTIAL_GRAD_LEAVES``), then sums over dp: a reduce-scatter under
  ZeRO-1, which leaves this rank its 1/dp chunk, an all-reduce without;
- under cp the ranks of a cp group hold the same params, each with the
  grads of its share of the sequence: the grads are summed over cp
  (an all-reduce) before the dp reduction, and ZeRO-1 stays sharded over
  dp alone (JAX distributed_optimizer.py:134); the norm's replicated
  squares then count once per (cp, tp) group and its sharded ones once
  per cp group;
- under pp, ZeRO-1 runs within each stage's dp group (every stage has
  buffers of its own); a tied word embedding's two copies (stage 0's and
  the last stage's) have their grads summed over the embedding group
  before the dp reduction, so both apply the same update and stay
  bitwise equal;
- under expert parallelism (ep > 1) the expert stacks live in a second
  pair of flat buffers: the leaves that are not experts reduce their
  grads over the dp × ep "batch" group and ZeRO-1 shards them over it,
  the expert stacks (each ep rank its own experts, whose grads already
  hold every token's, brought home by the all-to-all's backward) reduce
  and shard over dp alone (JAX distributed_optimizer.py:118-140); the
  norm counts each expert element once over dp and ep;
- ``norm_partials`` gives this rank's chunk's sums of squares, split
  into the tp-sharded leaves (summed over every rank) and the rest
  (counted once, from tp rank 0), the last stage's copy of a tied
  embedding left out: the train step all-gathers them over the world
  (every stage) and sums them in rank order, so the model-wide norm has
  the same bits with and without ZeRO-1;
- ``step`` clips and applies ``Optimizer.update_leaf`` (the chain of
  training/optimizer.py, leaf for leaf) to each leaf's slice of the
  chunk, with m and v held for the chunk only; the updated chunk returns
  to every dp rank by all-gather. Without ZeRO-1 every rank updates the
  whole buffer with whole moments.

- ``dist_opt_comm`` (JAX's --dist-opt-comm) picks how ZeRO-1's updated
  chunk returns to every rank of its axis: "gspmd" and "bulk" (JAX's
  tiled gather; both the one all-gather into the flat buffer) or "ring"
  (parallel/overlap.py ``ring_all_gather``: axis − 1 hops
  through host memory with 'dp-overlap-permute' spans). The three move
  the same bits;
- FSDP (``ctx.parallel.fsdp``, parallel/sharding.py): the flat buffers
  hold this rank's shards (each 'embed'-axis leaf's 1/dp slice), m and v
  are theirs, and ZeRO-1 is off (FSDP already splits over dp; JAX
  train.py:318-323). The sharded leaves skip the dp reduction: their
  grads arrive summed over dp by the gather's reduce-scatter
  (parallel/collectives.py ``fsdp_gather``); the leaves without an
  'embed' axis are all-reduced over dp as before. The layout puts the
  sharded leaves first, so the whole ones are one range;
  ``norm_partials`` counts a sharded element on every dp rank and a
  whole one in this rank's dp chunk only, so their sum over the world
  counts each once. The checkpoints gather and scatter the shards over
  dp, so they stay layout-independent;

exp_avg_dtype / exp_avg_sq_dtype bf16 store the moments in bf16 with the
update math in fp32 (JAX ``resolve_state_dtype``). Params stay fp32 (a
master copy for bf16 params is ROADMAP.md Queue 1 item 3).

``full_state_dict`` / ``load_full_state_dict`` carry the state to and
from the layout-independent form of the checkpoints: every leaf whole
(params gathered over tp and ep, moments over dp (or dp × ep), tp and
ep, and under pp every stage's leaves brought together,
parallel/sharding.py gather_stages)
under the one-device leaf paths of training/train_state.py, so a
checkpoint written on one grid resumes on another; an fp8 state
(replicated on every rank) rides along under its ``fp8/...`` paths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from megatronapp_tpu_torch.config.training_config import OptimizerConfig
from megatronapp_tpu_torch.parallel import collectives
from megatronapp_tpu_torch.parallel.sharding import (
    TP_PARTIAL_GRAD_LEAVES, ep_dim, ep_shard, fsdp_dim, fsdp_on, fsdp_shard,
    gather_leaf, leaf_name, segment_counts, shard_leaf, tp_dim,
)
from megatronapp_tpu_torch.training.optimizer import Optimizer, decays


class FlatLayout:
    """Where each trainable param of this rank lives in the flat buffers:
    the tp-sharded leaves first, then the tp-partial ones, then the
    replicated ones, then `copies` (leaves another stage also holds and
    counts in the norm: a tied embedding's last-stage copy), each group
    in name order, padded to a multiple of the ZeRO-1 axis' size (dp, or
    the dp × ep "batch" group: `axis`). Under FSDP the leaves split over
    dp come first (each in those groups), then the whole ones
    (``fsdp_end``: where they start; ``runs``: the (start, end, group,
    split over dp) ranges). ``params``/``grads``: the flat buffers; each
    param's data is a view of ``params`` (grads=False: no grad buffer,
    for a MegaFBD forward rank, which takes no grads)."""

    def __init__(self, named_params: Dict[str, torch.Tensor], ctx,
                 copies=frozenset(), grads: bool = True, axis: str = "dp"):
        def group(n):
            if n in copies:
                return 3
            if ctx.tp > 1 and tp_dim(n) is not None:
                return 0
            return 1 if leaf_name(n) in TP_PARTIAL_GRAD_LEAVES else 2

        split = {n for n in named_params
                 if fsdp_on(ctx) and fsdp_dim(n) is not None}
        self.fsdp = bool(split)
        order = [n for _, _, _, n in sorted(
            (0 if n in split else 1, group(n), i, n)
            for i, n in enumerate(named_params))]
        self.slots: List[Tuple[str, int, int]] = []
        off = 0
        for n in order:
            self.slots.append((n, off, off + named_params[n].numel()))
            off += named_params[n].numel()
        self.offsets = {n: (a, b) for n, a, b in self.slots}
        self.numel = off
        self.axis = axis
        shards, rank = ((ctx.dp, ctx.dp_rank) if axis == "dp"
                        else (ctx.batch, ctx.batch_rank))
        self.shards = shards
        self.padded = -(-off // shards) * shards
        ends = [sum(b - a for n, a, b in self.slots if group(n) <= g)
                for g in (0, 1, 2)]
        # [0, sharded_end): tp-sharded; partial: summed over tp in
        # reduce_grads; [sharded_end, counted_end): counted once in the
        # norm; [counted_end, numel): copies, not counted (without
        # FSDP; under it the same groups are the runs' ranges).
        self.sharded_end = ends[0]
        self.partial = (ends[0], ends[1])
        self.counted_end = ends[2]
        self.runs: List[Tuple[int, int, int, bool]] = []
        for n, a, b in self.slots:
            key = (group(n), n in split)
            if self.runs and self.runs[-1][2:] == key:
                self.runs[-1] = (self.runs[-1][0], b) + key
            else:
                self.runs.append((a, b) + key)
        self.fsdp_end = sum(b - a for n, a, b in self.slots if n in split)
        if self.fsdp:
            partial = [(a, b) for a, b, g, _ in self.runs if g == 1]
            self.partial = partial[0] if partial else (0, 0)
        first = next(iter(named_params.values()))
        self.params = torch.zeros(self.padded, dtype=torch.float32,
                                  device=first.device)
        self.grads = torch.zeros_like(self.params) if grads else None
        with torch.no_grad():
            for n, a, b in self.slots:
                p = named_params[n]
                self.params[a:b].copy_(p.reshape(-1))
                p.data = self.params[a:b].view(p.shape)
        self.named = named_params
        chunk = self.padded // shards
        self.chunk = (rank * chunk, (rank + 1) * chunk)

    def view(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        """Leaf `name`'s view of a whole flat buffer."""
        a, b = self.offsets[name]
        return flat[a:b].view(self.named[name].shape)


def layout_copies(ctx, tied_embedding: bool) -> frozenset:
    """The leaves of this rank's FlatLayout that another stage also holds
    (a tied word embedding's last-stage copy under pp)."""
    return frozenset({"embedding.word"} if tied_embedding and ctx.pp > 1
                     and not ctx.is_first_stage else ())


class _Part:
    """One pair of flat buffers and its moments: the layout, the state
    keys of its moments, whether ZeRO-1 shards it over its axis, and the
    step's reduced grads (g)."""

    def __init__(self, layout: FlatLayout, suffix: str, zero1: bool):
        self.layout, self.suffix, self.zero1 = layout, suffix, zero1
        self.g: Optional[torch.Tensor] = None

    @property
    def span(self) -> Tuple[int, int]:
        """The flat range this rank updates and keeps moments for."""
        return self.layout.chunk if self.zero1 else (0, self.layout.padded)


# The state keys of the moments of the expert stacks' buffers (ep > 1).
EXPERT_SUFFIX = "@experts"


class DistributedOptimizer(Optimizer):
    """The chain of training/optimizer.py over a grid's flat buffers.
    ZeRO-1 (the ctx's distributed_optimizer, at dp > 1, or dp × ep > 1):
    m and v for this rank's chunk only. State: {"count": int, "mu":
    tensor, "nu": tensor} (flat: the chunk's, or the whole buffer's), and
    at ep > 1 "mu@experts" / "nu@experts" of the expert stacks' buffers.
    tied_embedding: the output layer is the word embedding (under pp its
    two stages' copies sum their grads)."""

    def __init__(self, cfg: OptimizerConfig, train_iters: int, ctx,
                 tied_embedding: bool = False):
        super().__init__(cfg, train_iters)
        self.ctx = ctx
        # FSDP already splits over dp: ZeRO-1 is off under it (JAX
        # train.py:318-323).
        self.zero1 = (ctx.parallel.distributed_optimizer and ctx.batch > 1
                      and not ctx.parallel.fsdp)
        self.tied_pp = tied_embedding and ctx.pp > 1
        self.layout: Optional[FlatLayout] = None
        self.parts: List[_Part] = []

    # -- buffers -------------------------------------------------------------
    def init(self, named_params: Dict[str, torch.Tensor]) -> dict:
        bad = [n for n, p in named_params.items()
               if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"DistributedOptimizer: params {bad[:3]} are "
                             "not fp32; bf16 params with an fp32 master "
                             "copy are not ported (ROADMAP.md Queue 1 "
                             "item 3)")
        ctx = self.ctx
        experts = ({n: p for n, p in named_params.items()
                    if ep_dim(n) is not None} if ctx.ep > 1 else {})
        rest = {n: p for n, p in named_params.items() if n not in experts}
        self.layout = FlatLayout(rest, ctx, layout_copies(ctx, self.tied_pp),
                                 axis="batch" if ctx.ep > 1 else "dp")
        self.parts = [_Part(self.layout, "", self.zero1)]
        if experts:
            self.parts.append(_Part(
                FlatLayout(experts, ctx, axis="dp"), EXPERT_SUFFIX,
                ctx.parallel.distributed_optimizer and ctx.dp > 1))
        state = {"count": 0}
        for part in self.parts:
            lo, hi = part.span
            dev = part.layout.params.device
            state["mu" + part.suffix] = torch.zeros(
                hi - lo, dtype=self.mu_dtype, device=dev)
            if self.cfg.optimizer == "adam":
                state["nu" + part.suffix] = torch.zeros(
                    hi - lo, dtype=self.nu_dtype, device=dev)
        return state

    def zero_grad(self) -> None:
        """Point every param's .grad at its zeroed slice of its grad
        buffer (autograd then accumulates in place)."""
        for part in self.parts:
            lay = part.layout
            lay.grads.zero_()
            for n, a, b in lay.slots:
                p = lay.named[n]
                p.grad = lay.grads[a:b].view(p.shape)

    def release_grads(self) -> None:
        for part in self.parts:
            for p in part.layout.named.values():
                p.grad = None
            part.g = None

    # -- the step's reductions ---------------------------------------------
    def reduce_grads(self, inv: float) -> None:
        """Scale by 1/num_micro, sum the tp-partial leaves over tp and a
        tied embedding's two copies over the embedding group, sum over cp,
        then over dp (or dp × ep; the expert stacks over dp alone), a
        reduce-scatter under ZeRO-1."""
        ctx = self.ctx
        for part in self.parts:
            lay = part.layout
            for n, a, b in lay.slots:
                # Autograd accumulates into the preset views; a grad it
                # placed elsewhere is copied in.
                got = lay.named[n].grad
                if got is not None and got.data_ptr() != \
                        lay.grads[a:b].data_ptr():
                    lay.grads[a:b].copy_(got.reshape(-1))
            g = lay.grads.mul_(inv)
            a, b = lay.partial
            if ctx.tp > 1 and b > a:
                collectives.all_reduce(g[a:b], ctx, "tp")
            if self.tied_pp and "embedding.word" in lay.offsets:
                a, b = lay.offsets["embedding.word"]
                collectives.all_reduce(g[a:b], ctx, "embed")
            collectives.all_reduce(g, ctx, "cp")
            if part.zero1:
                part.g = collectives.reduce_scatter(g, ctx, lay.axis)
            elif lay.fsdp:
                # The shards' grads arrived summed over dp (the FSDP
                # gather's reduce-scatter); the whole leaves' are summed
                # here.
                if lay.fsdp_end < lay.padded:
                    collectives.all_reduce(g[lay.fsdp_end:], ctx, lay.axis)
                part.g = g
            else:
                part.g = collectives.all_reduce(g, ctx, lay.axis)

    def norm_partials(self) -> torch.Tensor:
        """[sum of squares over this rank's chunks' tp-sharded elements,
        over their other counted elements] (fp32, on the device)."""
        out = None
        for part in self.parts:
            lay = part.layout
            lo, hi = lay.chunk
            if lay.fsdp:
                sums = self._fsdp_norm_partials(part.g, lay)
                out = sums if out is None else out + sums
                continue
            chunk = part.g if part.zero1 else part.g[lo:hi]
            cut = min(max(lay.sharded_end - lo, 0), hi - lo)
            end = min(max(lay.counted_end - lo, 0), hi - lo)
            sums = torch.stack([chunk[:cut].square().sum(),
                                chunk[cut:end].square().sum()])
            out = sums if out is None else out + sums
        return out

    @staticmethod
    def _fsdp_norm_partials(g: torch.Tensor, lay: FlatLayout
                            ) -> torch.Tensor:
        """norm_partials of an FSDP layout's whole grads g: a range split
        over dp counted whole, a whole one in this rank's dp chunk."""
        lo, hi = lay.chunk
        sums = [g.new_zeros(()), g.new_zeros(())]
        for a, b, group, split in lay.runs:
            if group == 3:
                continue
            if not split:
                a, b = max(a, lo), min(b, hi)
                if a >= b:
                    continue
            cat = 0 if group == 0 else 1
            sums[cat] = sums[cat] + g[a:b].square().sum()
        return torch.stack(sums)

    def _return_params(self, lay: FlatLayout, p: torch.Tensor) -> None:
        """ZeRO-1's updated chunk p back to every rank of the layout's
        axis, into the flat params, by dist_opt_comm (module
        docstring)."""
        comm = self.cfg.dist_opt_comm
        if comm == "ring":
            from megatronapp_tpu_torch.parallel.overlap import (
                ring_all_gather,
            )
            ring_all_gather(p.clone(), self.ctx, lay.axis,
                            op_name="zero1-param-return", out=lay.params)
        else:
            collectives.all_gather_into(lay.params, p.clone(), self.ctx,
                                        lay.axis)

    @torch.no_grad()
    def step(self, state: dict, grad_norm: Tuple[float, torch.Tensor]
             ) -> None:
        """The update of this rank's spans (see the module docstring);
        ZeRO-1 then all-gathers the updated params over its axis."""
        cfg = self.cfg
        norm_host, norm_dev = grad_norm
        count = state["count"]
        lr, bc1, bc2 = self.scalars(count)
        for part in self.parts:
            lay = part.layout
            lo, hi = part.span
            g = part.g if part.zero1 else part.g[lo:hi]
            if cfg.clip_grad and not norm_host < cfg.clip_grad:
                g.div_(norm_dev).mul_(cfg.clip_grad)
            p = lay.params[lo:hi]
            mu, nu = state["mu" + part.suffix], state.get("nu" + part.suffix)
            for n, a, b in lay.slots:
                s, e = max(a, lo) - lo, min(b, hi) - lo
                if s >= e:
                    continue
                self.update_leaf(decays(n, lay.named[n]), p[s:e], g[s:e],
                                 mu[s:e], None if nu is None else nu[s:e],
                                 lr, bc1, bc2)
            if part.zero1:
                self._return_params(lay, p)
        state["count"] = count + 1

    # -- the layout-independent state ----------------------------------------
    def _full_moment(self, part: _Part, flat: torch.Tensor) -> torch.Tensor:
        """A moment over a whole flat buffer (gathered over its axis under
        ZeRO-1)."""
        if not part.zero1:
            return flat
        full = torch.empty(part.layout.padded, dtype=flat.dtype,
                           device=flat.device)
        return collectives.all_gather_into(full, flat, self.ctx,
                                           part.layout.axis)

    def _moments(self, state) -> List[str]:
        """The names of the state's moments ("mu", "nu"), without the
        parts' suffixes."""
        return [k for k, v in state.opt_state.items()
                if isinstance(v, torch.Tensor) and EXPERT_SUFFIX not in k]

    def full_state_dict(self, state) -> Optional[Dict[str, object]]:
        """The train state with every leaf whole, as CPU tensors, under the
        one-device leaf paths, on rank 0 (None on the others). Collective:
        every rank calls it."""
        ctx = self.ctx
        # Who keeps the whole leaves: rank 0, or under pp each stage's
        # rank of dp, cp and tp index 0 (their stages then meet on rank 0).
        keep = ctx.is_lead if ctx.pp == 1 else not (
            ctx.dp_rank or ctx.cp_rank or ctx.tp_rank)
        out: Dict[str, object] = {"step": int(state.step)}
        tensors: Dict[str, torch.Tensor] = {}
        for part in self.parts:
            lay = part.layout
            segs = segment_counts(lay.named)
            for n, p in lay.named.items():
                full = gather_leaf(p.detach(), n, segs[n], ctx)
                if keep:
                    tensors[f"params/{n}"] = full.to("cpu", copy=True)
        for key, v in state.opt_state.items():
            if not isinstance(v, torch.Tensor):
                out[f"opt_state/{key}"] = int(v)
        for key in self._moments(state):
            for part in self.parts:
                lay = part.layout
                segs = segment_counts(lay.named)
                whole = self._full_moment(part,
                                          state.opt_state[key + part.suffix])
                for n in lay.named:
                    full = gather_leaf(lay.view(whole, n).contiguous(), n,
                                       segs[n], ctx)
                    if keep:
                        tensors[f"opt_state/{key}/{n}"] = full.to(
                            "cpu", copy=True)
                del whole
        if ctx.pp > 1:
            from megatronapp_tpu_torch.parallel.sharding import (
                gather_stages,
            )
            tensors = gather_stages(tensors, ctx)
        if not ctx.is_lead:
            return None
        out.update(tensors)
        if state.fp8 is not None:
            from megatronapp_tpu_torch.training.fp8 import flat_fp8
            out.update({k: t.to("cpu", copy=True)
                        for k, t in flat_fp8(state.fp8).items()})
        return out

    @torch.no_grad()
    def load_full_state_dict(self, state, flat: Dict[str, object]) -> None:
        """Copy a layout-independent state (every leaf whole) into this
        rank's shards in place (under pp: of its stage's leaves). Raises
        when the leaf paths differ from the whole model's (under pp every
        stage's, so every rank raises alike) or a shard's shape from the
        state's. Collective under pp: every rank calls it."""
        ctx = self.ctx
        names = [n for part in self.parts for n in part.layout.named]
        moments = self._moments(state)
        want = {"step"} | {f"params/{n}" for n in names}
        for key, v in state.opt_state.items():
            if not isinstance(v, torch.Tensor):
                want.add(f"opt_state/{key}")
        for key in moments:
            want |= {f"opt_state/{key}/{n}" for n in names}
        fp8_leaves = {}
        if state.fp8 is not None:
            from megatronapp_tpu_torch.training.fp8 import flat_fp8
            fp8_leaves = flat_fp8(state.fp8)
            want |= set(fp8_leaves)
        if ctx.pp > 1:
            # The whole model's leaves: every stage's, gathered.
            import torch.distributed as dist
            every: List[object] = [None] * ctx.world
            dist.all_gather_object(every, sorted(want),
                                   group=ctx.world_group)
            want = set().union(*every)
        extra = set(flat) - want
        if want - set(flat) or extra:
            raise ValueError(
                f"train state structure differs: missing "
                f"{sorted(want - set(flat))[:4]}, unexpected "
                f"{sorted(extra)[:4]}")
        for part in self.parts:
            lay = part.layout
            segs = segment_counts(lay.named)

            def local(key, name):
                t = shard_leaf(flat[key],
                               tp_dim(name) if ctx.tp > 1 else None,
                               segs[name], ctx.tp, ctx.tp_rank)
                t = fsdp_shard(ep_shard(t, name, ctx), name, ctx)
                shape = lay.named[name].shape
                if tuple(t.shape) != tuple(shape):
                    raise ValueError(f"{key}: checkpoint shard "
                                     f"{tuple(t.shape)}, state "
                                     f"{tuple(shape)}")
                return t

            for n in lay.named:
                lay.named[n].copy_(local(f"params/{n}", n))
            lo, hi = part.span
            for key in moments:
                v = state.opt_state[key + part.suffix]
                whole = torch.zeros(lay.padded, dtype=v.dtype,
                                    device=v.device)
                for n in lay.named:
                    lay.view(whole, n).copy_(local(f"opt_state/{key}/{n}",
                                                   n))
                v.copy_(whole[lo:hi])
        for key, v in state.opt_state.items():
            if not isinstance(v, torch.Tensor):
                state.opt_state[key] = int(flat[f"opt_state/{key}"])
        for key, t in fp8_leaves.items():
            t.copy_(flat[key])
        state.step = int(flat["step"])
