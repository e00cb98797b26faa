"""Context parallelism: ring, zigzag ring, Ulysses all-to-all, allgather
and hierarchical attention (the JAX package's ops/context_parallel.py).

Each cp rank holds a share of the sequence, [B, S/cp, H, D], and the
modes exchange what attention needs across the cp group
(parallel/mesh.py) through parallel/collectives.py:

- 'p2p', the contiguous ring (``ring_attention``): rank i holds chunk i;
  K/V blocks rotate around the ring, one ``ring_hop`` a round, issued
  before the round's compute and waited after it, and each round runs
  one online-softmax update in fp32. Under causal attention a block from
  a later rank is skipped whole (the plain form below masks it instead,
  so that every rank builds the same autograd graph and runs the hops'
  backward in the same order). ``overlap`` (TransformerConfig
  cp_comm_overlap, JAX's custom_vjp path) selects the save-little form,
  a ``torch.autograd.Function`` whose forward keeps q, k, v, the output
  and the fp32 log-sum-exp and whose backward runs JAX's fused reverse
  ring: (K, V) and their (dK, dV) accumulators rotate together, and
  after cp hops the accumulators are home (``_ring_overlap_bwd_impl``).
  Without it autograd runs back through the rounds and the hops (JAX's
  unrolled ring differentiated by autodiff), keeping every round's
  probabilities.
- 'p2p' in zigzag order (``zigzag_ring_attention``, the internal mode
  'p2p_zigzag'): rank i holds chunks (i, 2cp-1-i) of a 2cp-way split
  (``zigzag_indices``), and each off-diagonal round computes the half
  block that (rank, source) says is visible, so the ranks do equal work.
  It always takes the save-little form: at llama3-8b's attention on the
  card (S/cp 4096, 16 heads a tp rank) one fp32 score block is 1 GiB, and
  autograd through the rounds would keep cp of them a layer.
- 'a2a', Ulysses (``ulysses_attention``): an all-to-all turns [B, S/cp,
  H, D] into [B, S, H/cp, D], attention runs on the whole sequence of
  those heads, and the inverse all-to-all brings the heads back.
- 'allgather' (``allgather_attention``): K and V are all-gathered along
  the sequence (their backward reduce-scatters the grads) and the local
  queries attend them at their global offset.
- 'a2a+p2p', hierarchical (``hierarchical_attention``): the all-to-all
  within inner groups of a2a_size consecutive cp ranks, the ring across
  the groups.

Every mode's attention is plain PyTorch, blockwise (``_attend``): JAX's
CP path runs no Pallas kernel (its attention.py takes the CP branch
before the flash branch), so the port's runs no hand-written kernel
either. A block's fp32 scores are formed a few kv heads at a time, at
most ``BLOCK_BYTES`` each, and the 'a2a' and 'allgather' local attention
is the same save-little block function on a ring of one rank.

``context_attention`` is JAX's outer wrapper for callers that hold the
whole sequence on every cp rank (the tests): it pads S to a multiple of
cp, masking the pad through synthetic segment ids (pad 0, real tokens
their id + 1), takes this rank's share, runs the mode and all-gathers
the output, whose backward keeps this rank's share; the input's backward
all-gathers the grads, so every rank gets the same whole grads. The
transformer layer calls ``cp_attention`` on its own shares.

MegaScan: every ring round records a 'cp-overlap-compute' span and every
hop a 'cp-overlap-permute' span (B when issued, E when waited), with
JAX's args op, rank (the ring index) and step (trace/tracer.py
``phase_event``); the collectives record their own events.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from megatronapp_tpu_torch.config.transformer_config import AttnMaskType
from megatronapp_tpu_torch.parallel import collectives
from megatronapp_tpu_torch.trace.tracer import get_tracer

_NEG_INF = -1e30

# MegaScan span names (trace/tracer.py GRANULARITY_EVENTS 'collective').
CP_OVERLAP_COMPUTE_EVENT = "cp-overlap-compute"
CP_OVERLAP_PERMUTE_EVENT = "cp-overlap-permute"

# The valid cp_comm_type config values (JAX's names). 'p2p' runs the
# zigzag ring when zigzag_active allows it and the caller laid the
# sequence out in zigzag order; 'p2p_zigzag' is not a config value.
CP_COMM_TYPES = frozenset({"p2p", "a2a", "allgather", "a2a+p2p"})
_MODES = ("a2a", "a2a+p2p", "allgather", "p2p", "p2p_zigzag")

# The largest fp32 score block formed at once: a block's kv heads are
# taken in chunks below it.
BLOCK_BYTES = 256 << 20


def zigzag_indices(seq_len: int, cp: int) -> np.ndarray:
    """Permutation taking a contiguous sequence to zigzag layout: the
    sequence splits into 2cp chunks, and rank i's contiguous S/cp share of
    the permuted sequence holds original chunks (i, 2cp-1-i). permuted[j]
    = original[idx[j]]; idx doubles as the permuted tokens' positions."""
    if seq_len % (2 * cp):
        raise ValueError(
            f"zigzag context parallelism needs seq_len divisible by "
            f"2*cp={2*cp} (got {seq_len})")
    c = seq_len // (2 * cp)
    order = []
    for i in range(cp):
        order += [i, 2 * cp - 1 - i]
    return np.concatenate(
        [np.arange(ch * c, (ch + 1) * c, dtype=np.int32) for ch in order])


def zigzag_inverse_indices(seq_len: int, cp: int) -> np.ndarray:
    """Inverse permutation: unpermuted[i] = permuted[inv[i]]."""
    idx = zigzag_indices(seq_len, cp)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(seq_len, dtype=np.int32)
    return inv


def zigzag_active(cfg, ctx) -> bool:
    """True when the config and grid allow the zigzag ring (JAX's rule):
    models that permute their sequences use it to decide, and attention
    also needs the caller's zigzag layout flag."""
    return (ctx is not None and ctx.cp > 1 and cfg.cp_comm_type == "p2p"
            and cfg.cp_zigzag and not cfg.multi_latent_attention
            # MTP depth modules roll tokens in natural order.
            and not cfg.mtp_num_layers
            and cfg.attn_mask_type == AttnMaskType.causal)


def seq_indices(seq_len: int, cp: int, cp_rank: int,
                zigzag: bool) -> np.ndarray:
    """The global positions of cp rank `cp_rank`'s share of a sequence, in
    its local order: its contiguous S/cp block of the (zigzag-permuted,
    when zigzag) sequence."""
    if seq_len % cp:
        raise ValueError("--seq-length must be divisible by "
                         "--context-parallel-size")
    n = seq_len // cp
    order = (zigzag_indices(seq_len, cp) if zigzag
             else np.arange(seq_len, dtype=np.int32))
    return order[cp_rank * n:(cp_rank + 1) * n].astype(np.int64)


# ---------------------------------------------------------------------------
# The ring and its rounds.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Ring:
    """A ring of cp blocks: global `ranks` in ring order (one rank: no
    hops), this rank's index `me`, the layout ("contiguous" or
    "zigzag"), the mask (causal; on a ring of one, q row i sits at kv
    position q_offset + i) and the MegaScan op."""

    ctx: Any
    ranks: List[int]
    me: int
    layout: str
    causal: bool
    scale: float
    op: str
    q_offset: int = 0

    @property
    def n(self) -> int:
        return len(self.ranks)

    def issue(self, tensors, step: int, tag: str = "kv",
              reverse: bool = False):
        """Start a hop of `tensors` to the next rank (the previous one
        when reverse) and the same shapes from the other side; its
        'cp-overlap-permute' span opens now and closes at wait()."""
        nxt = self.ranks[(self.me + 1) % self.n]
        prv = self.ranks[(self.me - 1) % self.n]
        dst, src = (prv, nxt) if reverse else (nxt, prv)
        attrs = dict(op=self.op, rank=self.me, step=int(step))
        tracer = get_tracer()
        tracer.phase_event(CP_OVERLAP_PERMUTE_EVENT, "B", **attrs)
        hop = collectives.ring_hop(self.ctx, list(tensors), dst, src,
                                   self.ranks, tag)
        return _Waiting(hop, attrs)


class _Waiting:
    def __init__(self, hop, attrs):
        self.hop, self.attrs = hop, attrs

    def wait(self) -> List[torch.Tensor]:
        out = self.hop.wait()
        get_tracer().phase_event(CP_OVERLAP_PERMUTE_EVENT, "E",
                                 **self.attrs)
        return out


class _HopFn(torch.autograd.Function):
    """A differentiable ring hop (the plain ring's): the forward sends to
    the next rank, the backward sends the grads to the previous one."""

    @staticmethod
    def forward(fctx, ring, step, *tensors):
        fctx.ring, fctx.step = ring, step
        fctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        out = ring.issue(tensors, step).wait()
        fctx.mark_non_differentiable(
            *[o for o in out if not o.is_floating_point()])
        return tuple(out)

    @staticmethod
    def backward(fctx, *grads):
        idx = [i for i, (_, dt, _) in enumerate(fctx.like)
               if dt.is_floating_point]
        send = [grads[i] if grads[i] is not None else torch.zeros(
            fctx.like[i][0], dtype=fctx.like[i][1], device=fctx.like[i][2])
            for i in idx]
        back = fctx.ring.issue(send, fctx.step, tag="dkv",
                               reverse=True).wait()
        out = [None] * len(fctx.like)
        for i, g in zip(idx, back):
            out[i] = g
        return (None, None, *out)


def _blocks(ring: _Ring, src: int, sq: int, skv: int, skip: bool = True):
    """The (q rows, kv cols, kind) blocks of the round attending the K/V
    block of ring index src; kind "full" (every score kept), "diag" (the
    positional causal mask) or "hidden" (every score masked). [] skips
    the round (a later block under causal attention); skip=False keeps it
    as a hidden block, so every rank builds the same autograd graph (JAX's
    plain ring masks such blocks rather than skipping them)."""
    every = slice(None)
    if not ring.causal:
        return [(every, every, "full")]
    if src == ring.me:
        return [(every, every, "diag")]
    if ring.layout == "zigzag":
        # src < me: only kv chunk `src` (the first half) is visible, to
        # every q row; src > me: only the second q half (chunk 2cp-1-me)
        # attends, and it sees both kv chunks.
        if src < ring.me:
            return [(every, slice(0, skv // 2), "full")]
        return [(slice(sq // 2, None), every, "full")]
    if src < ring.me:
        return [(every, every, "full")]
    return [] if skip else [(every, every, "hidden")]


def _diag_mask(ring: _Ring, sq: int, skv: int, device) -> torch.Tensor:
    """[Sq, Skv] keep-mask of the diagonal round from the rows' and
    columns' global positions."""
    if ring.layout == "zigzag":
        c, n, me = sq // 2, ring.n, ring.me
        r = torch.arange(c, device=device)
        pos = torch.cat([me * c + r, (2 * n - 1 - me) * c + r])
        return pos[:, None] >= pos[None, :]
    qp = torch.arange(sq, device=device) + ring.q_offset
    return qp[:, None] >= torch.arange(skv, device=device)[None, :]


def _block_mask(ring, kind, rows, cols, sq, skv, q_seg, kv_seg, device):
    """A block's keep-mask, broadcastable to [B, Hkv, G, rows, cols]
    (None: every score kept)."""
    mask = None
    if kind == "diag":
        mask = _diag_mask(ring, sq, skv, device)[rows, cols]
    elif kind == "hidden":
        mask = torch.zeros(sq, skv, dtype=torch.bool,
                           device=device)[rows, cols]
    if q_seg is not None:
        seg = (q_seg[:, rows][:, :, None] == kv_seg[:, cols][:, None, :])
        seg = seg[:, None, None]
        mask = seg if mask is None else seg & mask
    return mask


def _head_chunks(b: int, hkv: int, g: int, sr: int, sc: int):
    """Slices of the kv heads whose fp32 score blocks stay under
    BLOCK_BYTES (one head at least)."""
    per = max(1, BLOCK_BYTES // max(1, b * g * sr * sc * 4))
    return [slice(a, min(a + per, hkv)) for a in range(0, hkv, per)]


def _heads_first(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, S, H, D] → [B, Hkv, G, S, D] (q head h → kv head h // G)."""
    b, s, h, d = x.shape
    return x.reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)


def _put(full: torch.Tensor, part: torch.Tensor, rows: slice):
    """full with its rows (dim 3) replaced by part, as a new tensor."""
    if rows == slice(None):
        return part
    n = full.shape[3]
    a, b, _ = rows.indices(n)
    return torch.cat([full.narrow(3, 0, a), part,
                      full.narrow(3, b, n - b)], dim=3)


def _update(state, q32, k32, v32, vdt, rows, cols, mask, scale):
    """One online-softmax update (JAX's _softmax_block_update) of the
    unnormalised state (o, m, l) [B, Hkv, G, Sq(, Dv)] with the block
    (rows, cols): scores in fp32, P cast to V's dtype before P·V, whose
    products sum in fp32. Functional, so autograd may run through it."""
    o, m, l = state
    b, hkv, g = q32.shape[:3]
    qr = q32[:, :, :, rows]
    kc, vc = k32[:, :, cols], v32[:, :, cols]
    sr, sc = qr.shape[3], kc.shape[2]
    os_, ms_, ls_ = [], [], []
    for hs in _head_chunks(b, hkv, g, sr, sc):
        s = torch.matmul(qr[:, hs], kc[:, hs, None].transpose(-1, -2)) \
            * scale
        if mask is not None:
            s = s.masked_fill(~mask, _NEG_INF)
        m_r = m[:, hs, :, rows]
        m_new = torch.maximum(m_r, s.amax(dim=-1))
        p = torch.exp(s - m_new.clamp(min=_NEG_INF / 2)[..., None])
        corr = torch.exp((m_r - m_new).clamp(max=0.0))
        corr = torch.where(m_r <= _NEG_INF / 2, 0.0, corr)
        ls_.append(l[:, hs, :, rows] * corr + p.sum(dim=-1))
        pv = torch.matmul(p.to(vdt).float(), vc[:, hs, None])
        os_.append(o[:, hs, :, rows] * corr[..., None] + pv)
        ms_.append(m_new)
    return (_put(o, torch.cat(os_, 1), rows), _put(m, torch.cat(ms_, 1),
                                                   rows),
            _put(l, torch.cat(ls_, 1), rows))


def _forward_rounds(ring: _Ring, q, k, v, q_seg, kv_seg,
                    differentiable: bool):
    """The ring's forward (JAX's _ring_overlap_fwd_impl and its zigzag
    and hierarchical rounds): (out [B, Sq, H, Dv] in q's dtype, lse [B,
    Hkv, G, Sq] fp32). differentiable: the hops are autograd Functions
    (the plain ring); otherwise each hop is issued before the round it
    rides under."""
    b, sq, h, _ = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = h // hkv
    q32 = _heads_first(q.float(), hkv)
    o = q32.new_zeros(b, hkv, g, sq, dv)
    m = q32.new_full((b, hkv, g, sq), _NEG_INF)
    l = q32.new_zeros(b, hkv, g, sq)
    carry = [k, v] + ([] if kv_seg is None else [kv_seg])
    tracer = get_tracer()
    for step in range(ring.n):
        nxt = None
        if step + 1 < ring.n:
            if differentiable:
                carry_next = list(_HopFn.apply(ring, step, *carry))
            else:
                nxt = ring.issue(carry, step)
        src = (ring.me - step) % ring.n
        attrs = dict(op=ring.op, rank=ring.me, step=step)
        tracer.phase_event(CP_OVERLAP_COMPUTE_EVENT, "B", **attrs)
        blocks = _blocks(ring, src, sq, carry[0].shape[1],
                         skip=not differentiable)
        if blocks:
            k32 = carry[0].float().transpose(1, 2)
            v32 = carry[1].float().transpose(1, 2)
            seg = carry[2] if kv_seg is not None else None
            for rows, cols, kind in blocks:
                mask = _block_mask(ring, kind, rows, cols, sq,
                                   k32.shape[2], q_seg, seg, q.device)
                o, m, l = _update((o, m, l), q32, k32, v32, v.dtype,
                                  rows, cols, mask, ring.scale)
        tracer.phase_event(CP_OVERLAP_COMPUTE_EVENT, "E", **attrs)
        if step + 1 < ring.n:
            carry = carry_next if differentiable else nxt.wait()
    lse = m + torch.log(l.clamp(min=1e-20))
    out = o / l.clamp(min=1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)
    return out, lse


def _backward_rounds(ring: _Ring, q, k, v, out, lse, do, q_seg, kv_seg):
    """JAX's fused reverse ring (_ring_overlap_bwd_impl): one pass rotates
    (k, v) and their fp32 (dk, dv) accumulators together; the next
    block's hop is issued before the round, the accumulators hop after it
    and are home after the ring's n hops; dq accumulates here. Every
    product is fp32, from the probabilities exp(s - lse)."""
    b, sq, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = h // hkv
    q32 = _heads_first(q.float(), hkv)
    do32 = _heads_first(do.float(), hkv)
    delta = (do32 * _heads_first(out.float(), hkv)).sum(dim=-1)
    dq = torch.zeros_like(q32)
    carry = [k, v] + ([] if kv_seg is None else [kv_seg])
    skv = k.shape[1]
    acc = [q32.new_zeros(b, hkv, skv, d), q32.new_zeros(b, hkv, skv, dv)]
    tracer = get_tracer()
    for step in range(ring.n):
        nxt = ring.issue(carry, step) if step + 1 < ring.n else None
        src = (ring.me - step) % ring.n
        attrs = dict(op=ring.op, rank=ring.me, step=step)
        tracer.phase_event(CP_OVERLAP_COMPUTE_EVENT, "B", **attrs)
        blocks = _blocks(ring, src, sq, skv)
        if blocks:
            k32 = carry[0].float().transpose(1, 2)
            v32 = carry[1].float().transpose(1, 2)
            seg = carry[2] if kv_seg is not None else None
        for rows, cols, kind in blocks:
            mask = _block_mask(ring, kind, rows, cols, sq, skv, q_seg, seg,
                               q.device)
            qr, dor = q32[:, :, :, rows], do32[:, :, :, rows]
            kc, vc = k32[:, :, cols], v32[:, :, cols]
            for hs in _head_chunks(b, hkv, g, qr.shape[3], kc.shape[2]):
                kb, vb = kc[:, hs, None], vc[:, hs, None]
                s = torch.matmul(qr[:, hs], kb.transpose(-1, -2)) \
                    * ring.scale
                if mask is not None:
                    s = s.masked_fill(~mask, _NEG_INF)
                p = torch.exp(s - lse[:, hs, :, rows, None])
                del s
                if mask is not None:
                    p = p.masked_fill(~mask, 0.0)
                acc[1][:, hs, cols] += torch.einsum(
                    "bhgqk,bhgqe->bhke", p, dor[:, hs])
                ds = torch.matmul(dor[:, hs], vb.transpose(-1, -2))
                ds = p.mul_(ds.sub_(delta[:, hs, :, rows, None])) \
                    .mul_(ring.scale)
                dq[:, hs, :, rows] += torch.matmul(ds, kb)
                acc[0][:, hs, cols] += torch.einsum(
                    "bhgqk,bhgqd->bhkd", ds, qr[:, hs])
                del p, ds
        tracer.phase_event(CP_OVERLAP_COMPUTE_EVENT, "E", **attrs)
        if ring.n > 1:
            acc = ring.issue(acc, step, tag="dkv").wait()
        if nxt is not None:
            carry = nxt.wait()
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return (dq, acc[0].transpose(1, 2).to(k.dtype),
            acc[1].transpose(1, 2).to(v.dtype))


class _RingAttention(torch.autograd.Function):
    """The save-little ring: the forward keeps q, k, v, the output and
    the fp32 log-sum-exp; the backward is the fused reverse ring."""

    @staticmethod
    def forward(fctx, q, k, v, q_seg, kv_seg, ring):
        out, lse = _forward_rounds(ring, q, k, v, q_seg, kv_seg,
                                   differentiable=False)
        fctx.ring = ring
        fctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        return out

    @staticmethod
    def backward(fctx, do):
        q, k, v, out, lse, q_seg, kv_seg = fctx.saved_tensors
        ring = dataclasses.replace(fctx.ring, op=fctx.ring.op + "-bwd")
        dq, dk, dv = _backward_rounds(ring, q, k, v, out, lse,
                                      do.contiguous(), q_seg, kv_seg)
        return dq, dk, dv, None, None, None


def _attend(q, k, v, ring: _Ring, q_seg=None, kv_seg=None,
            save_little: bool = True):
    if save_little:
        return _RingAttention.apply(q, k, v, q_seg, kv_seg, ring)
    return _forward_rounds(ring, q, k, v, q_seg, kv_seg,
                           differentiable=True)[0]


def _scale(q, softmax_scale):
    return (1.0 / math.sqrt(q.shape[-1]) if softmax_scale is None
            else float(softmax_scale))


# ---------------------------------------------------------------------------
# The sequence and head exchanges, as autograd Functions.
# ---------------------------------------------------------------------------

def _seq_to_heads(x, ctx, axis):
    """[B, S/n, H, D] → [B, S, H/n, D] over the axis' n ranks."""
    n = len(collectives._axis(ctx, axis)[1])
    b, sl, h, d = x.shape
    if h % n:
        raise ValueError(f"the all-to-all cp modes need the heads ({h} "
                         f"here, per tp rank) divisible by {n}")
    parts = x.reshape(b, sl, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = collectives.all_to_all(parts.contiguous(), ctx, axis)
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * sl, h // n, d)


def _heads_to_seq(x, ctx, axis):
    """[B, S, H/n, D] → [B, S/n, H, D]: the inverse of _seq_to_heads."""
    n = len(collectives._axis(ctx, axis)[1])
    b, s, hn, d = x.shape
    parts = x.reshape(b, n, s // n, hn, d).permute(1, 0, 2, 3, 4)
    got = collectives.all_to_all(parts.contiguous(), ctx, axis)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hn, d)


class _HeadScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis, inverse):
        fctx.args = (ctx, axis, inverse)
        fn = _heads_to_seq if inverse else _seq_to_heads
        return fn(x, ctx, axis)

    @staticmethod
    def backward(fctx, g):
        ctx, axis, inverse = fctx.args
        fn = _seq_to_heads if inverse else _heads_to_seq
        return fn(g.contiguous(), ctx, axis), None, None, None


class _AllGatherSeq(torch.autograd.Function):
    """K/V gathered along the sequence over an axis; the backward sums
    every rank's grads of this rank's share (a reduce-scatter)."""

    @staticmethod
    def forward(fctx, x, ctx, axis):
        fctx.args = (ctx, axis)
        return collectives.all_gather_cat(x, ctx, axis, 1)

    @staticmethod
    def backward(fctx, g):
        ctx, axis = fctx.args
        b, s = g.shape[:2]
        n = len(collectives._axis(ctx, axis)[1])
        flat = g.float().transpose(0, 1).contiguous().reshape(-1)
        mine = collectives.reduce_scatter(flat, ctx, axis)
        mine = mine.view(s // n, b, *g.shape[2:]).transpose(0, 1)
        return mine.to(g.dtype).contiguous(), None, None


class _ShareOfSeq(torch.autograd.Function):
    """context_attention's input: this cp rank's share of a whole
    sequence; the backward all-gathers every rank's grads, so each rank
    holds the whole grads."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        n = x.shape[1] // ctx.cp
        return x[:, ctx.cp_rank * n:(ctx.cp_rank + 1) * n].contiguous()

    @staticmethod
    def backward(fctx, g):
        return collectives.all_gather_cat(g.contiguous(), fctx.ctx, "cp",
                                          1), None


class _WholeSeq(torch.autograd.Function):
    """context_attention's output: every share all-gathered; the backward
    keeps this rank's share."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx, fctx.n = ctx, x.shape[1]
        return collectives.all_gather_cat(x.contiguous(), ctx, "cp", 1)

    @staticmethod
    def backward(fctx, g):
        r, n = fctx.ctx.cp_rank, fctx.n
        return g[:, r * n:(r + 1) * n].contiguous(), None


def _gather_segments(seg, ctx, axis):
    return None if seg is None else collectives.all_gather_cat(
        seg.contiguous(), ctx, axis, 1)


# ---------------------------------------------------------------------------
# The modes, on this rank's share [B, S/cp, H, D].
# ---------------------------------------------------------------------------

def ring_attention(q, k, v, ctx, causal: bool = True,
                   softmax_scale: Optional[float] = None,
                   segment_ids=None, overlap: bool = True):
    """The contiguous ring over ctx's cp group (JAX ring_attention):
    rank i holds chunk i. segment_ids [B, S/cp]: the kv ids ride the ring
    with their blocks. overlap: the save-little form (module
    docstring)."""
    ring = _Ring(ctx, ctx.cp_ranks, ctx.cp_rank, "contiguous", causal,
                 _scale(q, softmax_scale), "ring-attention")
    return _attend(q, k, v, ring, segment_ids, segment_ids,
                   save_little=overlap)


def zigzag_ring_attention(q, k, v, ctx, causal: bool = True,
                          softmax_scale: Optional[float] = None,
                          segment_ids=None):
    """The load-balanced ring over zigzag-ordered shares (JAX
    zigzag_ring_attention): the local block is [chunk_me; chunk_{2cp-1-me}]
    of a 2cp-way split. Bidirectional attention takes the contiguous
    ring."""
    if segment_ids is not None:
        raise ValueError("packed sequences route through the contiguous "
                         "ring (zigzag_active excludes segment_ids)")
    if not causal:
        return ring_attention(q, k, v, ctx, causal=False,
                              softmax_scale=softmax_scale)
    ring = _Ring(ctx, ctx.cp_ranks, ctx.cp_rank, "zigzag", True,
                 _scale(q, softmax_scale), "zigzag-ring-attention")
    return _attend(q, k, v, ring)


def _local_ring(ctx, causal, scale, op, q_offset=0):
    return _Ring(ctx, [ctx.rank], 0, "contiguous", causal, scale, op,
                 q_offset)


def ulysses_attention(q, k, v, ctx, causal: bool = True,
                      softmax_scale: Optional[float] = None,
                      segment_ids=None):
    """Ulysses (JAX ulysses_attention): all-to-all to [B, S, H/cp, D],
    attention over the whole sequence of those heads, all-to-all back.
    The q and kv heads (per tp rank) must divide by cp."""
    scale = _scale(q, softmax_scale)
    qh, kh, vh = (_HeadScatter.apply(x, ctx, "cp", False)
                  for x in (q, k, v))
    segs = _gather_segments(segment_ids, ctx, "cp")
    out = _attend(qh, kh, vh, _local_ring(ctx, causal, scale,
                                          "ulysses-attention"), segs, segs)
    return _HeadScatter.apply(out, ctx, "cp", True)


def allgather_attention(q, k, v, ctx, causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        segment_ids=None):
    """K and V all-gathered over cp; the local queries attend the whole
    sequence at their offset (JAX allgather_attention)."""
    sq = q.shape[1]
    k_full = _AllGatherSeq.apply(k, ctx, "cp")
    v_full = _AllGatherSeq.apply(v, ctx, "cp")
    segs = _gather_segments(segment_ids, ctx, "cp")
    ring = _local_ring(ctx, causal, _scale(q, softmax_scale),
                       "allgather-attention", q_offset=ctx.cp_rank * sq)
    return _attend(q, k_full, v_full, ring, segment_ids, segs)


def hierarchical_attention(q, k, v, ctx, causal: bool = True,
                           softmax_scale: Optional[float] = None,
                           segment_ids=None, a2a_size: int = 2):
    """'a2a+p2p' (JAX hierarchical_attention): Ulysses within the inner
    groups of a2a_size consecutive cp ranks, then the contiguous ring
    (save-little) across the cp / a2a_size groups, each rank holding its
    group's span with H/a2a_size heads; segment ids are gathered to the
    span and ride the ring. The grid must have been built for this
    a2a_size (parallel/mesh.py build_mesh(cp_a2a_size=)) unless it is 1
    or cp."""
    cp = ctx.cp
    if a2a_size < 1 or cp % a2a_size:
        raise ValueError(f"hierarchical cp: a2a size {a2a_size} does not "
                         f"divide context_parallel={cp}")
    if a2a_size == 1:
        inner, ranks, me = None, ctx.cp_ranks, ctx.cp_rank
    elif a2a_size == cp:
        inner, ranks, me = "cp", [ctx.rank], 0
    else:
        if ctx.cp_a2a_size != a2a_size:
            raise ValueError(
                f"hierarchical cp: the grid's inner all-to-all groups are "
                f"of {ctx.cp_a2a_size} ranks, the config asks for "
                f"{a2a_size} (build_mesh(cp_a2a_size=))")
        inner, ranks, me = "cp_a2a", ctx.cp_outer_ranks, \
            ctx.cp_rank // a2a_size
    segs = segment_ids
    if inner is not None:
        q, k, v = (_HeadScatter.apply(x, ctx, inner, False)
                   for x in (q, k, v))
        segs = _gather_segments(segment_ids, ctx, inner)
    ring = _Ring(ctx, ranks, me, "contiguous", causal,
                 _scale(q, softmax_scale), "hierarchical-ring-attention")
    out = _attend(q, k, v, ring, segs, segs)
    if inner is not None:
        out = _HeadScatter.apply(out, ctx, inner, True)
    return out


def cp_attention(q, k, v, ctx, cp_comm_type: str = "p2p",
                 causal: bool = True, softmax_scale: Optional[float] = None,
                 segment_ids=None, a2a_size: int = 2,
                 overlap: bool = True):
    """Attention of this cp rank's shares q [B, S/cp, H, D], k/v [B, S/cp,
    Hkv, D(v)] (segment_ids [B, S/cp]) by the mode: 'p2p' (overlap: the
    save-little form), 'p2p_zigzag' (zigzag-ordered shares), 'a2a',
    'allgather' or 'a2a+p2p' (a2a_size)."""
    if cp_comm_type not in _MODES:
        raise ValueError(f"cp_comm_type must be one of {sorted(_MODES)}, "
                         f"got {cp_comm_type!r}")
    kw = dict(causal=causal, softmax_scale=softmax_scale,
              segment_ids=segment_ids)
    if cp_comm_type == "p2p":
        return ring_attention(q, k, v, ctx, overlap=overlap, **kw)
    if cp_comm_type == "p2p_zigzag":
        return zigzag_ring_attention(q, k, v, ctx, **kw)
    if cp_comm_type == "a2a":
        return ulysses_attention(q, k, v, ctx, **kw)
    if cp_comm_type == "allgather":
        return allgather_attention(q, k, v, ctx, **kw)
    return hierarchical_attention(q, k, v, ctx, a2a_size=a2a_size, **kw)


def context_attention(q, k, v, ctx, cp_comm_type: str = "p2p",
                      causal: bool = True,
                      softmax_scale: Optional[float] = None,
                      segment_ids=None, a2a_size: int = 2,
                      overlap_ring: bool = True):
    """JAX's outer wrapper: q, k, v [B, S, H, D] and segment_ids [B, S]
    whole on every cp rank (for 'p2p_zigzag' already in zigzag order);
    returns the whole output [B, S, H, Dv] on every rank, and under
    autograd the whole input grads on every rank. S not divisible by cp is
    zero-padded, the pad masked by synthetic segment ids (module
    docstring)."""
    if cp_comm_type not in _MODES:
        raise ValueError(f"cp_comm_type must be one of {sorted(_MODES)}, "
                         f"got {cp_comm_type!r}")
    b, s = q.shape[:2]
    pad = (-s) % ctx.cp
    if pad:
        if cp_comm_type == "p2p_zigzag":
            raise ValueError(
                "zigzag layout requires seq divisible by 2*cp; callers "
                "(zigzag_indices) enforce this before permuting")
        segment_ids = (torch.ones((b, s), dtype=torch.int32,
                                  device=q.device)
                       if segment_ids is None else segment_ids + 1)
        segment_ids = F.pad(segment_ids, (0, pad))
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    n = (s + pad) // ctx.cp
    seg = (None if segment_ids is None else segment_ids[
        :, ctx.cp_rank * n:(ctx.cp_rank + 1) * n].contiguous())
    ql, kl, vl = (_ShareOfSeq.apply(x, ctx) for x in (q, k, v))
    out = cp_attention(ql, kl, vl, ctx, cp_comm_type, causal,
                       softmax_scale, seg, a2a_size, overlap_ring)
    out = _WholeSeq.apply(out, ctx)
    return out[:, :s] if pad else out
