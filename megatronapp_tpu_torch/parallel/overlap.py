"""Latency-hiding tensor-parallel matmuls (ring overlap): the port's
counterpart of the JAX package's parallel/overlap.py.

``all_gather_matmul(x, w, ctx)``
    The column-parallel product with x's sequence ring-all-gathered over
    tp in tp chunks: each chunk's GEMM runs while the next chunk hops.
    Several weights may share one gather (the fused QKV pair).
``matmul_reduce_scatter(y, w, ctx)``
    The row-parallel product whose partial sums ring-reduce-scatter along
    the sequence: each step's running partial sum hops while the next
    chunk's GEMM runs.

Each is an ``autograd.Function`` whose backward is JAX's fused ring: one
ring of x (or dout) chunks serves every wgrad (accumulated in fp32) and
the dgrad together. A rank's wgrads are its own batch rows' sums: JAX's
rings then sum them over the dp × ep "batch" group inside the backward,
but the port leaves that sum to training/distributed_optimizer.py's
reduction of the flat grad buffer, which sums every leaf over dp once
(summing here as well would count it twice, the trap JAX's
``reduce_batch`` note describes). The fp8 twins (``fp8=``,
training/fp8.py) move e4m3 chunks where the bf16 rings move bf16 ones,
keep the partial sums of the reduce-scatter in the output dtype, and
multiply through ``training/fp8.py:fp8_gemm``.

The port's layout. JAX's x enters the ring sharded along the sequence
over tp and its reduce-scatter output stays so, with GSPMD gathering
where a replicated consumer reads it. The port's activations are
tp-replicated [B, S, H], so:

- ``all_gather_matmul`` takes this rank's own sequence chunk of x
  (``_SeqChunk``, whose backward all-gathers the chunks' grads over tp:
  each rank's fused dgrad is its chunk's whole sum), and the ring
  rebuilds the whole [B, S, N/tp] from the chunks;
- ``matmul_reduce_scatter`` leaves each rank its reduced chunk [B, S/tp,
  H]; ``_SeqGather`` then all-gathers it over tp (its backward keeps the
  rank's chunk of the grad) before the residual add: the all-gather that
  GSPMD inserts after JAX's ring.

S that tp does not divide is zero-padded outside the Functions
(``_round_up``), as in JAX. Ring order is JAX's ``_ring_perm``: rank r
sends to r − 1, so at step s rank r holds chunk (r + s) % tp, and the
reduce-scatter adds the arriving partial sum before its own
(``moving + nxt``), so the fp32 sums add in JAX's order. Each hop is one
``collectives.axis_ring_hop`` over tp, staged through host memory (gloo's
CUDA send aborts), issued before the chunk's GEMM and waited after it,
counted as "send/tp" and "recv/tp" with its bytes.

``ring_all_gather`` is JAX's generic ring, ZeRO-1's param return under
``--dist-opt-comm ring`` (training/distributed_optimizer.py), with
'dp-overlap-permute' spans.

MegaScan: inside a traced iteration each ring step records
'tp-overlap-compute' (the chunk's GEMMs) and 'tp-overlap-permute' (a hop,
B when issued, E when it landed, with its bytes) with JAX's args op,
rank and step, on the timeline tid = tp rank + 1 (trace/tracer.py
``phase_event``).

``tp_overlap_eligible`` holds JAX's predicates; where it fails the layers
run their column/row tp layers (transformer/attention.py, mlp.py) and
log the predicate (``tp_overlap_ineligible_reason``) once.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import torch
import torch.nn.functional as F

from megatronapp_tpu_torch.parallel import collectives
from megatronapp_tpu_torch.trace.tracer import get_tracer
from megatronapp_tpu_torch.training import fp8 as fp8lib

OVERLAP_COMPUTE_EVENT = "tp-overlap-compute"
OVERLAP_PERMUTE_EVENT = "tp-overlap-permute"
# The generic ring (ring_all_gather) serves the ZeRO-1 dp param return.
DP_OVERLAP_PERMUTE_EVENT = "dp-overlap-permute"

_log = logging.getLogger(__name__)
_LOGGED: set = set()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mark(ctx, name: str, ph: str, *, op: str, step: int, data=None):
    """One end of a ring span on this tp rank's timeline."""
    extra = {} if data is None else {"data": int(data)}
    get_tracer().phase_event(name, ph, tid=ctx.tp_rank + 1, op=op,
                             rank=ctx.tp_rank, step=step, **extra)


def _issue(ctx, t: torch.Tensor, *, op: str, step: int):
    """A tp ring hop of t, issued (its span opened)."""
    _mark(ctx, OVERLAP_PERMUTE_EVENT, "B", op=op, step=step,
          data=_nbytes(t))
    return collectives.axis_ring_hop(ctx, [t], "tp"), _nbytes(t)


def _land(ctx, hop, *, op: str, step: int) -> torch.Tensor:
    """What the issued hop brought (its span closed)."""
    hop, n = hop
    out = hop.wait()[0]
    _mark(ctx, OVERLAP_PERMUTE_EVENT, "E", op=op, step=step, data=n)
    return out


# ---------------------------------------------------------------------------
# The bf16 (or fp32) ring bodies, on this rank's local tensors.
# ---------------------------------------------------------------------------

def _ag_mm_body(ctx, op, xl, wls):
    """xl [b, S/tp, H] (this rank's sequence chunk), wls: [H, N_j/tp]
    column shards sharing ONE ring of x → tuple of y_j [b, S, N_j/tp]."""
    tp, me = ctx.tp, ctx.tp_rank
    b, sc, h = xl.shape
    dt = torch.promote_types(xl.dtype, wls[0].dtype)
    ys = [torch.empty((b, sc * tp, wl.shape[1]), dtype=dt, device=xl.device)
          for wl in wls]
    chunk = xl
    for step in range(tp):
        hop = _issue(ctx, chunk, op=op, step=step) if step + 1 < tp \
            else None
        owner = (me + step) % tp
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "B", op=op, step=step)
        for j, wl in enumerate(wls):
            ys[j][:, owner * sc:(owner + 1) * sc] = chunk @ wl
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "E", op=op, step=step)
        if hop is not None:
            chunk = _land(ctx, hop, op=op, step=step)
    return tuple(ys)


def _mm_rs_rings(ctx, yls, wls, op="matmul-reduce-scatter"):
    """yls: [b, S, N_j/tp]; wls: matching [N_j/tp, H] → this rank's
    reduced sequence chunk [b, S/tp, H] of sum_j y_j @ w_j."""
    tp, me = ctx.tp, ctx.tp_rank
    sc = yls[0].shape[1] // tp

    def piece(c, step):
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "B", op=op, step=step)
        out = None
        for yl, wl in zip(yls, wls):
            yc = yl[:, c * sc:(c + 1) * sc]
            out = yc @ wl if out is None else out + yc @ wl
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "E", op=op, step=step)
        return out

    # acc_r after step s = sum_{j=r..r+s} partial_j[chunk (r+s+1) % tp];
    # after tp-1 hops rank r holds the fully reduced chunk r.
    acc = piece((me + 1) % tp, 0)
    for step in range(1, tp):
        hop = _issue(ctx, acc, op=op, step=step)
        nxt = piece((me + 1 + step) % tp, step)
        moving = _land(ctx, hop, op=op, step=step)
        acc = moving + nxt
    return acc


def _ag_mm_bwd_body(ctx, xl, wls, dyls):
    """The fused backward ring of all_gather_matmul: one ring of x chunks
    accumulates every wgrad in fp32; the dgrad is the reduce-scatter ring
    of sum_j dy_j @ w_j^T. Returns (dx [b, S/tp, H], tuple of dw_j)."""
    tp, me = ctx.tp, ctx.tp_rank
    b, sc, h = xl.shape
    op = "all-gather-matmul-bwd"
    dws = [torch.zeros((h, wl.shape[1]), dtype=torch.float32,
                       device=xl.device) for wl in wls]
    chunk = xl
    for step in range(tp):
        hop = _issue(ctx, chunk, op=op, step=step) if step + 1 < tp \
            else None
        owner = (me + step) % tp
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "B", op=op, step=step)
        for j, (wl, dyl) in enumerate(zip(wls, dyls)):
            dyc = dyl[:, owner * sc:(owner + 1) * sc]
            pm = (chunk.reshape(b * sc, h).T
                  @ dyc.reshape(b * sc, wl.shape[1]))
            dws[j] = dws[j] + pm.float()
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "E", op=op, step=step)
        if hop is not None:
            chunk = _land(ctx, hop, op=op, step=step)
    dx = _mm_rs_rings(ctx, dyls, tuple(wl.T for wl in wls), op=op)
    return (dx.to(xl.dtype),
            tuple(dw.to(wl.dtype) for dw, wl in zip(dws, wls)))


def _mm_rs_bwd_body(ctx, yl, wl, dol):
    """The fused backward ring of matmul_reduce_scatter: one ring of the
    dout chunks feeds the dgrad (dy = dout @ w^T, a chunk of rows at a
    time) and the wgrad (dw = sum_c y_c^T @ dout_c, fp32)."""
    tp, me = ctx.tp, ctx.tp_rank
    b, sc, h = dol.shape
    nl = wl.shape[0]
    op = "matmul-reduce-scatter-bwd"
    dy = torch.empty((b, sc * tp, nl),
                     dtype=torch.promote_types(dol.dtype, wl.dtype),
                     device=dol.device)
    dw = torch.zeros((nl, h), dtype=torch.float32, device=dol.device)
    chunk = dol
    for step in range(tp):
        hop = _issue(ctx, chunk, op=op, step=step) if step + 1 < tp \
            else None
        owner = (me + step) % tp
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "B", op=op, step=step)
        dyc = chunk @ wl.T
        yc = yl[:, owner * sc:(owner + 1) * sc]
        pm = yc.reshape(b * sc, nl).T @ chunk.reshape(b * sc, h)
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "E", op=op, step=step)
        dy[:, owner * sc:(owner + 1) * sc] = dyc
        dw = dw + pm.float()
        if hop is not None:
            chunk = _land(ctx, hop, op=op, step=step)
    return dy.to(yl.dtype), dw.to(wl.dtype)


class _AgMm(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, xl, *ws):
        fctx.mesh = ctx
        fctx.save_for_backward(xl, *ws)
        return _ag_mm_body(ctx, "all-gather-matmul", xl, ws)

    @staticmethod
    def backward(fctx, *dys):
        xl, *ws = fctx.saved_tensors
        dx, dws = _ag_mm_bwd_body(fctx.mesh, xl, ws, dys)
        return (None, dx, *dws)


class _MmRs(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, yl, wl):
        fctx.mesh = ctx
        fctx.save_for_backward(yl, wl)
        return _mm_rs_rings(ctx, (yl,), (wl,))

    @staticmethod
    def backward(fctx, dout):
        yl, wl = fctx.saved_tensors
        dy, dw = _mm_rs_bwd_body(fctx.mesh, yl, wl, dout.contiguous())
        return None, dy, dw


# ---------------------------------------------------------------------------
# The fp8 (e4m3) twins: the same rings on e4m3 codes, delayed scaling.
# ---------------------------------------------------------------------------

def _global_amax(ctx, v: torch.Tensor) -> torch.Tensor:
    """Max of v over the batch group and tp (every rank the same bits)."""
    for axis in ("batch", "tp"):
        collectives.all_reduce(v, ctx, axis, op="max")
    return v


def _global_sats(ctx, spread: List[torch.Tensor],
                 replicated: List[torch.Tensor]) -> torch.Tensor:
    """Saturation counts summed over the elements of the whole tensors:
    `spread` counts of tensors split over the batch group and tp (each
    rank counts its own elements), `replicated` of weights whole over the
    batch group (counted once: from its rank 0)."""
    lead = float(ctx.batch_rank == 0)
    v = torch.stack(list(spread) + [s * lead for s in replicated])
    for axis in ("batch", "tp"):
        collectives.all_reduce(v, ctx, axis)
    return v


def _ag_mm_fp8_body(ctx, op, out_dtype, xl, wls, invs):
    """fp8 twin of _ag_mm_body: e4m3 x chunks ring around; each GEMM is
    fp8_gemm with its projection's descale inv_j = 1/(s_x · s_w_j)."""
    gemm = fp8lib.fp8_gemm
    tp, me = ctx.tp, ctx.tp_rank
    b, sc, h = xl.shape
    ys = [torch.empty((b, sc * tp, wl.shape[1]), dtype=out_dtype,
                      device=xl.device) for wl in wls]
    chunk = xl
    for step in range(tp):
        hop = _issue(ctx, chunk, op=op, step=step) if step + 1 < tp \
            else None
        owner = (me + step) % tp
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "B", op=op, step=step)
        c2 = chunk.reshape(b * sc, h)
        for j, wl in enumerate(wls):
            ys[j][:, owner * sc:(owner + 1) * sc] = gemm(
                c2, wl, invs[j]).to(out_dtype).view(b, sc, -1)
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "E", op=op, step=step)
        if hop is not None:
            chunk = _land(ctx, hop, op=op, step=step)
    return tuple(ys)


def _mm_rs_fp8_rings(ctx, out_dtype, yls, wls, invs,
                     op="matmul-reduce-scatter-fp8"):
    """fp8 twin of _mm_rs_rings: each chunk's products descale with their
    own inv_j before their fp32 sum; the running partial sum hops in
    out_dtype (the bf16 ring's bytes)."""
    gemm = fp8lib.fp8_gemm
    tp, me = ctx.tp, ctx.tp_rank
    b, s, _ = yls[0].shape
    sc = s // tp

    def piece(c, step):
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "B", op=op, step=step)
        out = None
        for yl, wl, inv in zip(yls, wls, invs):
            yc = yl[:, c * sc:(c + 1) * sc].reshape(b * sc, -1)
            t = gemm(yc, wl, inv)
            out = t if out is None else out + t
        out = out.to(out_dtype).view(b, sc, -1)
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "E", op=op, step=step)
        return out

    acc = piece((me + 1) % tp, 0)
    for step in range(1, tp):
        hop = _issue(ctx, acc, op=op, step=step)
        nxt = piece((me + 1 + step) % tp, step)
        moving = _land(ctx, hop, op=op, step=step)
        acc = moving + nxt
    return acc


def _ag_mm_fp8_bwd_body(ctx, out_dtype, w_dtypes, xl, wls, dyls, inv_dws,
                        inv_dxs):
    """Fused fp8 backward ring of all_gather_matmul: one ring of the e4m3
    x chunks accumulates every wgrad (descale inv_dw_j = 1/(s_x s_g_j));
    the dgrad is the fp8 reduce-scatter of the quantized cotangents
    against the transposed e4m3 weights (inv_dx_j = 1/(s_g_j s_w_j))."""
    gemm = fp8lib.fp8_gemm
    tp, me = ctx.tp, ctx.tp_rank
    b, sc, h = xl.shape
    op = "all-gather-matmul-fp8-bwd"
    dws = [torch.zeros((h, wl.shape[1]), dtype=torch.float32,
                       device=xl.device) for wl in wls]
    chunk = xl
    for step in range(tp):
        hop = _issue(ctx, chunk, op=op, step=step) if step + 1 < tp \
            else None
        owner = (me + step) % tp
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "B", op=op, step=step)
        c2t = chunk.reshape(b * sc, h).T
        for j, (wl, dyl) in enumerate(zip(wls, dyls)):
            dyc = dyl[:, owner * sc:(owner + 1) * sc].reshape(
                b * sc, wl.shape[1])
            dws[j] = dws[j] + gemm(c2t, dyc, inv_dws[j])
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "E", op=op, step=step)
        if hop is not None:
            chunk = _land(ctx, hop, op=op, step=step)
    dx = _mm_rs_fp8_rings(ctx, out_dtype, dyls, tuple(wl.T for wl in wls),
                          inv_dxs, op=op)
    return dx, tuple(dw.to(dt) for dw, dt in zip(dws, w_dtypes))


def _mm_rs_fp8_bwd_body(ctx, y_dtype, w_dtype, yl, wl, dol, inv_dy,
                        inv_dw):
    """Fused fp8 backward ring of matmul_reduce_scatter: one ring of the
    e4m3 cotangent chunks feeds the dgrad (dy = (do @ w^T) / (s_do s_w))
    and the wgrad (dw = sum_c y_c^T @ do_c / (s_y s_do))."""
    gemm = fp8lib.fp8_gemm
    tp, me = ctx.tp, ctx.tp_rank
    b, sc, h = dol.shape
    nl = wl.shape[0]
    op = "matmul-reduce-scatter-fp8-bwd"
    dy = torch.empty((b, sc * tp, nl), dtype=y_dtype, device=dol.device)
    dw = torch.zeros((nl, h), dtype=torch.float32, device=dol.device)
    wt = wl.T
    chunk = dol
    for step in range(tp):
        hop = _issue(ctx, chunk, op=op, step=step) if step + 1 < tp \
            else None
        owner = (me + step) % tp
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "B", op=op, step=step)
        c2 = chunk.reshape(b * sc, h)
        dyc = gemm(c2, wt, inv_dy).to(y_dtype).view(b, sc, nl)
        yc = yl[:, owner * sc:(owner + 1) * sc].reshape(b * sc, nl)
        pm = gemm(yc.T, c2, inv_dw)
        _mark(ctx, OVERLAP_COMPUTE_EVENT, "E", op=op, step=step)
        dy[:, owner * sc:(owner + 1) * sc] = dyc
        dw = dw + pm
        if hop is not None:
            chunk = _land(ctx, hop, op=op, step=step)
    return dy, dw.to(w_dtype)


class _AgMmFp8(torch.autograd.Function):
    """all_gather_matmul's fp8 twin. The site's history [1 + 2n, H]
    gives the scales; x, every w_j (forward) and every cotangent
    (backward) are quantized with global amaxes and saturation counts
    (x's and the cotangents' over the batch group and tp: each rank
    quantizes its own elements; a weight's over tp), and the rolled
    history goes to the site's step (training/fp8.py Fp8Step)."""

    @staticmethod
    def forward(fctx, ctx, site, xl, *ws):
        n = len(ws)
        out_dtype = torch.promote_types(xl.dtype, ws[0].dtype)
        for w in ws[1:]:
            out_dtype = torch.promote_types(out_dtype, w.dtype)
        scales = fp8lib.fp8_scale_from_hist(site.hist, site.margin)
        xq, ax, sx = fp8lib.fp8_quantize(xl, scales[0])
        quant = [fp8lib.fp8_quantize(w, scales[1 + j])
                 for j, w in enumerate(ws)]
        wqs = tuple(q for q, _, _ in quant)
        amax = _global_amax(ctx, torch.stack([ax] + [a for _, a, _ in
                                                     quant]))
        sats = _global_sats(ctx, [sx], [s for _, _, s in quant])
        invs = [1.0 / (scales[0] * scales[1 + j]) for j in range(n)]
        fctx.mesh, fctx.site = ctx, site
        fctx.dtypes = (xl.dtype, out_dtype, tuple(w.dtype for w in ws))
        fctx.save_for_backward(xq, scales, amax, sats, *wqs)
        return _ag_mm_fp8_body(ctx, "all-gather-matmul-fp8", out_dtype, xq,
                               wqs, invs)

    @staticmethod
    def backward(fctx, *dys):
        ctx, site = fctx.mesh, fctx.site
        xq, scales, amax, sats, *wqs = fctx.saved_tensors
        x_dtype, out_dtype, w_dtypes = fctx.dtypes
        n = len(wqs)
        quant = [fp8lib.fp8_quantize(dy, scales[1 + n + j])
                 for j, dy in enumerate(dys)]
        ags = _global_amax(ctx, torch.stack([a for _, a, _ in quant]))
        sgs = _global_sats(ctx, [s for _, _, s in quant], [])
        inv_dws = [1.0 / (scales[0] * scales[1 + n + j]) for j in range(n)]
        inv_dxs = [1.0 / (scales[1 + n + j] * scales[1 + j])
                   for j in range(n)]
        dx, dws = _ag_mm_fp8_bwd_body(
            ctx, out_dtype, w_dtypes, xq, wqs,
            tuple(q for q, _, _ in quant), inv_dws, inv_dxs)
        site.observe(fp8lib.rolled_hist(site.hist, torch.cat([amax, ags])),
                     torch.cat([sats, sgs]))
        return (None, None, dx.to(x_dtype), *dws)


class _MmRsFp8(torch.autograd.Function):
    """matmul_reduce_scatter's fp8 twin (history [3, H]: input, weight,
    cotangent; the amaxes as in _AgMmFp8, y's over the batch group and
    tp, the weight's over tp, the cotangent chunk's over both)."""

    @staticmethod
    def forward(fctx, ctx, site, yl, wl):
        out_dtype = torch.promote_types(yl.dtype, wl.dtype)
        scales = fp8lib.fp8_scale_from_hist(site.hist, site.margin)
        yq, ay, sy = fp8lib.fp8_quantize(yl, scales[0])
        wq, aw, sw = fp8lib.fp8_quantize(wl, scales[1])
        amax = _global_amax(ctx, torch.stack([ay, aw]))
        sats = _global_sats(ctx, [sy], [sw])
        inv = 1.0 / (scales[0] * scales[1])
        fctx.mesh, fctx.site = ctx, site
        fctx.dtypes = (yl.dtype, wl.dtype)
        fctx.save_for_backward(yq, wq, scales, amax, sats)
        return _mm_rs_fp8_rings(ctx, out_dtype, (yq,), (wq,), (inv,))

    @staticmethod
    def backward(fctx, dout):
        ctx, site = fctx.mesh, fctx.site
        yq, wq, scales, amax, sats = fctx.saved_tensors
        y_dtype, w_dtype = fctx.dtypes
        doq, ag, sg = fp8lib.fp8_quantize(dout, scales[2])
        ag = _global_amax(ctx, ag.reshape(1))
        sg = _global_sats(ctx, [sg], [])
        inv_dy = 1.0 / (scales[2] * scales[1])
        inv_dw = 1.0 / (scales[0] * scales[2])
        dy, dw = _mm_rs_fp8_bwd_body(ctx, y_dtype, w_dtype, yq, wq,
                                     doq.contiguous(), inv_dy, inv_dw)
        site.observe(fp8lib.rolled_hist(site.hist, torch.cat([amax, ag])),
                     torch.cat([sats, sg]))
        return None, None, dy, dw


# ---------------------------------------------------------------------------
# The sequence layout around the rings (module docstring).
# ---------------------------------------------------------------------------

class _SeqChunk(torch.autograd.Function):
    """This tp rank's sequence chunk of a tp-replicated [B, S, ...]
    tensor; the backward all-gathers the chunks' grads over tp."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.mesh = ctx
        sc = x.shape[1] // ctx.tp
        return x[:, ctx.tp_rank * sc:(ctx.tp_rank + 1) * sc].contiguous()

    @staticmethod
    def backward(fctx, g):
        return collectives.all_gather_cat(g.contiguous(), fctx.mesh, "tp",
                                          1), None


class _SeqGather(torch.autograd.Function):
    """Every tp rank's sequence chunk concatenated (the whole [B, S, ...]
    on every rank); the backward keeps this rank's chunk of the grad."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.mesh, fctx.sc = ctx, x.shape[1]
        return collectives.all_gather_cat(x, ctx, "tp", 1)

    @staticmethod
    def backward(fctx, g):
        r, sc = fctx.mesh.tp_rank, fctx.sc
        return g[:, r * sc:(r + 1) * sc].contiguous(), None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def tp_columns(w: torch.Tensor, ctx) -> torch.Tensor:
    """Rank ctx.tp_rank's contiguous column block of a whole [H, N] weight
    (JAX's P(None, tp) in_spec); N that tp does not divide raises JAX's
    words."""
    n = w.shape[-1]
    if n % ctx.tp:
        raise ValueError(
            f"all_gather_matmul: output dim {n} not divisible by "
            f"tp={ctx.tp} (gate callers on tp_overlap_eligible)")
    k = n // ctx.tp
    return w[..., ctx.tp_rank * k:(ctx.tp_rank + 1) * k].contiguous()


def tp_rows(w: torch.Tensor, ctx) -> torch.Tensor:
    """Rank ctx.tp_rank's contiguous row block of a whole [N, H] weight
    (JAX's P(tp, None)); N that tp does not divide raises JAX's words."""
    n = w.shape[0]
    if n % ctx.tp:
        raise ValueError(
            f"matmul_reduce_scatter: inner dim {n} must match w rows "
            f"{n} and divide by tp={ctx.tp}")
    k = n // ctx.tp
    return w[ctx.tp_rank * k:(ctx.tp_rank + 1) * k].contiguous()


def all_gather_matmul(x: torch.Tensor, w, ctx, fp8=None):
    """The column-parallel x @ w over the tp ring.

    x: [B, S, H], tp-replicated (this rank's batch rows); w: this rank's
    column shard [H, N/tp] of a weight, or a tuple of them sharing ONE
    ring of x (fused QKV: the outputs come back as a tuple). Returns y
    [B, S, N/tp] per weight. S that tp does not divide is zero-padded
    outside the Function. fp8: the site (training/fp8.py Fp8Site) whose
    e4m3 twin runs. The wgrads are this rank's batch rows' own (module
    docstring)."""
    fused = isinstance(w, (tuple, list))
    ws = tuple(w) if fused else (w,)
    for wj in ws:
        if wj.shape[0] != x.shape[-1]:
            raise ValueError(f"all_gather_matmul: x's last dim "
                             f"{x.shape[-1]} does not match w rows "
                             f"{wj.shape[0]}")
    s = x.shape[1]
    sp = _round_up(s, ctx.tp)
    if sp != s:
        x = F.pad(x, (0, 0, 0, sp - s))
    xl = _SeqChunk.apply(x, ctx)
    if fp8 is not None:
        ys = _AgMmFp8.apply(ctx, fp8, xl, *ws)
    else:
        ys = _AgMm.apply(ctx, xl, *ws)
    if sp != s:
        ys = tuple(y[:, :s] for y in ys)
    return ys if fused else ys[0]


def matmul_reduce_scatter(y: torch.Tensor, w: torch.Tensor, ctx, fp8=None
                          ) -> torch.Tensor:
    """The row-parallel y @ w over the tp ring.

    y: [B, S, N/tp] (this rank's inner shard, the whole sequence); w:
    this rank's row shard [N/tp, H]. The ring leaves each rank its reduced
    sequence chunk; the chunks are then all-gathered over tp, so the
    result is the whole [B, S, H] on every rank (module docstring). fp8:
    as all_gather_matmul's."""
    if y.shape[-1] != w.shape[0]:
        raise ValueError(
            f"matmul_reduce_scatter: inner dim {y.shape[-1]} must match w "
            f"rows {w.shape[0]}")
    s = y.shape[1]
    sp = _round_up(s, ctx.tp)
    if sp != s:
        y = F.pad(y, (0, 0, 0, sp - s))
    if fp8 is not None:
        out = _MmRsFp8.apply(ctx, fp8, y, w)
    else:
        out = _MmRs.apply(ctx, y, w)
    out = _SeqGather.apply(out, ctx)
    return out[:, :s] if sp != s else out


def ring_all_gather(x: torch.Tensor, ctx, axis: str, dim: int = 0,
                    op_name: str = "ring-allgather",
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's x of `axis` concatenated along `dim` in rank order
    (the layout of an all-gather) by n − 1 ring hops, each issued before
    the chunk it carries lands in the result; 'dp-overlap-permute' spans
    with the hop's bytes on the timeline of the axis rank + 1. out: where
    to write it (the whole buffer), else a new tensor."""
    group = collectives._axis(ctx, collectives._axis_name(ctx, axis))[1]
    n = len(group)
    me = group.index(ctx.rank)
    shape = list(x.shape)
    length = shape[dim]
    shape[dim] = length * n
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    tracer = get_tracer()
    chunk = x
    for step in range(n):
        hop = None
        if step + 1 < n:
            tracer.phase_event(DP_OVERLAP_PERMUTE_EVENT, "B", tid=me + 1,
                               op=op_name, rank=me, step=step,
                               data=_nbytes(chunk))
            hop = collectives.axis_ring_hop(ctx, [chunk], axis)
        owner = (me + step) % n
        out.narrow(dim, owner * length, length).copy_(chunk)
        if hop is not None:
            chunk = hop.wait()[0]
            tracer.phase_event(DP_OVERLAP_PERMUTE_EVENT, "E", tid=me + 1,
                               op=op_name, rank=me, step=step,
                               data=_nbytes(chunk))
    return out


def tp_overlap_ineligible_reason(cfg, ctx, *tp_dims, batch=None
                                 ) -> Optional[str]:
    """Why the rings may NOT replace the column/row tp layers here (None
    when they may): JAX's predicates of tp_overlap_eligible, by name.
    tp_dims: every weight dim the projection pair splits over tp; batch:
    the global batch dim, which the rings split over dp × ep."""
    if not getattr(cfg, "tp_comm_overlap", False):
        return "tp_comm_overlap off"
    if ctx is None:
        return "no mesh context (ctx is None)"
    if getattr(ctx, "fbd_role", None) is not None:
        return "FBD half-mesh (the rings are not run on MegaFBD's halves)"
    if ctx.tp <= 1:
        return f"tp == {ctx.tp} (nothing to overlap)"
    if ctx.cp > 1:
        return f"cp == {ctx.cp} > 1 (the sequence is already split over cp)"
    if batch is not None and batch % (ctx.dp * ctx.ep) != 0:
        return (f"batch {batch} % (dp*ep) ({ctx.dp * ctx.ep}) != 0")
    for d in tp_dims:
        if d % ctx.tp:
            return f"dim {d} % tp ({ctx.tp}) != 0"
    return None


def tp_overlap_eligible(cfg, ctx, *tp_dims, batch=None) -> bool:
    """Whether the rings may replace the column/row tp layers here (JAX's
    predicates: the flag on, a grid with tp > 1, cp 1, not a MegaFBD half,
    the batch split over dp × ep and every dim over tp)."""
    return tp_overlap_ineligible_reason(cfg, ctx, *tp_dims,
                                        batch=batch) is None


def overlap_or_log(cfg, ctx, *tp_dims, batch=None) -> bool:
    """tp_overlap_eligible for a layer: with the flag on and the rings
    ineligible, the failed predicate is logged (once a reason)."""
    reason = tp_overlap_ineligible_reason(cfg, ctx, *tp_dims, batch=batch)
    if reason is None:
        return True
    if getattr(cfg, "tp_comm_overlap", False) and reason not in _LOGGED:
        _LOGGED.add(reason)
        _log.warning("tp_comm_overlap: the column/row tp layers run here "
                     "(%s)", reason)
    return False

