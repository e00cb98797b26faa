"""Paged-attention entry points, page write helpers and KV quantization
(the JAX package's ops/pallas/paged_attention.py, with the quantized
storage registry of ops/pallas/kernel_gen.py:88-122: int8 and fp8 pools).

The decode cache lives in a shared block pool [num_blocks, block_size,
Hkv, D]; each slot owns an ordered page table of block ids, and attention
reads K/V through the table (ops/cuda/paged_attention.py holds the
kernel). An MLA layer's pool pair is (latent [NB, bs, klat], roped key
[NB, bs, dpe]) with per-row scale pools [NB, bs], attended in latent
space by ``paged_attention_latent`` (ops/cuda/paged_latent.py); the write
helpers below take those rows as they are, since they quantize and
scatter over the trailing dim. Pools are in the compute dtype, or
quantized (int8 or fp8 e4m3) with per-(row, kv-head) fp32 scale pools
[num_blocks, block_size, Hkv] beside them: ``quantize_kv_rows`` quantizes
new rows as they are written and the kernel dequantizes each page as it
reads it. The write helpers
scatter new K/V rows (and scales) to (block, offset) pairs IN PLACE — the
JAX engine donates the pools to its step jit instead. Inactive slots and
padding rows are DROPPED, never clamped: torch has no ``mode="drop"``, so
their rows are masked out before ``index_put_`` — clamping would write
onto live block nb-1. fp8 pools are written through a uint8 view of the
same bytes (indexing is not implemented for fp8 everywhere).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from megatronapp_tpu_torch.ops.cuda.latent_tp import (
    latent_block_scores, latent_block_wsum,
)
from megatronapp_tpu_torch.ops.cuda.paged_attention import (
    NEG_INF, QUANT_DTYPES, paged_attention, paged_attention_plain,
    storage_view,
)
from megatronapp_tpu_torch.parallel.collectives import all_gather_heads, psum
# The latent dispatcher and dequantizer, re-exported beside the GQA ones.
from megatronapp_tpu_torch.ops.cuda.paged_latent import (  # noqa: F401
    dequantize_latent_pages, paged_attention_latent,
    paged_attention_latent_plain,
)


def quant_dtype_of(pages_dtype: torch.dtype) -> Optional[str]:
    """The registry name of a pool's storage dtype (None: an unquantized
    compute-dtype pool)."""
    for name, (dt, _) in QUANT_DTYPES.items():
        if pages_dtype == dt:
            return name
    return None


def quant_qmax_of(pages_dtype: torch.dtype) -> float:
    """Symmetric quantization range bound of a registered quantized page
    dtype (127 int8, 448 e4m3)."""
    name = quant_dtype_of(pages_dtype)
    if name is None:
        raise ValueError(
            f"{pages_dtype} is not a registered quantized KV storage "
            f"dtype ({sorted(QUANT_DTYPES)})")
    return QUANT_DTYPES[name][1]


def quantize_kv_rows(rows: torch.Tensor, dtype: torch.dtype = torch.int8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(row, head) quantization of KV rows: rows [..., Hkv,
    D] → (quantized rows [..., Hkv, D] in `dtype`, fp32 scales [...,
    Hkv]). Each (token, head) row quantizes on its own over D, so inserts
    never re-scale written rows. int8: scale = max(absmax / 127, 1e-12),
    round half to even, clip to ±127. fp8 (e4m3fn): scale = max(absmax /
    448, 1e-12), clip to ±448 (e4m3 overflow is NaN, not inf), then the
    cast rounds (no integer rounding step)."""
    qmax = quant_qmax_of(dtype)
    r32 = rows.float()
    scales = torch.clamp_min(r32.abs().amax(dim=-1) / qmax, 1e-12)
    q = r32 / scales[..., None]
    if dtype == torch.int8:
        q = torch.round(q)
    return q.clamp(-qmax, qmax).to(dtype), scales


def paged_attention_decode(q, k_pages, v_pages, page_table, kv_lens,
                           softmax_scale: Optional[float] = None,
                           k_scales=None, v_scales=None):
    """One query row per slot: q [B, Hq, D], kv_lens [B] (>= 1); scale
    pools [NB, bs, Hkv] mark quantized pools. Returns [B, Hq, D]."""
    return paged_attention(q, k_pages, v_pages, page_table, kv_lens,
                           softmax_scale=softmax_scale, k_scales=k_scales,
                           v_scales=v_scales)


def paged_attention_multiquery(q, k_pages, v_pages, page_table, kv_lens,
                               q_lens, softmax_scale: Optional[float] = None,
                               k_scales=None, v_scales=None):
    """Ragged multi-query (chunked prefill): q [B, S_q, Hq, D]; the first
    q_lens[b] rows of slot b are real queries at absolute positions
    kv_lens[b]-q_lens[b] .. kv_lens[b]-1 (their K/V already written); the
    rest are padding. Returns [B, S_q, Hq, D]."""
    return paged_attention(q, k_pages, v_pages, page_table, kv_lens,
                           q_lens=q_lens, softmax_scale=softmax_scale,
                           k_scales=k_scales, v_scales=v_scales)


def paged_attention_decode_tp(q, k_pages, v_pages, page_table, kv_lens, ctx,
                              softmax_scale: Optional[float] = None,
                              k_scales=None, v_scales=None):
    """``paged_attention_decode`` head-sharded over ctx's tp ranks (JAX
    kernel_gen._tp_place): q [B, Hq/tp, D] holds this rank's contiguous
    heads and the pools [NB, bs, Hkv/tp, D] (and scale pools) its kv heads,
    so the unmodified kernel runs on the rank's matched GQA groups; the
    heads are then gathered. Returns [B, Hq, D], the same on every rank."""
    out = paged_attention_decode(q, k_pages, v_pages, page_table, kv_lens,
                                 softmax_scale=softmax_scale,
                                 k_scales=k_scales, v_scales=v_scales)
    return all_gather_heads(out, ctx, dim=1)


def paged_attention_multiquery_tp(q, k_pages, v_pages, page_table, kv_lens,
                                  q_lens, ctx,
                                  softmax_scale: Optional[float] = None,
                                  k_scales=None, v_scales=None):
    """``paged_attention_multiquery`` head-sharded over ctx's tp ranks:
    q [B, S_q, Hq/tp, D], pools as for ``paged_attention_decode_tp``.
    Returns [B, S_q, Hq, D], the same on every rank."""
    out = paged_attention_multiquery(q, k_pages, v_pages, page_table,
                                     kv_lens, q_lens,
                                     softmax_scale=softmax_scale,
                                     k_scales=k_scales, v_scales=v_scales)
    return all_gather_heads(out, ctx, dim=2)


def _latent_tp_body(q_lat_shards, q_pe, lat_shards, pe_pages, page_table,
                    kv_lens, w_v_shards, q_lens, softmax_scale, lat_scales,
                    pe_scales, reduce):
    """JAX kernel_gen._tp_place_latent's body over latent-column shards:
    each shard's absorbed query q_lat [B(, S_q), nq, klat/tp], latent pages
    [NB, bs, klat/tp] and w_v rows [klat/tp, nq, dv]; `reduce` sums a list
    of per-shard partials over the shards (one partial a rank and an
    all-reduce, or every shard in one process). The page table is cut to
    the blocks the longest kv_len reaches (one read of kv_lens on the
    host)."""
    ragged = q_lens is not None
    q0 = q_lat_shards[0]
    b, nq = q0.shape[0], q0.shape[-2]
    s_q = q0.shape[1] if ragged else 1
    rows = s_q * nq
    dv = w_v_shards[0].shape[-1]
    bs = pe_pages.shape[1]
    # Only the blocks that some row can reach: the blocks past every
    # kv_len score 0 on every shard, are masked and weigh nothing, so
    # cutting them from the table leaves the function as it is and shrinks
    # both phases and the all-reduced scores to the longest context.
    reach = max(1, -(-int(kv_lens.max()) // bs))
    page_table = page_table[:, :reach].contiguous()
    mb = page_table.shape[1]
    dev = q0.device
    # fp32 rows with the softmax scale applied up front (every shard's
    # partial carries it).
    scores = reduce([latent_block_scores(
        (ql.float() * softmax_scale).reshape(b, rows, -1).contiguous(), lat,
        page_table, kv_lens, lat_scales)
        for ql, lat in zip(q_lat_shards, lat_shards)])
    # The pe scores are the same on every shard: no reduction.
    qpf = (q_pe.float() * softmax_scale).reshape(b, rows, -1).contiguous()
    s = scores + latent_block_scores(qpf, pe_pages, page_table, kv_lens,
                                     pe_scales)
    pos = torch.arange(mb * bs, device=dev)[None, None, :]
    lens = kv_lens.long()[:, None, None]
    if ragged:
        row_q = (torch.arange(rows, device=dev) // nq)[None, :, None]
        abs_q = lens - q_lens.long()[:, None, None] + row_q
    else:
        abs_q = lens - 1
    valid = (pos <= abs_q) & (pos < lens)
    s = torch.where(valid, s, torch.full((), NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.exp(s - torch.clamp_min(m, NEG_INF / 2))
    pr = torch.where(valid, pr, torch.zeros((), device=dev))
    pr = pr / torch.clamp_min(pr.sum(dim=-1, keepdim=True), 1e-20)
    out = reduce([latent_block_wsum(pr, lat, page_table, kv_lens, wv,
                                    lat_scales)
                  for lat, wv in zip(lat_shards, w_v_shards)])
    out = out.to(q0.dtype)
    return (out.reshape(b, s_q, nq, dv) if ragged
            else out.reshape(b, nq, dv))


def paged_attention_latent_tp(q_lat, q_pe, lat_pages, pe_pages, page_table,
                              kv_lens, w_v, ctx, q_lens=None,
                              softmax_scale: Optional[float] = None,
                              lat_scales=None, pe_scales=None):
    """MLA latent paged attention on one rank of a latent-column-sharded tp
    group (JAX kernel_gen._tp_place_latent): q_lat [B(, S_q), nq, klat/tp]
    is this rank's columns of the absorbed query, lat_pages [NB, bs,
    klat/tp] its columns of the latent pool and w_v [klat/tp, nq, dv] its
    rows of kv_up's v columns; q_pe, the pe pool, the per-row scale pools
    (the WHOLE row's scale), the table and the lengths are replicated.
    Phase 1 (``latent_block_scores``) on the rank's columns, an
    all-reduce, plus phase 1 on the pe pool; the mask and an fp32 softmax
    on every rank; phase 2 (``latent_block_wsum``), an all-reduce; cast to
    q_lat's dtype. Returns [B(, S_q), nq, dv], the same on every rank."""
    if softmax_scale is None:
        raise ValueError("paged_attention_latent_tp requires softmax_scale")
    return _latent_tp_body([q_lat], q_pe, [lat_pages], pe_pages, page_table,
                           kv_lens, [w_v], q_lens, softmax_scale, lat_scales,
                           pe_scales, lambda xs: psum(xs[0], ctx))


def paged_attention_latent_shards(q_lat, q_pe, lat_pages, pe_pages,
                                  page_table, kv_lens, w_v, tp: int,
                                  q_lens=None,
                                  softmax_scale: Optional[float] = None,
                                  lat_scales=None, pe_scales=None):
    """The tp body with all `tp` column shards in one process: the whole
    q_lat [.., klat], pools and w_v [klat, nq, dv] are cut into tp
    contiguous column shards (views), each phase runs shard by shard and
    the partials are summed in rank order, as the all-reduce sums them.
    Holds the tp composition against the single-device latent kernel."""
    if softmax_scale is None:
        raise ValueError("paged_attention_latent_shards requires "
                         "softmax_scale")
    klat = lat_pages.shape[-1]
    if klat % tp:
        raise ValueError(f"kv_lora_rank {klat} does not split over tp {tp}")
    k = klat // tp
    cols = [slice(r * k, (r + 1) * k) for r in range(tp)]
    return _latent_tp_body(
        [q_lat[..., c] for c in cols], q_pe, [lat_pages[..., c] for c in cols],
        pe_pages, page_table, kv_lens, [w_v[c] for c in cols], q_lens,
        softmax_scale, lat_scales, pe_scales,
        lambda xs: functools.reduce(torch.add, xs))


def tp_paged_ineligible_reason(cfg, ctx) -> Optional[str]:
    """Why the paged kernels may NOT run sharded on ctx's tp ranks — None
    when eligible, otherwise the FIRST failed predicate by name (JAX
    ops/pallas/paged_attention.py:400, with its messages). Standard
    layout: both head counts divide by tp so each rank owns whole, matched
    GQA groups. MLA: the latent pool has no kv-head axis, so the shard axis
    is the latent COLUMN dim instead — eligibility is kv_lora_rank % tp."""
    if ctx is None:
        return "no mesh context (ctx is None)"
    if ctx.tp <= 1:
        return f"tp == {ctx.tp} (needs tp > 1 to shard)"
    if cfg.multi_latent_attention:
        if cfg.kv_lora_rank % ctx.tp:
            return (f"kv_lora_rank ({cfg.kv_lora_rank}) % tp ({ctx.tp}) "
                    f"!= 0 (the latent pool shards on latent columns)")
        return None
    if cfg.num_attention_heads % ctx.tp:
        return (f"num_attention_heads ({cfg.num_attention_heads}) % tp "
                f"({ctx.tp}) != 0")
    if cfg.num_query_groups % ctx.tp:
        return (f"num_query_groups ({cfg.num_query_groups}) % tp "
                f"({ctx.tp}) != 0 (shards must own whole GQA groups)")
    return None


def tp_paged_eligible(cfg, ctx) -> bool:
    """True when the paged kernels may run sharded on ctx's tp ranks (see
    tp_paged_ineligible_reason for the predicate list)."""
    return tp_paged_ineligible_reason(cfg, ctx) is None


def paged_attention_reference(q, k_pages, v_pages, page_table, kv_lens,
                              softmax_scale: Optional[float] = None,
                              k_scales=None, v_scales=None):
    """Dense-gather oracle for the decode mode (the kernel's plain
    version)."""
    return paged_attention_plain(q, k_pages, v_pages, page_table, kv_lens,
                                 softmax_scale=softmax_scale,
                                 k_scales=k_scales, v_scales=v_scales)


def paged_attention_multiquery_reference(q, k_pages, v_pages, page_table,
                                         kv_lens, q_lens,
                                         softmax_scale: Optional[float] = None,
                                         k_scales=None, v_scales=None):
    """Dense-gather oracle for the ragged mode (the kernel's plain
    version)."""
    return paged_attention_plain(q, k_pages, v_pages, page_table, kv_lens,
                                 q_lens=q_lens, softmax_scale=softmax_scale,
                                 k_scales=k_scales, v_scales=v_scales)


def paged_attention_latent_reference(q_lat, q_pe, lat_pages, pe_pages,
                                     page_table, kv_lens, w_v, q_lens=None,
                                     softmax_scale: Optional[float] = None,
                                     lat_scales=None, pe_scales=None):
    """Dense-gather oracle of the MLA latent kernel, decode and ragged
    modes (JAX ops/pallas/paged_attention.py:251; the kernel's plain
    version)."""
    return paged_attention_latent_plain(
        q_lat, q_pe, lat_pages, pe_pages, page_table, kv_lens, w_v, q_lens,
        softmax_scale, lat_scales, pe_scales)


WriteIndex = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def paged_write_index(page_table: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, active: torch.Tensor,
                      block_size: int, s: int) -> WriteIndex:
    """Where a ragged [B, s] run of new rows lands: row (b, i) goes to
    position starts[b] + i for i < counts[b] of active slots. Returns
    (rows, blocks, offsets) int64: the flat [B*s] indices of the rows
    kept, and their block ids and in-block offsets. Dropped rows are not
    in the index at all. Computed wherever the inputs lie — the engine
    passes host tensors so that building the index never waits on the
    card."""
    mb = page_table.shape[1]
    dev = page_table.device
    i = torch.arange(s, device=dev)
    pos = starts.to(dev).long()[:, None] + i[None, :]               # [B, s]
    blocks = page_table.long().gather(1, (pos // block_size).clamp(0, mb - 1))
    valid = (i[None, :] < counts.to(dev)[:, None]) \
        & active.to(dev).bool()[:, None]
    rows = valid.reshape(-1).nonzero().squeeze(1)
    return (rows, blocks.reshape(-1)[rows],
            (pos % block_size).reshape(-1)[rows])


def write_rows(pages: torch.Tensor, vals: torch.Tensor,
               index: WriteIndex) -> torch.Tensor:
    """Scatter vals [B, s, ...] into pages [NB, bs, ...] in place at a
    `paged_write_index` (rows outside the index are dropped). vals are
    cast to the pages' dtype; fp8 pools take the bytes through a uint8
    view."""
    rows, blocks, offsets = index
    flat = vals.reshape((-1,) + tuple(vals.shape[2:]))
    storage_view(pages).index_put_((blocks, offsets),
                                   storage_view(flat[rows].to(pages.dtype)))
    return pages


def scale_kwargs(kv_scales) -> dict:
    """The kernel's k_scales/v_scales keywords for a layer's scale pools
    (none for a compute-dtype pool)."""
    return {} if kv_scales is None else dict(zip(("k_scales", "v_scales"),
                                                 kv_scales))


def write_kv(kv_cache, kv_scales, k, v, index: WriteIndex,
             k_cols: Optional[slice] = None):
    """Write new K/V rows [B, s, Hkv, D] into a layer's pools at `index`:
    as they are for compute-dtype pools (kv_scales None), else quantized
    to the pools' dtype with their scales written to the scale pools
    through the same index (the JAX attention's kv_scales branch).
    k_cols: the trailing columns of k that the first pool holds (a tp
    rank's latent-column shard of an MLA pool): k is quantized over its
    WHOLE row first, so the scale written is the whole row's, as JAX's
    replicated scale pool holds it, and only then are the columns cut."""
    ck, cv = kv_cache
    cut = (lambda t: t) if k_cols is None else (lambda t: t[..., k_cols])
    if kv_scales is None:
        write_rows(ck, cut(k), index)
        write_rows(cv, v, index)
        return
    for pages, scales, vals, cols in ((ck, kv_scales[0], k, cut),
                                      (cv, kv_scales[1], v, None)):
        qv, sc = quantize_kv_rows(vals, pages.dtype)
        write_rows(pages, qv if cols is None else cols(qv), index)
        write_rows(scales, sc, index)


def append_chunk_pages(pages, vals, page_table, starts, counts, active):
    """Write a ragged multi-token run per slot in place: row b's token i
    lands at position starts[b] + i for i < counts[b]; padding rows and
    inactive slots are dropped. pages [NB, bs, ...]; vals [B, S, ...]."""
    idx = paged_write_index(page_table, starts, counts, active,
                            pages.shape[1], vals.shape[1])
    return write_rows(pages, vals, tuple(t.to(pages.device) for t in idx))


def append_token_pages(pages, vals, page_table, positions, active):
    """Write one decode token per slot at its own (block, offset), in
    place; inactive slots' writes are dropped. vals [B, ...]."""
    return append_chunk_pages(pages, vals[:, None], page_table, positions,
                              torch.ones_like(positions), active)
