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

from typing import Optional, Tuple

import torch

from megatronapp_tpu_torch.ops.cuda.paged_attention import (
    QUANT_DTYPES, paged_attention, paged_attention_plain, storage_view,
)
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


def write_kv(kv_cache, kv_scales, k, v, index: WriteIndex):
    """Write new K/V rows [B, s, Hkv, D] into a layer's pools at `index`:
    as they are for compute-dtype pools (kv_scales None), else quantized
    to the pools' dtype with their scales written to the scale pools
    through the same index (the JAX attention's kv_scales branch)."""
    ck, cv = kv_cache
    if kv_scales is None:
        write_rows(ck, k, index)
        write_rows(cv, v, index)
        return
    for pages, scales, vals in ((ck, kv_scales[0], k), (cv, kv_scales[1], v)):
        qv, sc = quantize_kv_rows(vals, pages.dtype)
        write_rows(pages, qv, index)
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
