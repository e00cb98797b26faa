"""Paged-attention entry points and page write helpers (the JAX package's
ops/pallas/paged_attention.py for bf16 pools).

The decode cache lives in a shared block pool [num_blocks, block_size,
Hkv, D]; each slot owns an ordered page table of block ids, and attention
reads K/V through the table (ops/cuda/paged_attention.py holds the
kernel). The write helpers scatter new K/V rows to (block, offset) pairs
IN PLACE — the JAX engine donates the pools to its step jit instead.
Inactive slots and padding rows are DROPPED, never clamped: torch has no
``mode="drop"``, so their rows are masked out before ``index_put_`` —
clamping would write onto live block nb-1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from megatronapp_tpu_torch.ops.cuda.paged_attention import (
    paged_attention, paged_attention_plain,
)


def paged_attention_decode(q, k_pages, v_pages, page_table, kv_lens,
                           softmax_scale: Optional[float] = None):
    """One query row per slot: q [B, Hq, D], kv_lens [B] (>= 1).
    Returns [B, Hq, D]."""
    return paged_attention(q, k_pages, v_pages, page_table, kv_lens,
                           softmax_scale=softmax_scale)


def paged_attention_multiquery(q, k_pages, v_pages, page_table, kv_lens,
                               q_lens, softmax_scale: Optional[float] = None):
    """Ragged multi-query (chunked prefill): q [B, S_q, Hq, D]; the first
    q_lens[b] rows of slot b are real queries at absolute positions
    kv_lens[b]-q_lens[b] .. kv_lens[b]-1 (their K/V already written); the
    rest are padding. Returns [B, S_q, Hq, D]."""
    return paged_attention(q, k_pages, v_pages, page_table, kv_lens,
                           q_lens=q_lens, softmax_scale=softmax_scale)


def paged_attention_reference(q, k_pages, v_pages, page_table, kv_lens,
                              softmax_scale: Optional[float] = None):
    """Dense-gather oracle for the decode mode (the kernel's plain
    version)."""
    return paged_attention_plain(q, k_pages, v_pages, page_table, kv_lens,
                                 softmax_scale=softmax_scale)


def paged_attention_multiquery_reference(q, k_pages, v_pages, page_table,
                                         kv_lens, q_lens,
                                         softmax_scale: Optional[float] = None):
    """Dense-gather oracle for the ragged mode (the kernel's plain
    version)."""
    return paged_attention_plain(q, k_pages, v_pages, page_table, kv_lens,
                                 q_lens=q_lens, softmax_scale=softmax_scale)


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
    `paged_write_index` (rows outside the index are dropped)."""
    rows, blocks, offsets = index
    flat = vals.reshape((-1,) + tuple(vals.shape[2:]))
    pages.index_put_((blocks, offsets), flat[rows].to(pages.dtype))
    return pages


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
