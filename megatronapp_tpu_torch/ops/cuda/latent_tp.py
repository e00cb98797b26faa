"""The two phases of tensor-parallel MLA attention: the CUDA kernels'
wrappers, their plain versions, their launch counters, the weighted sum's
split plan and their build.

The kernels (csrc/latent_tp.cu) replace the TPU kernels
``megatronapp_tpu/ops/pallas/kernel_gen.py:_latent_block_scores`` (all
block scores of a latent-column shard, no softmax) and
``_latent_block_wsum`` (the probability-weighted value sum of a shard,
fp32 partials), for bf16 pools and for int8 / fp8 (e4m3) pools with one
fp32 scale per row. Both run their products on the tensor cores from
tiles staged by cp.async. Where the TPU body re-expands every tile's latent
through ``w_v`` before weighing it, the weighted sum (and its plain
version) sums P·latent in latent space and expands once: the same function
up to the order of the fp32 sums. The weighted sum is two launches: the
slot's tokens split over blocks by ``wsum_split_plan`` (from shapes alone),
each writing an fp32 partial to a workspace, then one block a (head, value
tile, 16 rows) that adds a row's splits in split order and expands through
``w_v``; a call counts once.

``latent_block_scores`` and ``latent_block_wsum`` take the plain versions
only for tensors that lie on the CPU. For CUDA tensors they launch the
kernel or raise: there is no fallback. Pages may be a column shard of a
whole pool (a view with unit column stride); ``w_v`` the strided view of
kv_up's v columns. The kernels build at first use through
``ops/cuda/build.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from megatronapp_tpu_torch.ops.cuda import build as kbuild
from megatronapp_tpu_torch.ops.cuda.paged_attention import storage_view

_PAGE_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
_SFX = ("", "_int8", "_fp8")

# Launches of each kernel, by page dtype. Incremented only where the
# wrapper launches it (never by the plain versions).
launches: Dict[str, int] = {f"{k}{sfx}": 0 for k in ("scores", "wsum")
                            for sfx in _SFX}

SOURCE = kbuild.source("latent_tp.cu")
# csrc/latent_tp.cu's constants: kMaxWidth; kWsumTK, the tokens of a ring
# stage of the split kernel; kWsumCols, the latent columns of a split
# block; LATENT_WSUM_ROW_TILES, its row tiles.
MAX_WIDTH = 768
WSUM_STAGE = 32
WSUM_COLS = 256
WSUM_ROW_TILES = (32, 64)
# The plan's most splits of a slot's tokens: the expansion adds a row's
# live splits one after another, and at decode 16 splits of 64 tokens beat
# 8 and 4 (flash_probe.py latent-splits; PERF.md).
MAX_SPLITS = 16
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SCORES_ARGTYPES = [_P] * 6 + [_I] * 5 + [_L] * 2 + [_I, _P]
_WSUM_ARGTYPES = [_P] * 8 + [_I] * 7 + [_L] * 4 + [_I] * 4 + [_P]


class WsumPlan(NamedTuple):
    row_tile: int        # rows a split block
    split_tokens: int    # tokens a split (a multiple of WSUM_STAGE)
    splits: int          # splits covering the table's tokens


def wsum_split_plan(batch: int, rows: int, tokens: int, dl: int,
                    sms: int) -> WsumPlan:
    """The weighted sum's split plan from the launch's shapes alone (never
    kv_lens, which lie on the device): the slot's rows in one tile of 32 at
    decode (at most 32 rows) or tiles of 64, and the table's tokens
    (MB·bs) split into whole 32-token stages so that the blocks (splits ×
    B × row tiles × 256-column blocks) come to about one wave of `sms`, each
    split at least one stage and at most MAX_SPLITS splits. Splits wholly
    past a slot's kv_len do nothing, and the expansion (the second launch)
    adds each row's live splits."""
    row_tile = WSUM_ROW_TILES[0] if rows <= WSUM_ROW_TILES[0] \
        else WSUM_ROW_TILES[1]
    units = batch * -(-rows // row_tile) * -(-dl // WSUM_COLS)
    stages = -(-tokens // WSUM_STAGE)
    want = max(1, min(stages, sms // units, MAX_SPLITS))
    per = -(-stages // want)
    return WsumPlan(row_tile, per * WSUM_STAGE, -(-stages // per))


def _gather_rows(pages: torch.Tensor, page_table: torch.Tensor,
                 scales: Optional[torch.Tensor]) -> torch.Tensor:
    """pages[table] as fp32 [B, MB*bs, d], dequantized with the row scales
    of a quantized pool."""
    b, mb = page_table.shape
    table = page_table.long()
    rows = storage_view(pages)[table].view(pages.dtype).float()
    if scales is not None:
        rows = rows * scales[table][..., None]
    return rows.reshape(b, mb * pages.shape[1], pages.shape[2])


def _block_valid(page_table: torch.Tensor, kv_lens: torch.Tensor,
                 bs: int) -> torch.Tensor:
    """[B, MB*bs] bool: the token's block j has j * bs < kv_len (every row
    of such a block is computed, stale tail rows included)."""
    mb = page_table.shape[1]
    j = torch.arange(mb * bs, device=page_table.device) // bs
    return j[None, :] * bs < kv_lens.to(page_table.device).long()[:, None]


def latent_block_scores_plain(q: torch.Tensor, pages: torch.Tensor,
                              page_table: torch.Tensor,
                              kv_lens: torch.Tensor,
                              scales: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of phase 1: q [B, rows, d] fp32 (scaled) ×
    pages [NB, bs, d] through page_table [B, MB] → [B, rows, MB*bs] fp32,
    no softmax; every token of a block j with j * bs >= kv_len is 0. bf16
    pages take q rounded to bf16; quantized pages (scales [NB, bs]) are
    dequantized to fp32 and take q in fp32 (kernel_gen.py:595-599)."""
    rows = _gather_rows(pages, page_table, scales)
    qf = q.float() if scales is not None else q.to(pages.dtype).float()
    s = torch.einsum("brd,btd->brt", qf, rows)
    valid = _block_valid(page_table, kv_lens, pages.shape[1])
    return torch.where(valid[:, None, :], s, torch.zeros((), device=s.device))


def latent_block_wsum_plain(p: torch.Tensor, pages: torch.Tensor,
                            page_table: torch.Tensor, kv_lens: torch.Tensor,
                            w_v: torch.Tensor,
                            scales: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of phase 2: p [B, rows, MB*bs] fp32 (masked
    probabilities) over the latent pages [NB, bs, dl] of the valid blocks
    (j * bs < kv_len), through w_v [dl, nq, dv] → [B, rows, dv] fp32,
    row r of head r mod nq. Sums u = p · latent in fp32, then expands
    u · w_v, as the kernel does."""
    b, r, _ = p.shape
    nq, dv = w_v.shape[1], w_v.shape[2]
    lat = _gather_rows(pages, page_table, scales)
    valid = _block_valid(page_table, kv_lens, pages.shape[1])
    zero = torch.zeros((), device=p.device)
    lat = torch.where(valid[..., None], lat, zero)
    u = torch.einsum("brt,btk->brk", torch.where(valid[:, None, :], p, zero),
                     lat)
    out = torch.einsum("bsnk,knd->bsnd", u.reshape(b, r // nq, nq, -1),
                       w_v.float())
    return out.reshape(b, r, dv)


def _check_pages(name, pages, scales, page_table, kv_lens, b, dev):
    if pages.device != dev or page_table.device != dev \
            or kv_lens.device != dev:
        raise ValueError(f"{name}: pages, page_table and kv_lens must lie on"
                         f" {dev}")
    kind = _PAGE_KIND.get(pages.dtype)
    if kind is None or (scales is not None) != (kind > 0):
        raise ValueError(f"{name}: pages {pages.dtype} with"
                         f"{'' if scales is not None else 'out'} scales; the "
                         "kernel takes bf16 pages without scales, or int8 / "
                         "fp8 (e4m3) pages with an fp32 scale pool")
    if pages.dim() != 3 or pages.stride(2) != 1:
        raise ValueError(f"{name}: pages must be [NB, bs, d] with unit stride"
                         f" along d, got {tuple(pages.shape)} strides "
                         f"{pages.stride()}")
    d, es = pages.shape[2], pages.element_size()
    if d % 16 or d > MAX_WIDTH or pages.data_ptr() % 16 \
            or (pages.stride(0) * es) % 16 or (pages.stride(1) * es) % 16:
        raise ValueError(f"{name}: page rows of {d} columns (a multiple of "
                         f"16, at most {MAX_WIDTH}) on 16-byte boundaries")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != tuple(pages.shape[:2])
                               or not scales.is_contiguous()
                               or scales.device != dev):
        raise ValueError(f"{name}: scales must be contiguous fp32 "
                         f"{tuple(pages.shape[:2])} on {dev}")
    for tname, t in (("page_table", page_table), ("kv_lens", kv_lens)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous int32")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(kv_lens.shape) != (b,):
        raise ValueError(f"{name}: page_table must be [B, MB] and kv_lens "
                         "[B]")
    return kind


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def latent_block_scores(q: torch.Tensor, pages: torch.Tensor,
                        page_table: torch.Tensor, kv_lens: torch.Tensor,
                        scales: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Phase 1 of the latent-column tp path (the kernel_gen.
    _latent_block_scores contract): q [B, rows, d] fp32, already scaled;
    pages [NB, bs, d] bf16, int8 or fp8 (scales [NB, bs] fp32 for the
    quantized ones); page_table [B, MB] and kv_lens [B] int32. Returns
    [B, rows, MB*bs] fp32 scores, no softmax, 0 for the blocks past
    kv_len. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if q.device.type == "cpu":
        return latent_block_scores_plain(q, pages, page_table, kv_lens,
                                         scales)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"latent_block_scores: tensors on {dev} — the kernel"
                         " takes CUDA tensors and the plain version CPU ones")
    if q.dtype != torch.float32 or q.dim() != 3 or not q.is_contiguous() \
            or q.data_ptr() % 16:
        raise ValueError("latent_block_scores: q must be contiguous fp32 "
                         f"[B, rows, d] on a 16-byte boundary, got {q.dtype} "
                         f"{tuple(q.shape)}")
    b, rows, d = q.shape
    kind = _check_pages("latent_block_scores", pages, scales, page_table,
                        kv_lens, b, dev)
    if pages.shape[2] != d:
        raise ValueError(f"latent_block_scores: q has {d} columns, pages "
                         f"{pages.shape[2]}")
    bs, mb = pages.shape[1], page_table.shape[1]
    out = torch.empty((b, rows, mb * bs), dtype=torch.float32, device=dev)
    fn = kbuild.load(SOURCE, "latent_scores_launch", _SCORES_ARGTYPES)
    rc = fn(q.data_ptr(), pages.data_ptr(),
            scales.data_ptr() if kind else None, page_table.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), b, rows, d, bs, mb,
            pages.stride(0), pages.stride(1), kind, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"latent_block_scores kernel launch failed: CUDA "
                           f"error {rc}")
    launches[f"scores{_SFX[kind]}"] += 1
    return out


def latent_block_wsum(p: torch.Tensor, pages: torch.Tensor,
                      page_table: torch.Tensor, kv_lens: torch.Tensor,
                      w_v: torch.Tensor,
                      scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 2 of the latent-column tp path (the kernel_gen.
    _latent_block_wsum contract): p [B, rows, MB*bs] fp32 masked
    probabilities; the shard's latent pages [NB, bs, dl] (scales as for
    ``latent_block_scores``); w_v [dl, nq, dv] bf16, any strides with unit
    stride along dv. Returns [B, rows, dv] fp32 partials, row r of head r
    mod nq. CPU tensors run the plain version; CUDA tensors launch the two
    kernels (``wsum_split_plan``) or raise."""
    if p.device.type == "cpu":
        return latent_block_wsum_plain(p, pages, page_table, kv_lens, w_v,
                                       scales)
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"latent_block_wsum: tensors on {dev} — the kernel "
                         "takes CUDA tensors and the plain version CPU ones")
    if p.dtype != torch.float32 or p.dim() != 3 or not p.is_contiguous() \
            or p.data_ptr() % 16:
        raise ValueError("latent_block_wsum: p must be contiguous fp32 [B, "
                         "rows, MB*bs] on a 16-byte boundary, got "
                         f"{p.dtype} {tuple(p.shape)}")
    b, rows, t = p.shape
    kind = _check_pages("latent_block_wsum", pages, scales, page_table,
                        kv_lens, b, dev)
    bs, mb, dl = pages.shape[1], page_table.shape[1], pages.shape[2]
    if t != mb * bs:
        raise ValueError(f"latent_block_wsum: p has {t} tokens, the table "
                         f"{mb} blocks of {bs}")
    if w_v.dtype != torch.bfloat16 or w_v.dim() != 3 or w_v.stride(2) != 1 \
            or w_v.shape[0] != dl or w_v.device != dev:
        raise ValueError(f"latent_block_wsum: w_v must be bf16 [dl {dl}, nq, "
                         f"dv] with unit stride along dv on {dev}, got "
                         f"{w_v.dtype} {tuple(w_v.shape)} {w_v.stride()}")
    nq, dv = w_v.shape[1], w_v.shape[2]
    if rows % nq:
        raise ValueError(f"latent_block_wsum: {rows} rows are not whole "
                         f"query positions of {nq} heads")
    if dv % 8 or w_v.data_ptr() % 16 or (w_v.stride(0) * 2) % 16 \
            or (w_v.stride(1) * 2) % 16:
        raise ValueError(f"latent_block_wsum: w_v rows of {dv} values (a "
                         "multiple of 8) on 16-byte boundaries, got strides "
                         f"{w_v.stride()}")
    plan = wsum_split_plan(b, rows, t, dl, kbuild.sm_count(dev))
    ws = kbuild.split_workspace("latent_wsum", dev,
                                plan.splits * b * rows * dl).data_ptr()
    out = torch.empty((b, rows, dv), dtype=torch.float32, device=dev)
    fn = kbuild.load(SOURCE, "latent_wsum_launch", _WSUM_ARGTYPES)
    rc = fn(p.data_ptr(), pages.data_ptr(),
            scales.data_ptr() if kind else None, page_table.data_ptr(),
            kv_lens.data_ptr(), w_v.data_ptr(), out.data_ptr(), ws, b,
            rows, nq, dl, dv, bs, mb, pages.stride(0), pages.stride(1),
            w_v.stride(0), w_v.stride(1), kind, plan.row_tile,
            plan.split_tokens, plan.splits, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"latent_block_wsum kernel launch failed: CUDA "
                           f"error {rc}")
    launches[f"wsum{_SFX[kind]}"] += 1
    return out
