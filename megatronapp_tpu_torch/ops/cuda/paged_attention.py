"""Ragged paged attention: the CUDA kernels' wrapper, their plain version,
the launch counter and the build.

The kernels (csrc/paged_attention.cu) replace the TPU kernel
``megatronapp_tpu/ops/pallas/kernel_gen.py:emit_paged_kernel`` in both of
its modes, decode (one query row per slot) and ragged multi-query
(chunked prefill). They are bound by the bytes of K/V they read. One
design for every pool type (the source note gives it): split KV on the
tensor cores. The slot's kv tiles are dealt to ``kv_split_plan`` splits so
that a decode step or a one-request chunk fills the card; each block runs
its products on ``mma.sync`` and, with more than one split, writes fp32
partials (acc, m, l) to a workspace that this wrapper allocates, which a
second launch merges in split order (``merge_split_partials`` is that
merge in plain PyTorch, for the tests). On int8 or fp8 (e4m3) pools with
per-(row, kv-head) fp32 scale pools the block widens the codes to bf16
(exactly), takes q · codes and scales the scores' columns in fp32, and
carries the unrounded P × s_v into P · V as bf16 terms
(``split_bf16_terms``; ``split_partials_plain`` with scales mirrors that
arithmetic), so that, as in the TPU kernel's fp32 body, neither q nor P
is rounded.

``paged_attention`` takes the plain version only for tensors that lie on
the CPU. For CUDA tensors it launches the kernels or raises: there is no
fallback. The kernels build at first use through ``ops/cuda/build.py``
(nvcc into ``build/kernels``, named by the hash of source and flags) and
are loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from megatronapp_tpu_torch.ops.cuda import build as kbuild

NEG_INF = -1e30

# The quantized page dtypes (the JAX package's kernel_gen.QUANT_DTYPES):
# name → (page dtype, symmetric range bound qmax). Code of the kernel's
# page kind: 0 bf16, 1 int8, 2 fp8.
QUANT_DTYPES = {"int8": (torch.int8, 127.0),
                "fp8": (torch.float8_e4m3fn, 448.0)}
_PAGE_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}

# Calls that launch the kernels, by mode and, for quantized pools, page
# dtype (one a call, whether it launches one kernel or two). Incremented
# only where the wrapper launches them (never by the plain version).
launches: Dict[str, int] = {f"{mode}{sfx}": 0
                            for sfx in ("", "_int8", "_fp8")
                            for mode in ("decode", "ragged")}

SOURCE = kbuild.source("paged_attention.cu")
MAX_BLOCK_SIZE = 64
HEAD_DIMS = (64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p])
# The bf16-pool kernel's tiles (csrc/paged_attention.cu kTcRows, kTcKv):
# query rows (s, g) of one kv head a block, and kv rows a ring stage; kv
# tile i goes to split i mod splits.
ROW_TILE = 64
KV_TILE = 64
# Blocks the split plan aims for: two an SM (87 KB of shared memory each at
# D 128), the best of 1-16 splits at decode B 8 in flash_probe.py
# paged-splits (PERF.md).
SPLIT_TARGET_BLOCKS = 256
# bf16 terms of P × s_v on quantized pools (csrc/paged_attention.cu
# kTerms): three carry fp32's 24 significant bits.
QUANT_TERMS = 3


def kv_split_plan(batch: int, hkv: int, rows: int, capacity: int) -> int:
    """Splits of the kv range, from the launch's shapes alone: batch, kv
    heads, the rows of one kv head (S_q × group) and the page table's
    capacity mb × bs positions; never kv_lens, which lie on the device.
    Enough blocks to reach SPLIT_TARGET_BLOCKS, but each split gets at
    least ceil(rows a block / 32) kv tiles of the capacity, so that its
    fp32 partials (rows × (D + 2) × 4 bytes, written once and read back
    once) come to at most about half the K/V bytes its tiles read (64 × D
    × 4 a tile of bf16 pools). One-byte pools read half those bytes, but
    the same plan: at a ragged B 1 chunk twice the tiles a split (4
    splits) ran 33 % slower than this plan's 8, and on the engine's
    2048-position tables this plan's 16 within 5 % of the best, 8
    (flash_probe.py paged-splits, PERF.md)."""
    tiles = -(-capacity // KV_TILE)
    row_tiles = -(-rows // ROW_TILE)
    want = -(-SPLIT_TARGET_BLOCKS // (batch * hkv * row_tiles))
    min_tiles = -(-min(rows, ROW_TILE) // 32)
    return max(1, min(want, tiles // min_tiles))


def launch_split_count(q: torch.Tensor, k_pages: torch.Tensor,
                       page_table: torch.Tensor) -> int:
    """The split count of a launch: kv_split_plan on the shapes of q ([B,
    Hq, D] decode or [B, S_q, Hq, D] ragged), the pools and the page
    table; it reads no tensor's values."""
    s_q = q.shape[1] if q.dim() == 4 else 1
    _, bs, hkv, _ = k_pages.shape
    return kv_split_plan(q.shape[0], hkv, s_q * (q.shape[-2] // hkv),
                         page_table.shape[1] * bs)


def merge_split_partials(acc: torch.Tensor, m: torch.Tensor,
                         l: torch.Tensor) -> torch.Tensor:
    """The combine kernel's merge in plain PyTorch: acc [..., S, D] and m,
    l [..., S] fp32 partials of S splits (unnormalised acc; m the split's
    running max, -1e30 and l = 0 where the split saw no position) → out
    [..., D] fp32. In split order: m = max m_i, l = Σ l_i e^{m_i - m},
    acc = Σ acc_i e^{m_i - m}, out = acc / max(l, 1e-20); splits with
    l_i = 0 are skipped (their acc is never read)."""
    live = l > 0
    m_all = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(dim=-1)
    l_all = torch.zeros_like(m_all)
    out = torch.zeros_like(acc[..., 0, :])
    for i in range(m.shape[-1]):
        w = torch.where(live[..., i], torch.exp(m[..., i] - m_all),
                        torch.zeros_like(m_all))
        l_all = l_all + l[..., i] * w
        out = out + torch.where(live[..., i, None], acc[..., i, :],
                                torch.zeros_like(out)) * w[..., None]
    return out / l_all.clamp(min=1e-20)[..., None]


def split_bf16_terms(x: torch.Tensor, terms: int) -> list:
    """x (fp32) as `terms` bf16 values (returned in fp32) whose sum is x:
    t1 = bf16(x), t2 = bf16(x - t1), ...; each difference is exact in fp32
    and each term adds 8 significant bits, so three terms give back every
    normal fp32 value exactly and two agree to about 2^-16 of x. The
    quantized kernel's A fragments of P × s_v (tc::acc_16xD_split)."""
    out, rest = [], x.float()
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def split_partials_plain(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         kv_lens: torch.Tensor,
                         q_lens: Optional[torch.Tensor], splits: int,
                         softmax_scale: Optional[float] = None,
                         k_scales: Optional[torch.Tensor] = None,
                         v_scales: Optional[torch.Tensor] = None):
    """Each split's (acc [B, S_q, Hq, S, D], m, l [B, S_q, Hq, S]) of the
    kernel, with its conventions, in plain PyTorch: kv tile i (KV_TILE
    positions) in split i mod S; per split, m the max of the row's valid
    scores (-1e30 where none), l = Σ exp(s - max(m, -5e29)) over them. On
    bf16 pools the scores take q scaled and rounded to q's dtype, and acc
    the weights rounded to V's dtype times V. With scale pools (int8 / fp8
    pages) the kernel's arithmetic: scores (q · codes) × (scale × s_k), q
    as given; acc = Σ (P × s_v in QUANT_TERMS bf16 terms) × codes. q is [B,
    Hq, D] in decode mode (q_lens None; the S_q axis is then 1)."""
    if q_lens is None:
        q, q_lens = q[:, None], torch.ones_like(kv_lens)
    b, s_q, hq, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    mb = page_table.shape[1]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale
    table = page_table.long()
    k = _gather_pages(k_pages, table, None).reshape(b, mb * bs, hkv, d)
    v = _gather_pages(v_pages, table, None).reshape(b, mb * bs, hkv, d)
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    quant = k_scales is not None
    if quant:
        def col(scales):   # [B, 1, Hq, MB × bs]: a position's (row, head)
            return scales[table].reshape(b, mb * bs, hkv) \
                .repeat_interleave(group, dim=2).transpose(1, 2)[:, None]
        s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k) \
            * (scale * col(k_scales))
        vs = col(v_scales)
    else:
        qs = (q.float() * scale).to(q.dtype).float()
        s = torch.einsum("bqhd,bkhd->bqhk", qs, k)
    pos = torch.arange(mb * bs)
    kv_lens, q_lens = kv_lens.long(), q_lens.long()
    abs_q = (kv_lens - q_lens)[:, None] + torch.arange(s_q)
    valid = ((pos[None, None, :] <= abs_q[:, :, None])
             & (pos[None, None, :] < kv_lens[:, None, None]))[:, :, None, :]
    accs, ms, ls = [], [], []
    for i in range(splits):
        ok = valid & ((pos // KV_TILE) % splits == i)
        sc = s.masked_fill(~ok, NEG_INF)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m.clamp(min=NEG_INF / 2)[..., None]) \
            .masked_fill(~ok, 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        if quant:
            w = sum(split_bf16_terms(p * vs, QUANT_TERMS)[::-1])
        else:
            w = p.to(v_pages.dtype).float()
        accs.append(torch.einsum("bqhk,bkhd->bqhd", w, v))
    return (torch.stack(accs, dim=3), torch.stack(ms, dim=-1),
            torch.stack(ls, dim=-1))


def _kernel():
    """The bound C launcher (built and loaded on first use)."""
    return kbuild.load(SOURCE, "paged_attention_launch", _ARGTYPES)


def storage_view(t: torch.Tensor) -> torch.Tensor:
    """fp8 tensors as uint8 views of the same bytes (indexing and copies of
    fp8 are not implemented on every device and torch version); other
    tensors as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _gather_pages(pages: torch.Tensor, table: torch.Tensor,
                  scales: Optional[torch.Tensor]) -> torch.Tensor:
    """pages[table] as fp32, dequantized as float(page) × its (row, head)
    scale when `scales` is given."""
    rows = storage_view(pages)[table].view(pages.dtype).float()
    return rows if scales is None else rows * scales[table][..., None]


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          kv_lens: torch.Tensor,
                          q_lens: Optional[torch.Tensor] = None,
                          softmax_scale: Optional[float] = None,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gathers every slot's pages
    densely (dequantized when scale pools are given), masks (kv length,
    and the causal tail in ragged mode) and takes the softmax in fp32 —
    the JAX package's paged_attention_reference / _multiquery_reference.
    Same signature and shapes as ``paged_attention``."""
    decode = q_lens is None
    if decode:
        q = q[:, None]
        q_lens = torch.ones_like(kv_lens)
    b, s_q, hq, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    mb = page_table.shape[1]
    group = hq // hkv
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    table = page_table.long()
    k = _gather_pages(k_pages, table, k_scales).reshape(b, mb * bs, hkv, d)
    v = _gather_pages(v_pages, table, v_scales).reshape(b, mb * bs, hkv, d)
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k) * softmax_scale
    dev = q.device
    pos = torch.arange(mb * bs, device=dev)
    kv_lens, q_lens = kv_lens.to(dev).long(), q_lens.to(dev).long()
    abs_q = (kv_lens - q_lens)[:, None] + torch.arange(s_q, device=dev)
    mask = ((pos[None, None, :] <= abs_q[:, :, None])
            & (pos[None, None, :] < kv_lens[:, None, None]))
    s = s.masked_fill(~mask[:, :, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", p, v).to(q.dtype)
    return out[:, 0] if decode else out


def _check(q, k_pages, v_pages, page_table, kv_lens, q_lens, k_scales,
           v_scales):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"paged_attention: tensors on {dev} — the kernel takes CUDA "
            "tensors and the plain version CPU tensors")
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "page_table": page_table, "kv_lens": kv_lens}
    if q_lens is not None:
        named["q_lens"] = q_lens
    quantized = k_scales is not None
    if quantized:
        named.update(k_scales=k_scales, v_scales=v_scales)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"paged_attention: q is {q.dtype}; the kernel "
                         "takes bf16 queries")
    kind = _PAGE_KIND.get(k_pages.dtype)
    if kind is None or v_pages.dtype != k_pages.dtype \
            or quantized != (kind > 0) or (v_scales is None) == quantized:
        raise ValueError(
            f"paged_attention: pools {k_pages.dtype}/{v_pages.dtype} with"
            f"{'' if quantized else 'out'} scale pools; the kernel takes "
            "bf16 pools without scales, or int8 / fp8 (e4m3) pools with "
            "both fp32 scale pools")
    for name in ("q", "k_pages", "v_pages"):
        if named[name].data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             "aligned")
    if quantized:
        want = tuple(k_pages.shape[:3])
        for name in ("k_scales", "v_scales"):
            t = named[name]
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"paged_attention: {name} must be fp32 "
                                 f"{want}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    for name in ("page_table", "kv_lens", "q_lens"):
        if name in named and named[name].dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32, got "
                             f"{named[name].dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_attention: pools must both be "
                         f"[NB, bs, Hkv, D], got {tuple(k_pages.shape)} "
                         f"and {tuple(v_pages.shape)}")
    _, bs, hkv, d = k_pages.shape
    ragged = q_lens is not None
    if q.dim() != (4 if ragged else 3) or q.shape[-1] != d:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not "
                         f"fit pools {tuple(k_pages.shape)} in "
                         f"{'ragged' if ragged else 'decode'} mode")
    b, hq = q.shape[0], q.shape[-2]
    if d not in HEAD_DIMS or bs > MAX_BLOCK_SIZE or hq % hkv:
        raise ValueError(f"paged_attention: head_dim {d} (takes "
                         f"{HEAD_DIMS}), block_size {bs} (at most "
                         f"{MAX_BLOCK_SIZE}), Hq {hq} % Hkv {hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(kv_lens.shape) != (b,) \
            or (ragged and tuple(q_lens.shape) != (b,)):
        raise ValueError("paged_attention: page_table must be [B, MB] and "
                         "kv_lens/q_lens [B]")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    kv_lens: torch.Tensor,
                    q_lens: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged paged attention, the kernel_gen.paged_attention contract.

    q [B, Hq, D] (decode) or [B, S_q, Hq, D] with q_lens [B] (ragged
    multi-query: row s of slot b sits at absolute position kv_lens[b] -
    q_lens[b] + s; rows past q_lens[b] are padding whose outputs are
    finite garbage); pools [NB, bs, Hkv, D]; page_table [B, MB] int32;
    kv_lens [B] int32 valid kv positions including the new tail;
    k_scales/v_scales [NB, bs, Hkv] fp32 mark int8 or fp8 pools (each
    element dequantizes as float(page) × its (row, head) scale, and the
    body rounds neither q nor P, as the TPU kernel's quantized body does
    not). Returns q's shape. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     kv_lens, q_lens, softmax_scale,
                                     k_scales, v_scales)
    _check(q, k_pages, v_pages, page_table, kv_lens, q_lens, k_scales,
           v_scales)
    fn = _kernel()
    ragged = q_lens is not None
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    s_q = q.shape[1] if ragged else 1
    _, bs, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kind = _PAGE_KIND[k_pages.dtype]
    mb = page_table.shape[1]
    splits, ws = launch_split_count(q, k_pages, page_table), None
    if splits > 1:
        ws = torch.empty(b * s_q * hq * splits * (d + 2),
                         dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if kind else None,
            v_scales.data_ptr() if kind else None,
            page_table.data_ptr(), kv_lens.data_ptr(),
            q_lens.data_ptr() if ragged else None, out.data_ptr(),
            b, s_q, hq, hkv, d, bs, mb, kind, float(softmax_scale),
            None if ws is None else ws.data_ptr(), splits, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    sfx = ("", "_int8", "_fp8")[kind]
    launches[f"{'ragged' if ragged else 'decode'}{sfx}"] += 1
    return out
