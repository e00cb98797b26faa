"""The segmented batched-LoRA kernels: their wrappers, launch counters,
limits, the CPU mirror of the shrink's summation order, and build.

The kernels (csrc/lora.cu) replace the TPU kernel
``megatronapp_tpu/ops/pallas/kernel_gen.py:lora_segmented_delta``: delta[r]
= (x[r] @ A[slot[r]]) @ B[slot[r]] in fp32, rows grouped into adapter
segments (ops/lora.py ``LoraRows``), the banks read in place through the
slot ids, as two launches:

- ``lora_shrink``: t [targets, R, rank] = xin @ A[slot] for one target or
  two that share their input (q and kv), K spread over the card; xin is x
  itself or bf16(norm(x)), the input of the fused QKV and fc1 products
  (ops/cuda/fused_decode.py launches it before each fused kernel with a
  LoRA epilogue, which then only expands t);
- ``lora_expand``: delta [R, dout] = t @ B[slot].

``lora_segmented_deltas`` runs the two. The plain versions are
``ops/lora.py:lora_shrink_plain``, ``lora_expand_plain`` and
``lora_delta_plain``, which the dispatchers there take for CPU tensors
only; these wrappers launch the kernels or raise.
``lora_shrink_split_plain`` repeats the shrink's order of summation on the
CPU. The kernels build at first use through ``ops/cuda/build.py`` and are
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from megatronapp_tpu_torch.config.transformer_config import NormKind
from megatronapp_tpu_torch.ops.cuda import build as kbuild
from megatronapp_tpu_torch.ops.normalization import apply_norm

# Launches of each kernel, incremented only where its wrapper launches it
# (the fused kernels' shrinks too).
launches: Dict[str, int] = {"lora_shrink": 0, "lora_expand": 0}

SOURCE = kbuild.source("lora.cu")
MAX_RANK = 32          # csrc/lora.cu kMaxRank (the fused epilogues' too)
MAX_TARGETS = 2        # kMaxTargets: A banks one shrink launch reads
GROUP_ROWS = 8         # kGroupRows: rows of a unit
SHRINK_THREADS = 256   # kThreads
SHRINK_STAGE_K = 128   # kStageK: k's a ring stage holds
# Floats of one A a shrink block reads, kper = this / rank k's a split, and
# at most MAX_SPLITS splits. flash_probe.py lora-splits timed rank 8 on an
# NVIDIA H100 80GB HBM3 at 700 W, 8 mixed rows / 32 rows of one adapter:
# din 4096 at 256 k's a split (16 splits) 0.0082 / 0.0082 ms, against
# 0.0099 / 0.0080 at 128 and 0.0096 / 0.0096 at 512; din 14336 at 512 (28
# splits) 0.0126 / 0.0104 ms, against 0.0121 / 0.0119 at 256 and 0.0131 /
# 0.0128 at 1024.
SPLIT_FLOATS = 2048
MAX_SPLITS = 28
NORM_CODES = {NormKind.rmsnorm: 1, NormKind.layernorm: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "lora_shrink_launch": [_P, _P, _P, _I, _F, _I] + [_P] * 8 + [_I] * 6
                          + [_P],
    "lora_expand_launch": [_P] * 6 + [_I] * 5 + [_P],
}
_counters: Dict[torch.device, torch.Tensor] = {}


def shrink_k_per_split(rank: int, din: int) -> int:
    """k's a shrink block owns: SPLIT_FLOATS of A, or more where din would
    take over MAX_SPLITS splits, a multiple of 8. It reads the rank and
    din alone, so a row's order of summation never depends on the rows,
    segments or adapters of the launch."""
    kper = max(8, SPLIT_FLOATS // rank // 8 * 8)
    return max(kper, (-(-din // MAX_SPLITS) + 7) // 8 * 8)


def lora_kernel_ineligible_reason(din: int, dout: int, rank: int,
                                  rows: int,
                                  bank_dtype: torch.dtype = torch.float32,
                                  x_dtype: torch.dtype = torch.bfloat16
                                  ) -> Optional[str]:
    """Why the CUDA LoRA kernels (the shrink and expand, and the fused
    epilogues) may NOT serve this delta: None when they can, else the
    first failed predicate by name. JAX's rank predicate
    (kernel_gen.lora_kernel_ineligible_reason); its VMEM predicate is
    replaced by the CUDA kernels' own limits: rank, bank dtype, the bf16
    input, the widths their 16-byte copies take. Rows: any count."""
    if rank > min(din, dout):
        return (f"adapter rank {rank} exceeds min(din={din}, "
                f"dout={dout}) — a low-rank delta this fat is an eager "
                f"gather, not a segmented GEMM")
    if rank < 1 or rank > MAX_RANK:
        return (f"adapter rank {rank}: the CUDA LoRA kernels take ranks "
                f"1..{MAX_RANK} (8 rows x rank (row, j) sums over 256 "
                "threads)")
    if bank_dtype != torch.float32:
        return (f"adapter bank dtype {bank_dtype}: the CUDA LoRA kernels "
                "read fp32 banks")
    if x_dtype != torch.bfloat16:
        return (f"input dtype {x_dtype}: the CUDA LoRA kernels take bf16 "
                "activations (the compute dtype of the served model)")
    if din % 8 or dout % 4:
        return (f"alignment: din {din} / dout {dout} — the CUDA LoRA "
                "kernels copy rows of x in 8-element and of B in 4-column "
                "16-byte pieces")
    if rows < 1:
        return f"no rows to run ({rows})"
    return None


def shrink_input_plain(x: torch.Tensor, norm=None) -> torch.Tensor:
    """The shrink's input: x, or bf16(norm(x)) for norm = (NormKind, scale,
    bias or None, eps), the input of the fused QKV and fc1 products."""
    if norm is None:
        return x
    kind, scale, bias, eps = norm
    return apply_norm(kind, x, scale, bias, eps).to(torch.bfloat16)


def lora_shrink_split_plain(x: torch.Tensor, a_bank: torch.Tensor, ids,
                            kper: Optional[int] = None,
                            norm=None) -> torch.Tensor:
    """The shrink's t [R, rank] fp32 summed in the kernel's order, on the
    CPU: split s owns k's [s·kper, (s+1)·kper) (kper from din and rank),
    streamed in stages of SHRINK_STAGE_K; part p (of 256 // rank) sums the
    stage's k's p, p + parts, ... in order, one multiply and one add a k
    (the kernel fuses them: one rounding fewer), the parts are added in
    order, then the splits. Each row is computed elementwise from its own
    input and factors: its t is the same bits alone and in a batch. ids:
    [R] slot ids (0: t = 0)."""
    ids = torch.as_tensor(ids).long().reshape(-1)
    xin = shrink_input_plain(x, norm).float()
    rows, din = xin.shape
    rank = a_bank.shape[-1]
    kper = kper or shrink_k_per_split(rank, din)
    parts = SHRINK_THREADS // rank
    a = a_bank[ids].float()                              # [R, din, rank]
    t = torch.zeros(rows, rank)
    for k_begin in range(0, din, kper):
        k_end = min(din, k_begin + kper)
        acc = torch.zeros(rows, parts, rank)
        for k0 in range(k_begin, k_end, SHRINK_STAGE_K):
            kc = min(SHRINK_STAGE_K, k_end - k0)
            for m in range(0, kc, parts):               # k0 + m + p, p < parts
                ks = torch.arange(k0 + m, k0 + min(m + parts, kc))
                n = len(ks)
                prod = xin[:, ks, None] * a[:, ks, :]    # [R, n, rank]
                acc[:, :n] = acc[:, :n] + prod
        split = acc[:, 0]
        for p in range(1, parts):
            split = split + acc[:, p]
        t = split if k_begin == 0 else t + split
    return t.masked_fill((ids == 0)[:, None], 0.0)


def _check_rows(name: str, x: torch.Tensor, segs):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} — the kernel takes "
                         "CUDA tensors and the plain version CPU tensors")
    if segs.rows != x.shape[0]:
        raise ValueError(f"{name}: {x.shape[0]} rows, {segs.rows} row "
                         "adapter ids")
    for k, t in (("order", segs.order), ("seg_off", segs.seg_off),
                 ("seg_slot", segs.seg_slot)):
        if t.device != x.device:
            raise ValueError(f"{name}: {k} on {t.device}, x on {x.device}")


def _check_bank(name: str, t: torch.Tensor, device: torch.device):
    if t.dtype != torch.float32 or t.device != device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: banks must be contiguous 16-byte aligned "
                         f"fp32 on {device}, got {t.dtype} on {t.device}")


def _workspace(units: int, floats: int, device: torch.device):
    """(the device's split workspace pointer: at least `floats` fp32, its
    counters pointer: at least `units` zeroed ints, which the kernel leaves
    zero). Both outlive the launch: the kernel after a shrink (an expand or
    a fused kernel, a programmatic dependent) may start while the shrink
    still runs, so a workspace freed when the wrapper returned could be
    handed to that kernel's own buffers while the shrink writes it. A
    shrink is not a dependent launch: it starts once the work before it on
    the stream is done, so one buffer serves every shrink of the stream."""
    ctr = _counters.get(device)
    if ctr is None or ctr.numel() < units:
        ctr = torch.zeros(max(units, 1024), dtype=torch.int32, device=device)
        _counters[device] = ctr
    ws = kbuild.split_workspace("lora_shrink", device, floats)
    return ws.data_ptr(), ctr.data_ptr()


def lora_shrink(x: torch.Tensor, a_banks: Sequence[torch.Tensor], segs,
                norm=None, kper: Optional[int] = None) -> torch.Tensor:
    """Launch the shrink: x [R, din] bf16, a_banks one or two A banks
    [slots, din, rank] fp32 (targets sharing x), segs a ``LoraRows`` of R
    rows on x's device → t [targets, R, rank] fp32 (0 on NULL rows). norm:
    None, or (NormKind, scale, bias or None, eps) — t is then formed from
    bf16(norm(x)) (``shrink_input_plain``), scale and bias bf16 or fp32.
    kper: k's a split block owns (default ``shrink_k_per_split``). Raises
    for what the kernel cannot take."""
    name = "lora_shrink"
    _check_rows(name, x, segs)
    if x.dim() != 2 or not 1 <= len(a_banks) <= MAX_TARGETS:
        raise ValueError(f"{name}: x [R, din] and 1..{MAX_TARGETS} A banks "
                         "expected")
    rows, din = x.shape
    rank = a_banks[0].shape[-1]
    for a in a_banks:
        _check_bank(name, a, x.device)
        if a.dim() != 3 or tuple(a.shape[1:]) != (din, rank):
            raise ValueError(f"{name}: A bank {tuple(a.shape)} for x "
                             f"{tuple(x.shape)} and rank {rank}")
    reason = None
    if not 1 <= rank <= MAX_RANK:
        reason = f"adapter rank {rank}: ranks 1..{MAX_RANK} expected"
    elif x.dtype != torch.bfloat16:
        reason = f"input dtype {x.dtype}: bf16 expected"
    elif din % 8 or not x.is_contiguous() or x.data_ptr() % 16:
        reason = (f"x [{rows}, {din}] must be contiguous and 16-byte "
                  "aligned with din a multiple of 8 (16-byte copies)")
    kper = kper or shrink_k_per_split(rank, din)
    if reason is None and (kper < 8 or kper % 8):
        reason = f"{kper} k's a split: a positive multiple of 8 expected"
    code, scale, bias, eps, vec_f32 = 0, None, None, 0.0, 0
    if reason is None and norm is not None:
        kind, scale, bias, eps = norm
        code = NORM_CODES[kind]
        vecs = [v for v in (scale, bias) if v is not None]
        if {v.dtype for v in vecs} - {torch.bfloat16, torch.float32} \
                or len({v.dtype for v in vecs}) != 1 \
                or any(v.device != x.device or v.shape != (din,)
                       or not v.is_contiguous() for v in vecs):
            reason = (f"norm scale/bias must be one dtype of bf16 or fp32, "
                      f"[{din}] contiguous on {x.device}")
        vec_f32 = int(scale.dtype == torch.float32)
    if reason is not None:
        raise ValueError(f"{name}: {reason}")
    groups = -(-segs.max_seg_rows // GROUP_ROWS)
    units, nt = segs.nseg * groups, len(a_banks)
    splits = -(-din // kper)
    t = torch.empty(nt, rows, rank, dtype=torch.float32, device=x.device)
    ws, ctr = _workspace(units, units * nt * splits * GROUP_ROWS * rank,
                         x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    a1 = a_banks[1].data_ptr() if nt == 2 else None
    rc = kbuild.load(SOURCE, "lora_shrink_launch",
                     _ARGTYPES["lora_shrink_launch"])(
        x.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), code, float(eps), vec_f32,
        a_banks[0].data_ptr(), a1, segs.order.data_ptr(),
        segs.seg_off.data_ptr(), segs.seg_slot.data_ptr(), t.data_ptr(),
        ws, ctr, rows, segs.nseg, groups, din, rank, kper, stream)
    if rc != 0:
        raise RuntimeError(f"lora_shrink kernel launch failed: CUDA error "
                           f"{rc}")
    launches["lora_shrink"] += 1
    return t


def lora_expand(t: torch.Tensor, b_bank: torch.Tensor, segs) -> torch.Tensor:
    """Launch the expand: t [R, rank] fp32 (one target of ``lora_shrink``),
    b_bank [slots, rank, dout] fp32, segs a ``LoraRows`` → delta [R, dout]
    fp32 (exact zeros on NULL rows). Raises for what the kernel cannot
    take."""
    name = "lora_expand"
    _check_rows(name, t, segs)
    _check_bank(name, b_bank, t.device)
    rows, rank = t.shape
    if b_bank.dim() != 3 or b_bank.shape[1] != rank:
        raise ValueError(f"{name}: t {tuple(t.shape)} and B "
                         f"{tuple(b_bank.shape)} do not fit")
    dout = b_bank.shape[-1]
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: t must be contiguous fp32")
    if not 1 <= rank <= MAX_RANK or dout % 4:
        raise ValueError(f"{name}: rank {rank} (1..{MAX_RANK}) and dout "
                         f"{dout} (a multiple of 4: 16-byte copies of B) "
                         "expected")
    out = torch.empty(rows, dout, dtype=torch.float32, device=t.device)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    rc = kbuild.load(SOURCE, "lora_expand_launch",
                     _ARGTYPES["lora_expand_launch"])(
        t.data_ptr(), b_bank.data_ptr(), segs.order.data_ptr(),
        segs.seg_off.data_ptr(), segs.seg_slot.data_ptr(), out.data_ptr(),
        rows, segs.nseg, -(-segs.max_seg_rows // GROUP_ROWS), dout, rank,
        stream)
    if rc != 0:
        raise RuntimeError(f"lora_expand kernel launch failed: CUDA error "
                           f"{rc}")
    launches["lora_expand"] += 1
    return out


def lora_segmented_deltas(x: torch.Tensor, bank_pairs, segs):
    """One shrink launch for every (A, B) pair of bank_pairs (at most
    MAX_TARGETS targets that share x), then one expand a pair: x [R, din]
    bf16, A [slots, din, rank] and B [slots, rank, dout] fp32, segs a
    ``LoraRows`` of R rows on x's device → [delta [R, dout] fp32 a pair]."""
    _check_rows("lora_segmented_deltas", x, segs)
    for a_bank, b_bank in bank_pairs:
        if a_bank.dim() != 3 or b_bank.dim() != 3 \
                or a_bank.shape[0] != b_bank.shape[0] \
                or a_bank.shape[-1] != b_bank.shape[1]:
            raise ValueError(f"lora_segmented_deltas: A "
                             f"{tuple(a_bank.shape)} and B "
                             f"{tuple(b_bank.shape)} do not fit")
    t = lora_shrink(x, [a for a, _ in bank_pairs], segs)
    return [lora_expand(t[i], b, segs) for i, (_, b) in enumerate(bank_pairs)]
