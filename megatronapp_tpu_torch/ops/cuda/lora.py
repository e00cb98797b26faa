"""The segmented batched-LoRA kernel: its wrapper, launch counter, limits
and build.

The kernel (csrc/lora.cu) replaces the TPU kernel
``megatronapp_tpu/ops/pallas/kernel_gen.py:lora_segmented_delta``: delta[r]
= (x[r] @ A[slot[r]]) @ B[slot[r]] in fp32, rows grouped into adapter
segments (ops/lora.py ``LoraRows``), the banks read in place through the
slot ids. Its plain version is ``ops/lora.py:lora_delta_plain``, which the
dispatcher ``ops/lora.py:lora_delta`` takes for CPU tensors only; this
wrapper launches the kernel or raises. It builds at first use through
``ops/cuda/build.py`` and is loaded with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from megatronapp_tpu_torch.ops.cuda import build as kbuild

# Launches of the kernel, incremented only where the wrapper launches it.
launches: Dict[str, int] = {"lora_delta": 0}

SOURCE = kbuild.source("lora.cu")
MAX_RANK = 32          # csrc/lora.cu kMaxRank (the fused epilogues' too)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_P]


def lora_kernel_ineligible_reason(din: int, dout: int, rank: int,
                                  rows: int,
                                  bank_dtype: torch.dtype = torch.float32,
                                  x_dtype: torch.dtype = torch.bfloat16
                                  ) -> Optional[str]:
    """Why the CUDA LoRA kernels (the segmented delta and the fused
    epilogues) may NOT serve this delta: None when they can, else the
    first failed predicate by name. JAX's rank predicate
    (kernel_gen.lora_kernel_ineligible_reason); its VMEM predicate is
    replaced by the CUDA kernels' own limits: rank, bank dtype, the bf16
    input. Rows: any count."""
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
    if rows < 1:
        return f"no rows to run ({rows})"
    return None


def lora_segmented_delta(x: torch.Tensor, a_bank: torch.Tensor,
                         b_bank: torch.Tensor, segs) -> torch.Tensor:
    """Launch the kernel: x [R, din] bf16, a_bank [slots, din, rank] and
    b_bank [slots, rank, dout] fp32, segs a ``LoraRows`` of R rows on x's
    device → delta [R, dout] fp32. Raises for what the kernel cannot
    take."""
    if x.device.type != "cuda":
        raise ValueError(f"lora_segmented_delta: x on {x.device} — the "
                         "kernel takes CUDA tensors and the plain version "
                         "CPU tensors")
    if x.dim() != 2 or a_bank.dim() != 3 or b_bank.dim() != 3:
        raise ValueError("lora_segmented_delta: x [R, din], banks [slots, "
                         "din, rank] and [slots, rank, dout] expected")
    rows, din = x.shape
    slots, _, rank = a_bank.shape
    dout = b_bank.shape[-1]
    if tuple(a_bank.shape) != (slots, din, rank) \
            or tuple(b_bank.shape) != (slots, rank, dout):
        raise ValueError(f"lora_segmented_delta: x {tuple(x.shape)}, A "
                         f"{tuple(a_bank.shape)} and B {tuple(b_bank.shape)} "
                         "do not fit")
    reason = lora_kernel_ineligible_reason(din, dout, rank, rows,
                                           a_bank.dtype, x.dtype)
    if reason is None and b_bank.dtype != torch.float32:
        reason = f"adapter bank dtype {b_bank.dtype}: fp32 banks only"
    if reason is not None:
        raise ValueError(f"lora_segmented_delta: {reason}")
    if segs.rows != rows:
        raise ValueError(f"lora_segmented_delta: {rows} rows of x, "
                         f"{segs.rows} row adapter ids")
    for name, t in (("a_bank", a_bank), ("b_bank", b_bank),
                    ("order", segs.order), ("seg_off", segs.seg_off),
                    ("seg_slot", segs.seg_slot)):
        if t.device != x.device:
            raise ValueError(f"lora_segmented_delta: {name} on {t.device}, "
                             f"x on {x.device}")
    for name, t in (("x", x), ("a_bank", a_bank), ("b_bank", b_bank)):
        if not t.is_contiguous():
            raise ValueError(f"lora_segmented_delta: {name} is not "
                             "contiguous")
    out = torch.empty(rows, dout, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = kbuild.load(SOURCE, "lora_delta_launch", _ARGTYPES)(
        x.data_ptr(), a_bank.data_ptr(), b_bank.data_ptr(),
        segs.order.data_ptr(), segs.seg_off.data_ptr(),
        segs.seg_slot.data_ptr(), out.data_ptr(), rows, segs.nseg, din,
        dout, rank, stream)
    if rc != 0:
        raise RuntimeError(f"lora_delta kernel launch failed: CUDA error "
                           f"{rc}")
    launches["lora_delta"] += 1
    return out
