"""Batched-LoRA deltas: the counterpart of the LoRA section of the JAX
package's ``megatronapp_tpu/ops/pallas/kernel_gen.py`` (:2245-2422).

A batch carries a per-row adapter bank slot (0 = the NULL adapter), and
every LoRA-targeted matmul adds delta[r] = (x[r] @ A_{id[r]}) @ B_{id[r]}
to its base output. Row r's delta depends on row r's input and factors
only, never on which other rows share the batch: a mixed-tenant batch is
token-exact against serving each tenant alone.

- ``LoraRows``: a step's per-row slot ids with their segments (rows
  grouped by adapter in first-occurrence order, ``lora_segment_info``),
  built on the host from the engine's ``row_adapter`` and copied to the
  device with one non-blocking copy, so launching the kernel never waits
  on the card;
- ``lora_delta_plain``: the fp32 two-step product on gathered factors
  (``lora_delta_reference``);
- ``lora_delta``: the dispatcher: the hand-written segmented kernel
  (ops/cuda/lora.py, csrc/lora.cu) for CUDA tensors, the plain version
  for CPU ones, no other fallback;
- ``apply_lora_delta``: the call site of the unfused layers, ``y +
  d.to(y.dtype)`` (a zero-B adapter adds an exact +0.0).

The fused kernels carry the same delta as an epilogue
(ops/cuda/fused_decode.py) and read the same ``lora`` dict: {"row_adapter":
LoraRows, "banks": {target: (A [slots, din, rank], B [slots, rank,
dout])}} with one layer's bank slices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from megatronapp_tpu_torch.ops.cuda import lora as cuda_lora
from megatronapp_tpu_torch.utils.device import host_to

lora_kernel_ineligible_reason = cuda_lora.lora_kernel_ineligible_reason


def lora_segment_info(row_adapter):
    """Group rows by adapter id in first-occurrence order (the JAX
    function's contract, computed on the host): row_adapter [R] → (
    seg_adapter [R] int32, segment s's slot for s < nseg and 0 after;
    row_seg [R] int32, row r's segment; nseg)."""
    ids = np.asarray(row_adapter, np.int32).reshape(-1)
    seg_adapter = np.zeros(len(ids), np.int32)
    row_seg = np.zeros(len(ids), np.int32)
    first = {}
    for r, slot in enumerate(ids.tolist()):
        if slot not in first:
            first[slot] = len(first)
            seg_adapter[first[slot]] = slot
        row_seg[r] = first[slot]
    return seg_adapter, row_seg, len(first)


class LoraRows:
    """The per-row adapter slots of one call, with their segments.

    `row_adapter`: host slot ids (numpy or a CPU tensor), one per slot of
    the batch; `repeat`: token rows per slot (a [B, S] chunk's flattened
    rows all wear their slot's adapter). On `device`: ``ids`` [R] int32,
    ``order`` [R] (rows grouped by segment, in order within one),
    ``seg_off`` [nseg + 1] and ``seg_slot`` [nseg], views of one int32
    buffer copied with ``host_to`` (non-blocking on the card); ``nseg``
    the segment count."""

    def __init__(self, row_adapter, device, repeat: int = 1):
        ids = np.repeat(np.asarray(row_adapter, np.int32).reshape(-1),
                        repeat)
        seg_adapter, row_seg, nseg = lora_segment_info(ids)
        order = np.argsort(row_seg, kind="stable").astype(np.int32)
        counts = np.bincount(row_seg, minlength=nseg)[:nseg]
        seg_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        r = len(ids)
        self.rows, self.nseg = r, nseg
        buf = host_to(np.concatenate([ids, order, seg_off,
                                      seg_adapter[:nseg]]).astype(np.int32),
                      torch.device(device))
        self.ids = buf[:r]
        self.order = buf[r:2 * r]
        self.seg_off = buf[2 * r:2 * r + nseg + 1]
        self.seg_slot = buf[2 * r + nseg + 1:]


def as_lora_rows(rows, device) -> LoraRows:
    """`rows` as a LoraRows on `device`: a LoraRows passes through; host
    ids (numpy, list or a CPU tensor) are grouped here. Device-resident
    ids are refused: grouping them would wait on the card."""
    if isinstance(rows, LoraRows):
        return rows
    if isinstance(rows, torch.Tensor) and rows.device.type != "cpu":
        raise TypeError("lora row ids must be on the host (a LoraRows, "
                        "numpy or a CPU tensor): their segments are built "
                        "there")
    return LoraRows(rows, device)


def lora_delta_plain(x, a_bank, b_bank, row_adapter):
    """Plain version (kernel_gen.lora_delta_reference): per-row gathered
    factors, the two-step product in fp32. x [R, din], a_bank [slots,
    din, rank], b_bank [slots, rank, dout], row_adapter [R] slot ids (a
    tensor on x's device, or a LoraRows) → [R, dout] fp32."""
    ids = row_adapter.ids if isinstance(row_adapter, LoraRows) \
        else row_adapter
    ids = ids.long()
    a = a_bank[ids].float()                           # [R, din, rank]
    b = b_bank[ids].float()                           # [R, rank, dout]
    t = torch.einsum("bi,bir->br", x.float(), a)
    return torch.einsum("br,bro->bo", t, b)


def lora_delta(x, a_bank, b_bank, rows):
    """The batched-LoRA delta [R, dout] fp32 of x [R, din]: the segmented
    kernel for CUDA tensors (which raises where it cannot launch), the
    plain version for CPU tensors. rows: a LoraRows, or host slot ids."""
    rows = as_lora_rows(rows, x.device)
    if x.device.type == "cpu":
        return lora_delta_plain(x, a_bank, b_bank, rows)
    return cuda_lora.lora_segmented_delta(x, a_bank, b_bank, rows)


def _lora_rows_delta(x, bank_pair, rows: LoraRows):
    """Delta for x [R, din] or [B, S, din] against one target's bank pair;
    `rows` covers the flattened rows (a [B, S] chunk's LoraRows is built
    with repeat=S). Returns an x-shaped fp32 delta."""
    a_bank, b_bank = bank_pair
    flat = x.reshape(-1, x.shape[-1])
    if flat.shape[0] != rows.rows:
        raise ValueError(f"lora: {flat.shape[0]} rows of x, {rows.rows} "
                         "row adapter ids")
    d = lora_delta(flat.contiguous(), a_bank, b_bank, rows)
    return d.reshape(*x.shape[:-1], d.shape[-1])


def apply_lora_delta(y, x, lora: Optional[dict], target: str):
    """y + target's adapter delta (computed from x) in y's dtype, when
    `lora` carries that target; y unchanged otherwise."""
    if lora is None or target not in lora["banks"]:
        return y
    d = _lora_rows_delta(x, lora["banks"][target], lora["row_adapter"])
    return y + d.to(y.dtype)
