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
  (``lora_delta_reference``), ``lora_expand_plain(lora_shrink_plain(...))``;
- ``lora_deltas`` / ``lora_delta``: the dispatchers: the hand-written
  shrink and expand kernels (ops/cuda/lora.py, csrc/lora.cu) for CUDA
  tensors, one shrink for targets that share their input, the plain
  version for CPU ones, no other fallback;
- ``apply_lora_delta`` / ``apply_lora_deltas``: the call sites of the
  unfused layers, ``y + d.to(y.dtype)`` (a zero-B adapter adds an exact
  +0.0).

The fused kernels carry the same delta as an epilogue that expands the
shrink's t (ops/cuda/fused_decode.py) and read the same ``lora`` dict:
{"row_adapter": LoraRows, "banks": {target: (A [slots, din, rank], B
[slots, rank, dout])}} with one layer's bank slices.
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
    the segment count, ``max_seg_rows`` the rows of the largest one."""

    def __init__(self, row_adapter, device, repeat: int = 1):
        ids = np.repeat(np.asarray(row_adapter, np.int32).reshape(-1),
                        repeat)
        seg_adapter, row_seg, nseg = lora_segment_info(ids)
        order = np.argsort(row_seg, kind="stable").astype(np.int32)
        counts = np.bincount(row_seg, minlength=nseg)[:nseg]
        seg_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        r = len(ids)
        self.rows, self.nseg = r, nseg
        self.max_seg_rows = int(counts.max()) if nseg else 0
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


def _ids(row_adapter):
    ids = row_adapter.ids if isinstance(row_adapter, LoraRows) \
        else row_adapter
    return ids.long()


def lora_shrink_plain(x, a_bank, row_adapter):
    """Plain version of the shrink: t [R, rank] fp32 = x @ A[slot] of each
    row on gathered factors. x [R, din], a_bank [slots, din, rank],
    row_adapter [R] slot ids (a tensor on x's device, or a LoraRows)."""
    a = a_bank[_ids(row_adapter)].float()            # [R, din, rank]
    return torch.einsum("bi,bir->br", x.float(), a)


def lora_expand_plain(t, b_bank, row_adapter):
    """Plain version of the expand: t [R, rank] fp32 @ B[slot] of each row
    on gathered factors → [R, dout] fp32."""
    b = b_bank[_ids(row_adapter)].float()            # [R, rank, dout]
    return torch.einsum("br,bro->bo", t, b)


def lora_delta_plain(x, a_bank, b_bank, row_adapter):
    """Plain version (kernel_gen.lora_delta_reference): per-row gathered
    factors, the two-step product in fp32. x [R, din], a_bank [slots,
    din, rank], b_bank [slots, rank, dout], row_adapter [R] slot ids (a
    tensor on x's device, or a LoraRows) → [R, dout] fp32."""
    return lora_expand_plain(lora_shrink_plain(x, a_bank, row_adapter),
                             b_bank, row_adapter)


def lora_deltas(x, bank_pairs, rows):
    """The batched-LoRA deltas [R, dout] fp32 of x [R, din] against each
    (A, B) bank pair of targets that share x: for CUDA tensors one shrink
    kernel for all of them (at most two) and one expand a target (which
    raise where they cannot launch), for CPU tensors the plain version a
    target. rows: a LoraRows, or host slot ids."""
    rows = as_lora_rows(rows, x.device)
    if x.device.type == "cpu":
        return [lora_delta_plain(x, a, b, rows) for a, b in bank_pairs]
    return cuda_lora.lora_segmented_deltas(x, bank_pairs, rows)


def lora_delta(x, a_bank, b_bank, rows):
    """The batched-LoRA delta [R, dout] fp32 of x [R, din] (``lora_deltas``
    of one target). rows: a LoraRows, or host slot ids."""
    return lora_deltas(x, [(a_bank, b_bank)], rows)[0]


def apply_lora_deltas(ys, x, lora: Optional[dict], targets):
    """Each y of ys + its target's adapter delta, all computed from x
    [R, din] or [B, S, din] (rows over the flattened rows: a [B, S]
    chunk's LoraRows is built with repeat=S), in y's dtype; targets that
    `lora` does not carry leave their y unchanged. On the card the targets
    share one shrink launch."""
    if lora is None:
        return tuple(ys)
    have = [i for i, t in enumerate(targets) if t in lora["banks"]]
    rows = lora["row_adapter"]
    flat = x.reshape(-1, x.shape[-1])
    if have and flat.shape[0] != rows.rows:
        raise ValueError(f"lora: {flat.shape[0]} rows of x, {rows.rows} "
                         "row adapter ids")
    ds = lora_deltas(flat.contiguous(),
                     [lora["banks"][targets[i]] for i in have], rows) \
        if have else []
    out = list(ys)
    for i, d in zip(have, ds):
        out[i] = out[i] + d.reshape(*x.shape[:-1], d.shape[-1]).to(
            out[i].dtype)
    return tuple(out)


def apply_lora_delta(y, x, lora: Optional[dict], target: str):
    """y + target's adapter delta (computed from x) in y's dtype, when
    `lora` carries that target; y unchanged otherwise."""
    return apply_lora_deltas((y,), x, lora, (target,))[0]
