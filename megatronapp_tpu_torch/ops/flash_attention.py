"""Flash attention with its gradient (the JAX package's
ops/pallas/flash_attention.py:flash_attention).

A ``torch.autograd.Function`` around the kernels of
``ops/cuda/flash_attention.py``: the forward runs flash_fwd and saves
(q, k, v, out, lse); the backward computes delta = sum(g · out) in fp32
outside the kernels, then runs flash_bwd_dq and flash_bwd_dkv. CPU tensors
run the plain versions, CUDA tensors the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from megatronapp_tpu_torch.ops.cuda.flash_attention import (  # noqa: F401
    flash_backward, flash_backward_plain, flash_forward, flash_forward_plain,
)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, softmax_scale):
        out, lse = flash_forward(q, k, v, causal, softmax_scale, segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.softmax_scale = causal, softmax_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(),
                                    ctx.causal, ctx.softmax_scale,
                                    segment_ids)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    block_q: int = 512, block_kv: int = 512,
                    segment_ids: Optional[torch.Tensor] = None,
                    head_fold: bool = False) -> torch.Tensor:
    """Flash attention on [B, S, H, D] tensors (GQA: q head h reads kv
    head h // (Hq / Hkv)). Returns [B, Sq, Hq, D].

    segment_ids [B, S]: attention only within equal ids (packed
    sequences). block_q / block_kv are the TPU kernel's tile sizes and
    head_fold its 128-lane layout for D <= 64; both are accepted for
    signature parity and select nothing here: the CUDA kernels use their
    own tiles (the forward 128 q × 128 kv rows at D 128 and 64 × 64 at
    D 64; dq 64 q rows; dk/dv 128 kv rows at D 128, 64 at D 64) and
    compute the same function for every layout."""
    del block_q, block_kv, head_fold
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal),
                                 softmax_scale)
