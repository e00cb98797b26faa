"""Dense dot-product attention (the JAX package's ops/attention.py):
scaled QK^T in fp32, causal -1e30 mask, optional keep-mask, fp32 softmax,
context product in V's dtype. The training path takes it below
flash_min_seq; it is also the oracle the flash kernels are tested
against. Layout [B, S, H, D]."""

from __future__ import annotations

import math
from typing import Optional

import torch

from megatronapp_tpu_torch.config.transformer_config import AttnMaskType
from megatronapp_tpu_torch.scope.hooks import scope_capture


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Broadcast KV heads to query heads ([B,S,Hkv,D] → [B,S,H,D])."""
    n_kv = k.shape[2]
    if n_kv == num_heads:
        return k
    return k.repeat_interleave(num_heads // n_kv, dim=2)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_type: AttnMaskType = AttnMaskType.causal,
                          attention_mask: Optional[torch.Tensor] = None,
                          softmax_scale: Optional[float] = None,
                          softmax_in_fp32: bool = True,
                          q_offset: int = 0, layer_id=None) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,Hkv,D] → context [B,Sq,H,D] in v's dtype.
    attention_mask [B,1,Sq,Skv] bool, True = keep. q_offset: absolute
    position of q[0] relative to k[0]. layer_id: MegaScope's attribution
    of the 'attention_probs' capture ([B,H,Sq,Skv] fp32 probabilities),
    taken only when given, as the JAX function gates it (the transformer
    layer threads it; other callers do not)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    # Products of the input dtype accumulated and kept in fp32
    # (preferred_element_type=float32 on the JAX side).
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * softmax_scale
    if mask_type == AttnMaskType.causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kv_pos = torch.arange(skv, device=q.device)[None, :]
        scores = scores.masked_fill(~(q_pos >= kv_pos), -1e30)
    if attention_mask is not None:
        scores = scores.masked_fill(~attention_mask, -1e30)
    # The scores are fp32 either way (as on the JAX side, where
    # softmax_in_fp32 only re-casts fp32 scores), so the flag changes
    # nothing.
    del softmax_in_fp32
    probs = torch.softmax(scores, dim=-1)
    if layer_id is not None:
        probs = scope_capture("attention_probs", probs, layer_id)
    probs = probs.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
