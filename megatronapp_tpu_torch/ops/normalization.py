"""LayerNorm / RMSNorm, computed in fp32 and cast back to the input dtype
(the JAX package's ops/normalization.py)."""

from __future__ import annotations

import torch

from megatronapp_tpu_torch.config.transformer_config import NormKind


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dtype)


def apply_norm(kind: NormKind, x, scale, bias=None, eps: float = 1e-5):
    if kind == NormKind.rmsnorm:
        return rms_norm(x, scale, eps)
    return layer_norm(x, scale, bias, eps)
