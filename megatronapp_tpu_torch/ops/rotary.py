"""Rotary position embeddings (RoPE) + YaRN scaling, half-rotation
(GPT-NeoX) layout — the JAX package's ops/rotary.py."""

from __future__ import annotations

import math

import torch


def rope_frequencies(head_dim: int, base: float = 10000.0,
                     rotary_percent: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies [rot_dim/2] in fp32."""
    rot_dim = int(head_dim * rotary_percent)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32,
                                        device=device), exponent)


def yarn_frequencies(head_dim: int, base: float = 10000.0,
                     scaling_factor: float = 1.0,
                     original_max_position: int = 4096,
                     beta_fast: float = 32.0, beta_slow: float = 1.0,
                     rotary_percent: float = 1.0,
                     device=None) -> torch.Tensor:
    """YaRN NTK-by-parts interpolation of RoPE frequencies: low-frequency
    dims are interpolated by 1/scaling_factor, high-frequency dims keep
    extrapolation, with a linear ramp between correction bounds."""
    rot_dim = int(head_dim * rotary_percent)
    rot_dim -= rot_dim % 2
    freq_extra = rope_frequencies(head_dim, base, rotary_percent, device)
    freq_inter = freq_extra / scaling_factor

    def correction_dim(num_rotations):
        return (rot_dim * math.log(original_max_position /
                                   (num_rotations * 2 * math.pi))) / \
               (2 * math.log(base))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), rot_dim - 1)
    ramp = (torch.arange(rot_dim // 2, dtype=torch.float32, device=device)
            - low) / max(high - low, 1)
    ramp = ramp.clamp(0.0, 1.0)
    # ramp==0 → extrapolation (high freq); ramp==1 → interpolation.
    return freq_extra * (1 - ramp) + freq_inter * ramp


def yarn_mscale(scaling_factor: float, mscale_coeff: float = 0.1) -> float:
    if scaling_factor <= 1.0:
        return 1.0
    return 1.0 + mscale_coeff * math.log(scaling_factor)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """cos/sin tables [...seq, rot_dim/2] for int positions [...seq]."""
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-rotation RoPE. x [batch, seq, heads, head_dim]; cos/sin
    [seq, rot_dim/2] or [batch, seq, rot_dim/2]. Rotates the first
    rot_dim features and passes the rest through."""
    half = cos.shape[-1]
    rot_dim = 2 * half
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    if cos.dim() == 2:          # [seq, half] → broadcast over batch, heads
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:                       # [batch, seq, half]
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out
