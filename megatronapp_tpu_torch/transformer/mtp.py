"""Multi-token prediction (MTP) heads (the JAX package's
transformer/mtp.py, Megatron's MultiTokenPredictionLayer, DeepSeek-V3's
recipe).

D sequential depth modules each predict one more future token while
keeping the causal chain: depth k combines RMSNorm(h^{k-1}) with
RMSNorm(emb(t_{i+k})) through a 2H → H projection, runs one transformer
layer (the port's ``layer_forward``, so its attention takes the flash
kernels where the main stack does) and scores with the SHARED output
head; the auxiliary loss is mtp_loss_scaling_factor × the mean over
depths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatronapp_tpu_torch.ops.normalization import rms_norm
from megatronapp_tpu_torch.transformer.block import (
    init_layer_params, layer_forward,
)
from megatronapp_tpu_torch.utils.params import ParamTree, normal


def init_mtp_params(cfg: TransformerConfig, generator: torch.Generator,
                    device) -> nn.ModuleList:
    """[D] depth modules: hnorm_scale, enorm_scale, proj [2H, H] and one
    transformer layer each (the embedding and the head are the main
    model's)."""
    h, dt = cfg.hidden_size, cfg.params_dtype
    depths = []
    for _ in range(cfg.mtp_num_layers or 0):
        depths.append(ParamTree(
            {"hnorm_scale": torch.ones(h, dtype=dt, device=device),
             "enorm_scale": torch.ones(h, dtype=dt, device=device),
             "proj": normal((2 * h, h), cfg.init_method_std, dt, generator,
                            device)},
            layer=init_layer_params(cfg, generator, device)))
    return nn.ModuleList(depths)


def mtp_combine(dp, h: torch.Tensor, emb: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """A depth's input: [RMSNorm(h), RMSNorm(emb)] @ proj in the compute
    dtype."""
    eps = cfg.layernorm_epsilon
    x = torch.cat([rms_norm(h, dp["hnorm_scale"], eps),
                   rms_norm(emb, dp["enorm_scale"], eps)],
                  dim=-1).to(cfg.compute_dtype)
    return x @ dp["proj"].to(cfg.compute_dtype)


def mtp_loss(mtp_params, h: torch.Tensor, embed_fn, head_fn,
             tokens: torch.Tensor, labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor], cfg: TransformerConfig,
             rope_cos=None, rope_sin=None, ctx=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The auxiliary MTP loss. h [B, S, H]: the main stack's output (before
    the final norm and head); embed_fn(tokens) → [B, S, H]; head_fn(h) →
    logits. Depth k (1-based) predicts the labels rolled left by k, the
    trailing k positions masked out.

    Returns (scaled_total, per_depth_mean, layer_aux): add scaled_total
    and layer_aux (the depth layers' own router losses; zero for dense
    layers) to the LM loss, and log per_depth_mean. ctx: a dp-only
    training grid (each depth's token mean then spans every dp rank's
    rows, ops/cross_entropy.py)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if len(mtp_params) == 0:
        return zero, zero, zero
    b, s = tokens.shape
    if loss_mask is None:
        loss_mask = torch.ones((b, s), dtype=torch.float32,
                               device=tokens.device)
    total = zero
    pos = torch.arange(s, device=tokens.device)
    for k, dp in enumerate(mtp_params, start=1):
        # The embedding of token t_{i+k} at position i.
        x = mtp_combine(dp, h, embed_fn(torch.roll(tokens, -k, dims=1)),
                        cfg)
        (h, _), _ = layer_forward(dp["layer"], x, cfg, rope_cos, rope_sin,
                                  None, layer_id=None)
        logits = head_fn(h)
        labels_k = torch.roll(labels, -k, dims=1)
        # Positions whose target rolled past the end count nothing.
        valid = (pos < s - k).to(torch.float32)[None, :]
        mask_k = torch.roll(loss_mask.float(), -k, dims=1) * valid
        loss_k, _ = cross_entropy_loss(logits, labels_k, mask_k, ctx=ctx)
        total = total + loss_k
    mean = total / len(mtp_params)
    return cfg.mtp_loss_scaling_factor * mean, mean, zero
