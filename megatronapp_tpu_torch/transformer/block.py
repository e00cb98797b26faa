"""Transformer layer (the JAX package's transformer/block.py, plain body).

The JAX package stacks per-layer params along a leading L axis and walks
them with ``lax.scan``; here each layer is one ``ParamTree`` in an
``nn.ModuleList`` and callers loop over it. Pre-LN residual structure:
input norm → attention → +residual → pre-MLP norm → MLP → +residual.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from megatronapp_tpu_torch.config.transformer_config import (
    NormKind, TransformerConfig,
)
from megatronapp_tpu_torch.ops.normalization import apply_norm
from megatronapp_tpu_torch.transformer.attention import (
    attention_forward, init_attention_params,
)
from megatronapp_tpu_torch.transformer.mlp import init_mlp_params, mlp_forward
from megatronapp_tpu_torch.utils.params import ParamTree


def _check_dense(cfg: TransformerConfig):
    if cfg.is_moe or cfg.multi_latent_attention:
        raise NotImplementedError(
            "MoE and MLA layers are not ported yet (the serving-extension "
            "and parallel-training slices)")


def init_layer_params(cfg: TransformerConfig, generator: torch.Generator,
                      device) -> ParamTree:
    """One layer's params. Residual-out projections use the scaled init
    std / sqrt(2 * num_layers)."""
    _check_dense(cfg)
    out_std = cfg.init_method_std / math.sqrt(2.0 * cfg.num_layers)
    h, dt = cfg.hidden_size, cfg.params_dtype
    leaves = {"ln1_scale": torch.ones(h, dtype=dt, device=device),
              "ln2_scale": torch.ones(h, dtype=dt, device=device)}
    if cfg.normalization == NormKind.layernorm:
        leaves["ln1_bias"] = torch.zeros(h, dtype=dt, device=device)
        leaves["ln2_bias"] = torch.zeros(h, dtype=dt, device=device)
    return ParamTree(
        leaves,
        attention=init_attention_params(cfg, generator, device, out_std),
        mlp=init_mlp_params(cfg, generator, device, out_std))


def init_block_params(cfg: TransformerConfig, generator: torch.Generator,
                      device) -> nn.ModuleList:
    return nn.ModuleList(init_layer_params(cfg, generator, device)
                         for _ in range(cfg.num_layers))


def layer_forward(p, x: torch.Tensor, cfg: TransformerConfig,
                  rope_cos=None, rope_sin=None, attention_mask=None,
                  kv_cache=None, cache_index=None,
                  cache_positions=None, page_table=None,
                  chunk_counts=None, write_index=None,
                  fused_decode: bool = False):
    """One transformer layer. x: [B,S,H] → ((out, new_cache), aux_losses);
    the paged arguments are attention_forward's."""
    if fused_decode:
        raise NotImplementedError(
            "fused (megakernel) decode is not ported yet (the "
            "serving-extension slice)")
    _check_dense(cfg)
    residual = x
    h = apply_norm(cfg.normalization, x, p["ln1_scale"], p.get("ln1_bias"),
                   cfg.layernorm_epsilon)
    attn_out, new_cache = attention_forward(
        p["attention"], h, cfg, rope_cos, rope_sin, attention_mask,
        kv_cache=kv_cache, cache_index=cache_index,
        cache_positions=cache_positions, page_table=page_table,
        chunk_counts=chunk_counts, write_index=write_index)
    x = residual + attn_out.to(residual.dtype)
    residual = x
    h = apply_norm(cfg.normalization, x, p["ln2_scale"], p.get("ln2_bias"),
                   cfg.layernorm_epsilon)
    x = residual + mlp_forward(p["mlp"], h, cfg).to(residual.dtype)
    return (x, new_cache), None
