"""Sampling parameters, padded-vocab masking and the dense per-slot KV
cache with its forward (the pieces of the JAX package's
inference/engine.py the dynamic engine and the speculative draft model
use; the static engine comes with a later slice)."""

from __future__ import annotations

import dataclasses

import torch

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig

# MLA's compressed dense cache and the dense-slot target engine.
DENSE_MLA_UNPORTED = (
    "MLA's dense slot cache is not ported yet (ROADMAP.md Queue 1 item "
    "6): an MLA model serves through the paged pools and cannot be a "
    "draft model")


@dataclasses.dataclass
class SamplingParams:
    """Reference common_inference_params/SamplingParams."""
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 0.0      # 0 = disabled
    greedy: bool = False
    seed: int = 0


def mask_padded_vocab(logits: torch.Tensor, cfg: TransformerConfig
                      ) -> torch.Tensor:
    """Mask logits for vocab rows beyond the tokenizer's true vocab to
    -1e30, so padded ids can never be sampled."""
    true_v = cfg.true_vocab_size
    if true_v is None or true_v >= logits.shape[-1]:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < true_v, logits, torch.full_like(logits, -1e30))


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None):
    """Dense per-slot decode cache (JAX engine.py:129): K and V [L, B,
    S_max, Hkv, D] in the compute dtype, zeros."""
    if cfg.multi_latent_attention:
        raise NotImplementedError(DENSE_MLA_UNPORTED)
    shape = (cfg.num_layers, batch, max_len, cfg.num_query_groups,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


@torch.no_grad()
def _forward_with_cache(p, tokens: torch.Tensor, cache, cache_index: int,
                        cfg: TransformerConfig):
    """tokens [B, S] starting at position cache_index → (logits [B, S, V]
    fp32, cache) (JAX engine.py:147): every layer appends its K/V at
    [cache_index, cache_index + S) of its cache slice IN PLACE and
    attends causally over the cache."""
    from megatronapp_tpu_torch.models.gpt import (
        gpt_embed, gpt_head, gpt_rope_tables,
    )
    from megatronapp_tpu_torch.transformer.block import layer_forward
    s = tokens.shape[1]
    h = gpt_embed(p, tokens, cfg, position_offset=cache_index)
    cos, sin = gpt_rope_tables(cfg, s, device=tokens.device,
                               positions=cache_index + torch.arange(
                                   s, device=tokens.device))
    ck, cv = cache
    for lid, layer_p in enumerate(p["layers"]):
        (h, _), _ = layer_forward(layer_p, h, cfg, cos, sin,
                                  kv_cache=(ck[lid], cv[lid]),
                                  cache_index=cache_index)
    return gpt_head(p, h, cfg), cache
