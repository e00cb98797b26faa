"""Sampling parameters and padded-vocab masking (the pieces of the JAX
package's inference/engine.py the dynamic engine uses; the static engine
comes with a later slice)."""

from __future__ import annotations

import dataclasses

import torch

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig


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
