"""FLOPs per token for throughput and MFU (the JAX package's
utils/flops.py:flops_per_token, without its TPU peak table)."""

from __future__ import annotations

from megatronapp_tpu_torch.config.transformer_config import (
    ActivationKind, TransformerConfig,
)


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """Forward + backward FLOPs per token (3x the forward's matmul FLOPs:
    projections, attention scores and context over seq_len kv positions,
    MLP, logits)."""
    h = cfg.hidden_size
    d = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_query_groups
    proj = 2 * h * (nq * d) + 2 * h * (2 * nkv * d) + 2 * (nq * d) * h
    attn = 2 * 2 * seq_len * nq * d
    f = cfg.ffn_hidden_size
    if cfg.is_moe:
        f = cfg.moe_ffn_hidden_size * cfg.moe_router_topk
        if cfg.moe_shared_expert_intermediate_size:
            f += cfg.moe_shared_expert_intermediate_size
    gated = cfg.activation in (ActivationKind.swiglu, ActivationKind.geglu)
    mlp = (3 if gated else 2) * 2 * h * f
    fwd = cfg.num_layers * (proj + attn + mlp) + 2 * h * cfg.vocab_size
    return 3.0 * fwd
