"""Named model-family presets (the JAX package's models/presets.py, same
widths): the dense GPT and llama ones and mixtral-8x7b, the MoE one."""

from __future__ import annotations

from megatronapp_tpu_torch.config.transformer_config import (
    ActivationKind, NormKind, PositionEmbeddingKind, TransformerConfig,
)


def gpt2_125m(**kw) -> TransformerConfig:
    d = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
             vocab_size=50304, true_vocab_size=50257,
             max_position_embeddings=1024,
             position_embedding=PositionEmbeddingKind.learned_absolute,
             add_qkv_bias=True)
    d.update(kw)
    return TransformerConfig(**d)


def gpt3_2p7b(**kw) -> TransformerConfig:
    d = dict(num_layers=32, hidden_size=2560, num_attention_heads=32,
             vocab_size=50304, max_position_embeddings=2048)
    d.update(kw)
    return TransformerConfig(**d)


def gpt_16l_2048h(**kw) -> TransformerConfig:
    d = dict(num_layers=16, hidden_size=2048, num_attention_heads=32,
             vocab_size=50304, max_position_embeddings=2048)
    d.update(kw)
    return TransformerConfig(**d)


def llama3_8b(**kw) -> TransformerConfig:
    d = dict(num_layers=32, hidden_size=4096, num_attention_heads=32,
             num_query_groups=8, ffn_hidden_size=14336, vocab_size=128256,
             max_position_embeddings=8192, rotary_base=500000.0,
             activation=ActivationKind.swiglu,
             normalization=NormKind.rmsnorm, add_bias_linear=False,
             untie_embeddings_and_output_weights=True)
    d.update(kw)
    return TransformerConfig(**d)


def mixtral_8x7b(**kw) -> TransformerConfig:
    """examples/mixtral parity: 8 experts, top-2, GQA-8."""
    d = dict(num_layers=32, hidden_size=4096, num_attention_heads=32,
             num_query_groups=8, ffn_hidden_size=14336, vocab_size=32000,
             max_position_embeddings=32768, rotary_base=1e6,
             activation=ActivationKind.swiglu,
             normalization=NormKind.rmsnorm, add_bias_linear=False,
             untie_embeddings_and_output_weights=True,
             num_moe_experts=8, moe_router_topk=2,
             moe_ffn_hidden_size=14336, moe_aux_loss_coeff=0.02)
    d.update(kw)
    return TransformerConfig(**d)


PRESETS = {
    "gpt2-125m": gpt2_125m,
    "gpt3-2.7b": gpt3_2p7b,
    "gpt-16l-2048h": gpt_16l_2048h,
    "llama3-8b": llama3_8b,
    "mixtral-8x7b": mixtral_8x7b,
}
