"""GPT model (the JAX package's models/gpt.py): init, the embedding, the
rope tables, the head, and the training forward and loss (with the MTP
heads' auxiliary loss, transformer/mtp.py)."""

from __future__ import annotations

import torch

from megatronapp_tpu_torch.config.transformer_config import (
    NormKind, PositionEmbeddingKind, TransformerConfig,
)
from typing import Optional

from megatronapp_tpu_torch.ops import rotary
from megatronapp_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatronapp_tpu_torch.ops.normalization import apply_norm
from megatronapp_tpu_torch.scope.hooks import scope_capture
from megatronapp_tpu_torch.transformer.block import (
    block_forward, init_block_params,
)
from megatronapp_tpu_torch.utils.params import ParamTree, normal


def init_gpt_params(cfg: TransformerConfig, generator: torch.Generator,
                    device) -> ParamTree:
    """Random weights made directly on `device` from `generator` (the
    generator must live on the same device). Leaves as in the JAX
    package: embedding.word [V, H] (+ embedding.pos), layers.i.*,
    final_ln_scale (+ final_ln_bias), output [H, V] when untied, and
    mtp.d.* (the MTP depth modules) when cfg.mtp_num_layers."""
    std, dt = cfg.init_method_std, cfg.params_dtype
    h, v = cfg.hidden_size, cfg.vocab_size
    emb = {"word": normal((v, h), std, dt, generator, device)}
    if cfg.position_embedding == PositionEmbeddingKind.learned_absolute:
        emb["pos"] = normal((cfg.max_position_embeddings, h), std, dt,
                            generator, device)
    top = {"final_ln_scale": torch.ones(h, dtype=dt, device=device)}
    if cfg.normalization == NormKind.layernorm:
        top["final_ln_bias"] = torch.zeros(h, dtype=dt, device=device)
    if cfg.untie_embeddings_and_output_weights:
        top["output"] = normal((h, v), std, dt, generator, device)
    children = {"embedding": ParamTree(emb),
                "layers": init_block_params(cfg, generator, device)}
    if cfg.mtp_num_layers:
        from megatronapp_tpu_torch.transformer.mtp import init_mtp_params
        children["mtp"] = init_mtp_params(cfg, generator, device)
    return ParamTree(top, **children)


def gpt_embed(p, tokens: torch.Tensor, cfg: TransformerConfig,
              position_ids: Optional[torch.Tensor] = None,
              position_offset: int = 0) -> torch.Tensor:
    """tokens [B, S] at position_ids [B, S] (or [B, 1]; default 0..S-1),
    shifted by position_offset (a dense cache's append position) →
    embeddings [B, S, H] in the compute dtype."""
    emb = p["embedding"]
    h = emb["word"][tokens.long()]
    if "pos" in emb:
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :]
        h = h + emb["pos"][position_ids.long() + position_offset]
    return h.to(cfg.compute_dtype)


def rope_params(cfg: TransformerConfig, device=None):
    """(inv_freq, mscale) for the configured rope variant, or (None,
    1.0). MLA ropes only its decoupled qk_pos_emb_head_dim heads (JAX
    models/gpt.py:116)."""
    rope_dim = (cfg.qk_pos_emb_head_dim if cfg.multi_latent_attention
                else cfg.head_dim)
    if cfg.position_embedding == PositionEmbeddingKind.rope:
        return rotary.rope_frequencies(rope_dim, cfg.rotary_base,
                                       cfg.rotary_percent, device), 1.0
    if cfg.position_embedding == PositionEmbeddingKind.yarn:
        inv_freq = rotary.yarn_frequencies(
            rope_dim, cfg.rotary_base,
            scaling_factor=cfg.rope_scaling_factor,
            original_max_position=cfg.yarn_original_max_position,
            beta_fast=cfg.yarn_beta_fast, beta_slow=cfg.yarn_beta_slow,
            rotary_percent=cfg.rotary_percent, device=device)
        return inv_freq, rotary.yarn_mscale(cfg.rope_scaling_factor,
                                            cfg.yarn_mscale_coeff)
    return None, 1.0


def gpt_rope_tables(cfg: TransformerConfig, seq_len: int, device=None,
                    positions: Optional[torch.Tensor] = None):
    """Rope cos/sin tables over positions [0, seq_len), or over explicit
    per-token `positions` ([B, S] for packed sequences → [B, S, half]);
    (None, None) without rope."""
    inv_freq, m = rope_params(cfg, device)
    if inv_freq is None:
        return None, None
    if positions is None:
        positions = torch.arange(seq_len, device=device)
    cos, sin = rotary.rope_cos_sin(positions, inv_freq)
    if m != 1.0:
        cos, sin = cos * m, sin * m
    return cos, sin


def gpt_head(p, h: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Final norm + vocab projection. h [..., S, H] → logits fp32."""
    h = apply_norm(cfg.normalization, h, p["final_ln_scale"],
                   p.get("final_ln_bias"), cfg.layernorm_epsilon)
    out_kernel = p["output"] if "output" in p else p["embedding"]["word"].T
    dt = cfg.compute_dtype
    logits = scope_capture("result", h.to(dt) @ out_kernel.to(dt))
    return logits.float()


def packed_position_ids(segment_ids: torch.Tensor) -> torch.Tensor:
    """Positions restart at 0 at each segment boundary (--reset-position-
    ids). [B, S] → [B, S] int32."""
    b, s = segment_ids.shape
    idx = torch.arange(s, device=segment_ids.device)[None, :].expand(b, s)
    is_start = torch.ones_like(segment_ids, dtype=torch.bool)
    is_start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return (idx - seg_start).to(torch.int32)


def gpt_forward(p, tokens: torch.Tensor, cfg: TransformerConfig,
                attention_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None, ctx=None,
                return_hidden: bool = False):
    """tokens [B, S] → (logits [B, S, V] fp32, moe_aux_loss). segment_ids
    [B, S]: packed sequences — positions restart per segment (for the
    learned embedding and the rope tables) and attention stays within a
    segment. return_hidden: also the main stack's output [B, S, H] (before
    the final norm) and the rope tables (cos, sin), for the MTP heads. The
    zigzag context-parallel layout comes with the parallel-training
    slice."""
    if ctx is not None:
        raise NotImplementedError(
            "context-parallel (zigzag) and tensor-parallel training "
            "forwards are not ported yet (the parallel-training slice, "
            "ROADMAP.md Queue 1): a serving ctx rides the engine's paged "
            "steps (inference/dynamic_engine.py), not gpt_forward")
    positions = None
    if segment_ids is not None:
        positions = packed_position_ids(segment_ids)
    h = gpt_embed(p, tokens, cfg, position_ids=positions)
    cos, sin = gpt_rope_tables(cfg, tokens.shape[1], tokens.device,
                               positions=positions)
    h, aux = block_forward(p["layers"], h, cfg, cos, sin, attention_mask,
                           segment_ids=segment_ids)
    logits = gpt_head(p, h, cfg)
    if return_hidden:
        return logits, aux, h, (cos, sin)
    return logits, aux


def gpt_loss(p, tokens: torch.Tensor, targets: torch.Tensor,
             loss_mask: Optional[torch.Tensor], cfg: TransformerConfig,
             segment_ids: Optional[torch.Tensor] = None, ctx=None):
    """Training loss (CE + MoE aux, + the scaled MTP loss when
    cfg.mtp_num_layers) → (loss, {"lm_loss", "moe_aux_loss"[,
    "mtp_loss"]}); mtp_loss is the unscaled mean over depths (JAX
    gpt.py:239-275)."""
    if not cfg.mtp_num_layers:
        logits, aux = gpt_forward(p, tokens, cfg, segment_ids=segment_ids,
                                  ctx=ctx)
        loss, _ = cross_entropy_loss(logits, targets, loss_mask)
        return loss + aux, {"lm_loss": loss, "moe_aux_loss": aux}
    if segment_ids is not None:
        raise NotImplementedError(
            "multi token prediction + sequence packing is not "
            "supported (reference multi_token_prediction.py assert)")
    from megatronapp_tpu_torch.transformer.mtp import mtp_loss
    logits, aux, hid, (cos, sin) = gpt_forward(p, tokens, cfg, ctx=ctx,
                                               return_hidden=True)
    scaled, mean, layer_aux = mtp_loss(
        p["mtp"], hid, lambda t: gpt_embed(p, t, cfg),
        lambda hh: gpt_head(p, hh, cfg), tokens, targets, loss_mask, cfg,
        cos, sin)
    aux = aux + layer_aux
    loss, _ = cross_entropy_loss(logits, targets, loss_mask)
    return loss + aux + scaled, {"lm_loss": loss, "moe_aux_loss": aux,
                                 "mtp_loss": mean}
