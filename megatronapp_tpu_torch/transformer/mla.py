"""Multi-latent attention (MLA, DeepSeek-style): the JAX package's
transformer/mla.py, its paged serving branches and its dense no-cache
branch.

Queries (optionally) and keys/values project through low-rank latents;
position information flows only through small decoupled rope heads
(qk_pos_emb_head_dim), so the KV cache compresses to one normed latent row
[kv_lora_rank] and one shared roped key row [qk_pos_emb_head_dim] per
token.

Param leaves (per layer, the JAX [in, out] layout):
  q_proj      [H, nq*(dqk + dpe)]      or  q_down [H, q_lora_rank],
                                           q_ln_scale [q_lora_rank],
                                           q_up [q_lora_rank, nq*(dqk + dpe)]
  kv_down     [H, klat + dpe]          (latent | shared k_pe)
  kv_ln_scale [klat]
  kv_up       [klat, nq*(dqk + dv)]    (per head: k_nope | v)
  out_kernel  [nq*dv, H]               (may be a resident int8 leaf)

The paged branches (decode and the ragged multi-token chunk) append the
latent and roped-key rows to the layer's pools (quantized per row with
their scales for int8/fp8 pools) and attend in latent space: q_nope is
absorbed through kv_up's k_nope columns (times YaRN's mscale² — the cached
latent is unscaled), and the latent kernel (ops/cuda/paged_latent.py)
reads the pools through the page table and expands its output through
kv_up's v columns, so the history is never gathered or re-expanded.

Tensor-parallel serving (``ctx``) shards the latent pool on its columns
and attends through the two-phase tp body (ops/paged_attention.py
``paged_attention_latent_tp``).

MegaScope's sites are the JAX layer's: the 'weight' disturbance on
q_proj, kv_down and out_kernel, the qkv_q/qkv_k/qkv_v captures of the
dense branch (q and k with their rope heads), qkv_q (the scaled q_nope
beside the roped q_pe) and 'context' on the paged branches.

Not ported: the dense slot cache (``cache_positions`` without a page
table), context-parallel MLA, and the paged branches' reconstituted k/v
captures (the JAX layer gathers the whole history through the page table
and expands it through kv_up when qkv_k or qkv_v is on).
"""

from __future__ import annotations

from typing import Optional

import torch

from megatronapp_tpu_torch.config.transformer_config import (
    PositionEmbeddingKind, TransformerConfig,
)
from megatronapp_tpu_torch.ops import rotary
from megatronapp_tpu_torch.ops.attention import dot_product_attention
from megatronapp_tpu_torch.ops.normalization import rms_norm
from megatronapp_tpu_torch.ops.paged_attention import (
    WriteIndex, paged_attention_latent, paged_attention_latent_tp, write_kv,
)
from megatronapp_tpu_torch.scope import hooks
from megatronapp_tpu_torch.scope.hooks import scope_capture
from megatronapp_tpu_torch.transformer.attention import weight_of
from megatronapp_tpu_torch.utils.params import ParamTree, normal


def init_mla_params(cfg: TransformerConfig, generator: torch.Generator,
                    device, out_std: float) -> ParamTree:
    """One layer's MLA leaves (JAX transformer/mla.py:32), drawn on
    `device` from `generator`: both q paths (q_proj, or q_down / q_ln_scale
    / q_up when cfg.q_lora_rank is set)."""
    h, nq = cfg.hidden_size, cfg.num_attention_heads
    dqk, dpe, dv = cfg.qk_head_dim, cfg.qk_pos_emb_head_dim, cfg.v_head_dim
    klat, std, dt = cfg.kv_lora_rank, cfg.init_method_std, cfg.params_dtype
    p = {}
    if cfg.q_lora_rank:
        p["q_down"] = normal((h, cfg.q_lora_rank), std, dt, generator,
                             device)
        p["q_ln_scale"] = torch.ones(cfg.q_lora_rank, dtype=dt,
                                     device=device)
        p["q_up"] = normal((cfg.q_lora_rank, nq * (dqk + dpe)), std, dt,
                           generator, device)
    else:
        p["q_proj"] = normal((h, nq * (dqk + dpe)), std, dt, generator,
                             device)
    p["kv_down"] = normal((h, klat + dpe), std, dt, generator, device)
    p["kv_ln_scale"] = torch.ones(klat, dtype=dt, device=device)
    p["kv_up"] = normal((klat, nq * (dqk + dv)), std, dt, generator, device)
    p["out_kernel"] = normal((nq * dv, h), out_std, dt, generator, device)
    return ParamTree(p)


def yarn_m(cfg: TransformerConfig) -> float:
    """YaRN's mscale (1.0 without YaRN)."""
    if cfg.position_embedding == PositionEmbeddingKind.yarn:
        return rotary.yarn_mscale(cfg.rope_scaling_factor,
                                  cfg.yarn_mscale_coeff)
    return 1.0


def mla_softmax_scale(cfg: TransformerConfig) -> float:
    """1/sqrt(qk_head_dim + qk_pos_emb_head_dim)."""
    return 1.0 / float((cfg.qk_head_dim + cfg.qk_pos_emb_head_dim) ** 0.5)


def kv_up_heads(p, cfg: TransformerConfig):
    """(wk [klat, nq, dqk], w_v [klat, nq, dv]): views of kv_up in the
    compute dtype (no copy when it is stored in that dtype)."""
    nq, dqk, dv = cfg.num_attention_heads, cfg.qk_head_dim, cfg.v_head_dim
    kvu = p["kv_up"].to(cfg.compute_dtype).reshape(cfg.kv_lora_rank, nq,
                                                   dqk + dv)
    return kvu[..., :dqk], kvu[..., dqk:]


def latent_attention(q_lat, q_pe, kv_cache, kv_scales, page_table,
                     cache_positions, counts, w_v, cfg: TransformerConfig,
                     ctx=None):
    """Attention of the absorbed queries q_lat [B, S, nq, klat] and roped
    q_pe [B, S, nq, dpe] over a layer's latent pools through the latent
    kernel: ragged with q_lens = counts [B], or decode (counts None, S ==
    1). ctx: a tensor-parallel rank — q_lat, the latent pool and w_v hold
    its latent columns, and the two-phase tp body
    (``paged_attention_latent_tp``) replaces the latent kernel. Returns
    [B, S, nq, dv]."""
    c_lat, c_pe = kv_cache
    sc = ({} if kv_scales is None
          else dict(zip(("lat_scales", "pe_scales"), kv_scales)))
    scale = mla_softmax_scale(cfg)
    if ctx is not None:
        if counts is not None:
            return paged_attention_latent_tp(
                q_lat, q_pe, c_lat, c_pe, page_table,
                cache_positions + counts, w_v, ctx, q_lens=counts,
                softmax_scale=scale, **sc)
        return paged_attention_latent_tp(
            q_lat[:, 0], q_pe[:, 0], c_lat, c_pe, page_table,
            cache_positions + 1, w_v, ctx, softmax_scale=scale,
            **sc)[:, None]
    if counts is not None:
        return paged_attention_latent(
            q_lat.contiguous(), q_pe.contiguous(), c_lat, c_pe, page_table,
            cache_positions + counts, w_v, q_lens=counts,
            softmax_scale=scale, **sc)
    return paged_attention_latent(
        q_lat[:, 0].contiguous(), q_pe[:, 0].contiguous(), c_lat, c_pe,
        page_table, cache_positions + 1, w_v, softmax_scale=scale,
        **sc)[:, None]


def mla_forward(p, x: torch.Tensor, cfg: TransformerConfig,
                rope_cos: Optional[torch.Tensor] = None,
                rope_sin: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_cache=None, cache_positions=None, page_table=None,
                chunk_counts=None, write_index: Optional[WriteIndex] = None,
                kv_scales=None, ctx=None, layer_id=None):
    """x [B, S, H] (the normed residual) → (out [B, S, H], new_cache).

    No kv_cache: the dense branch (JAX mla.py:328-406): k_nope/v expand
    from the latent through kv_up, attention over the S rows with the
    config's mask type and the optional keep-mask; new_cache is None.

    Paged serving (JAX mla.py:150-327): kv_cache is the layer's pool pair
    (latent [NB, bs, klat], roped key [NB, bs, dpe]), written IN PLACE at
    `write_index` (inactive slots and padding rows are not in it);
    page_table [B, MB] int32 and cache_positions [B] int32 (row b appends
    at its own position). chunk_counts [B] (or S > 1) selects the ragged
    chunk: row b's first chunk_counts[b] tokens are real, the rest padding
    with garbage outputs. kv_scales: the per-row fp32 scale pools
    (latent, key) [NB, bs] of an int8/fp8 pool: new rows are quantized per
    row and written with their scales, and new_cache then holds the four
    pools. ctx: a tensor-parallel rank (JAX mla.py:266-291 with
    kernel_gen._tp_place_latent): its latent pool holds the columns
    ctx.shard(kv_lora_rank) — the rank absorbs q_nope into those columns
    only, writes those columns of each new row (quantized over the whole
    row first), passes its rows of w_v (a strided view of kv_up, no copy)
    and attends through the two-phase tp body; the output is the same on
    every rank, so the out-projection runs replicated. layer_id:
    MegaScope's attribution of the layer's captures and disturbances."""
    b, s, _ = x.shape
    nq = cfg.num_attention_heads
    dqk, dpe, dv = cfg.qk_head_dim, cfg.qk_pos_emb_head_dim, cfg.v_head_dim
    klat, dt, eps = cfg.kv_lora_rank, cfg.compute_dtype, cfg.layernorm_epsilon
    x = x.to(dt)
    if "q_proj" in p:
        q = x @ weight_of(p["q_proj"], layer_id, dt)
    else:
        q = rms_norm(x @ p["q_down"].to(dt), p["q_ln_scale"], eps)
        q = q @ p["q_up"].to(dt)
    q = q.reshape(b, s, nq, dqk + dpe)
    q_nope, q_pe = q[..., :dqk], q[..., dqk:]
    kv = x @ weight_of(p["kv_down"], layer_id, dt)
    latent = rms_norm(kv[..., :klat], p["kv_ln_scale"], eps)
    k_pe = kv[..., klat:]
    if rope_cos is not None:
        q_pe = rotary.apply_rope(q_pe, rope_cos, rope_sin)
        k_pe = rotary.apply_rope(k_pe[:, :, None, :], rope_cos,
                                 rope_sin)[:, :, 0]
    m = yarn_m(cfg)

    if kv_cache is None:
        if cache_positions is not None or page_table is not None:
            raise NotImplementedError(
                "MLA's dense slot cache is not ported: the port serves MLA "
                "through the paged pools")
        kvu = (latent @ p["kv_up"].to(dt)).reshape(b, s, nq, dqk + dv)
        k_nope, v = kvu[..., :dqk], kvu[..., dqk:]
        if m != 1.0:
            # The rope tables carry m, giving the pe logits m²; the nope
            # logits get it here (JAX mla.py:339-350).
            q_nope, k_nope = q_nope * m, k_nope * m
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(
            b, s, nq, dpe)], dim=-1)
        q_full = scope_capture("qkv_q", q_full, layer_id)
        k_full = scope_capture("qkv_k", k_full, layer_id)
        v = scope_capture("qkv_v", v, layer_id)
        scale = float(1.0 / torch.sqrt(torch.tensor(float(dqk + dpe))))
        attn = dot_product_attention(q_full, k_full, v,
                                     mask_type=cfg.attn_mask_type,
                                     attention_mask=attention_mask,
                                     softmax_scale=scale)
        attn = scope_capture("context", attn, layer_id)
        out = attn.reshape(b, s, nq * dv) @ weight_of(p["out_kernel"],
                                                      layer_id, dt)
        return out, None

    if page_table is None or write_index is None:
        raise NotImplementedError(
            "MLA's dense slot cache is not ported: pass the paged pools "
            "with a page table and a write index")
    cols = None if ctx is None else ctx.shard(klat)
    write_kv(kv_cache, kv_scales, latent, k_pe, write_index, k_cols=cols)
    # The absorbed query: q_nope × m (the dense path's q factor) × m (its
    # k factor, which the unscaled cached latent cannot carry), through
    # kv_up's k_nope columns (JAX mla.py:244-263).
    q_nope = q_nope * m if m != 1.0 else q_nope
    if hooks.is_enabled("qkv_q", layer_id):
        scope_capture("qkv_q", torch.cat([q_nope, q_pe], dim=-1), layer_id)
    rows = q_nope.reshape(b * s, nq, dqk)
    if m != 1.0:
        rows = rows * m
    wk, w_v = kv_up_heads(p, cfg)
    if cols is not None:
        wk, w_v = wk[cols], w_v[cols]
    q_abs = torch.einsum("bnd,knd->bnk", rows, wk).reshape(b, s, nq, -1)
    counts = chunk_counts
    if counts is None and s > 1:
        counts = torch.full((b,), s, dtype=torch.int32, device=x.device)
    attn = latent_attention(q_abs, q_pe, kv_cache, kv_scales, page_table,
                            cache_positions, counts, w_v, cfg, ctx)
    attn = scope_capture("context", attn, layer_id)
    out = attn.reshape(b, s, nq * dv) @ weight_of(p["out_kernel"], layer_id,
                                                  dt)
    return out, tuple(kv_cache) + tuple(kv_scales or ())

