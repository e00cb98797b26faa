"""Transformer layer (the JAX package's transformer/block.py, plain body).

The JAX package stacks per-layer params along a leading L axis and walks
them with ``lax.scan``; here each layer is one ``ParamTree`` in an
``nn.ModuleList`` and callers loop over it. Pre-LN residual structure:
input norm → attention → +residual → pre-MLP norm → MLP → +residual.
``block_forward`` runs the layers for training, each under the remat
policy (``_remat_wrap``), and sums their MoE aux losses.

A MoE config's layers (transformer/moe.py) hold ``moe`` where a dense
layer holds ``mlp``: every layer at moe_layer_freq 1, else layer i iff i
% moe_layer_freq == 0 (JAX's {"moe": [G, ...], "dense": [G, freq−1,
...]} groups, unstacked into the list). The MoE branch has no MegaScope
capture of its own (JAX's mlp1 / mlp2 sites are in the dense MLP); the
layer's 'system' disturbance and 'between_layers' capture stay.

FSDP (a grid ctx with ``parallel.fsdp``, parallel/sharding.py): a
layer's leaves are this rank's 1/dp shards. ``block_forward`` gathers
them whole at the layer's entry (``fsdp_view``: one all-gather over the
stage's dp group) and runs the layer on them inside a non-reentrant
``torch.utils.checkpoint``, which keeps only the layer's input: the
gathered leaves die with the forward, and the backward recomputes the
layer, gathering its leaves again, before the gather's own backward
reduce-scatters their grads to the shards. That is Megatron's
reshard-after-forward (core/distributed/custom_fsdp), done by recompute
of the layer; without it a rank would hold every layer's whole leaves
until its backward and FSDP would save no memory.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from megatronapp_tpu_torch.config.transformer_config import (
    NormKind, TransformerConfig,
)
from megatronapp_tpu_torch.ops.fused_decode import (
    fused_layer_decode, fused_layer_multiquery,
)
from megatronapp_tpu_torch.ops.normalization import apply_norm
from megatronapp_tpu_torch.parallel.sharding import fsdp_on, fsdp_view
from megatronapp_tpu_torch.scope.disturbance import get_disturbance
from megatronapp_tpu_torch.scope.hooks import scope_capture
from megatronapp_tpu_torch.transformer.attention import (
    attention_forward, init_attention_params,
)
from megatronapp_tpu_torch.transformer.mla import init_mla_params, mla_forward
from megatronapp_tpu_torch.transformer.mlp import init_mlp_params, mlp_forward
from megatronapp_tpu_torch.transformer.moe import init_moe_params, moe_forward
from megatronapp_tpu_torch.utils.params import ParamTree


def init_layer_params(cfg: TransformerConfig, generator: torch.Generator,
                      device, layer_id: int = 0) -> ParamTree:
    """Layer `layer_id`'s params (the MLA leaves for a
    multi_latent_attention config, JAX block.py:41-45; the MoE leaves,
    ``moe``, when cfg.is_moe_layer(layer_id), JAX block.py:61-64).
    Residual-out projections use the scaled init std / sqrt(2 *
    num_layers)."""
    out_std = cfg.init_method_std / math.sqrt(2.0 * cfg.num_layers)
    h, dt = cfg.hidden_size, cfg.params_dtype
    leaves = {"ln1_scale": torch.ones(h, dtype=dt, device=device),
              "ln2_scale": torch.ones(h, dtype=dt, device=device)}
    if cfg.normalization == NormKind.layernorm:
        leaves["ln1_bias"] = torch.zeros(h, dtype=dt, device=device)
        leaves["ln2_bias"] = torch.zeros(h, dtype=dt, device=device)
    init_attn = (init_mla_params if cfg.multi_latent_attention
                 else init_attention_params)
    attention = init_attn(cfg, generator, device, out_std)
    if cfg.is_moe_layer(layer_id):
        return ParamTree(leaves, attention=attention, moe=init_moe_params(
            cfg, generator, device, out_std))
    return ParamTree(leaves, attention=attention,
                     mlp=init_mlp_params(cfg, generator, device, out_std))


def init_block_params(cfg: TransformerConfig, generator: torch.Generator,
                      device) -> nn.ModuleList:
    return nn.ModuleList(init_layer_params(cfg, generator, device, i)
                         for i in range(cfg.num_layers))


def layer_forward(p, x: torch.Tensor, cfg: TransformerConfig,
                  rope_cos=None, rope_sin=None, attention_mask=None,
                  kv_cache=None, cache_index=None,
                  cache_positions=None, page_table=None,
                  chunk_counts=None, write_index=None,
                  fused_decode: bool = False, segment_ids=None, ctx=None,
                  kv_scales=None, lora=None, layer_id=None,
                  zigzag: bool = False, fp8=None):
    """One transformer layer. x: [B,S,H] → ((out, new_cache), aux): aux
    is the MoE layer's aux loss (this rank's share under a training ctx,
    transformer/moe.py), None for a dense layer;
    the paged, mask and segment arguments are attention_forward's
    (no kv_cache: the training branch, new_cache None). kv_scales: the
    layer's fp32 scale pools, marking a quantized (int8/fp8) paged pool
    (JAX block.py:74-170).

    fused_decode: the paged serving layer as the fused kernels
    (ops/fused_decode.py), dispatched as JAX transformer/block.py:108-132
    does — chunk_counts given: the ragged multi-query body; S == 1: the
    decode body. Callers gate it on megakernel_ineligible_reason.

    lora: one layer's batched adapter deltas (ops/lora.py: {"row_adapter":
    LoraRows of the step's rows, "banks": {target: (A, B) of this layer}})
    on the paged serving branches, unfused or fused (JAX block.py:75-194).

    An MLA layer (cfg.multi_latent_attention) runs transformer/mla.py's
    mla_forward on the normed input (JAX block.py:136-160): kv_cache is
    its (latent, roped key) pool pair and kv_scales their per-row scale
    pools. It takes no lora.

    ctx: a tensor-parallel MeshContext on the paged serving branches
    (attention_forward's head shards, mla_forward's latent columns), or
    the training grid, whose tp rank holds its shards of the layer
    (attention_forward's and mlp_forward's tensor parallelism; MLA under
    a training ctx raises).

    layer_id: the layer's index, MegaScope's attribution: the sublayers'
    captures and disturbances, then the 'system' disturbance and the
    'between_layers' capture on the layer's output (JAX block.py:196-200).
    zigzag: the training sequence share is in zigzag order (attention's
    flag, JAX block.py:72). fp8: the step's fp8 state (training/fp8.py
    Fp8Step) for the training branch's rings.
    The fused body has none of these sites: callers refuse it while any
    is active (megakernel_ineligible_reason)."""
    if fused_decode:
        if ctx is not None:
            raise ValueError(
                "fused_decode under a tp ctx: the fused kernels are "
                "single-device (the tp engine keeps the unfused body)")
        if page_table is None or kv_cache is None or "moe" in p:
            raise ValueError(
                "fused_decode covers the dense-MLP paged decode/multiquery "
                "bodies only — gate callers on "
                "ops.fused_decode.megakernel_ineligible_reason")
        if chunk_counts is not None:
            return fused_layer_multiquery(
                p, x, cfg, rope_cos, rope_sin, kv_cache, cache_positions,
                chunk_counts, page_table, write_index, kv_scales, lora=lora)
        if x.shape[1] != 1:
            raise ValueError(
                "fused_decode without chunk_counts is the s == 1 decode "
                "body — pass chunk_counts for ragged multi-token steps")
        return fused_layer_decode(p, x, cfg, rope_cos, rope_sin, kv_cache,
                                  cache_positions, page_table, write_index,
                                  kv_scales, lora=lora)
    residual = x
    h = apply_norm(cfg.normalization, x, p["ln1_scale"], p.get("ln1_bias"),
                   cfg.layernorm_epsilon)
    if cfg.multi_latent_attention:
        if lora is not None:
            raise ValueError(
                "lora serving targets the GQA projection kernels — MLA "
                "has no q_kernel/kv_kernel (lora.AdapterCache rejects "
                "MLA configs at construction)")
        if (ctx is not None and kv_cache is None) or cache_index is not None:
            raise NotImplementedError(
                "context-parallel and tensor-parallel MLA training and MLA's "
                "dense slot cache are not ported yet (ROADMAP.md Queue 1 "
                "item 4, MLA under tp): ctx is taken only by the paged "
                "serving branch")
        if segment_ids is not None:
            # Packed segments densify into the keep-mask (JAX block.py:
            # 143-149).
            seg_mask = (segment_ids[:, None, :, None]
                        == segment_ids[:, None, None, :])
            attention_mask = (seg_mask if attention_mask is None
                              else attention_mask & seg_mask)
        attn_out, new_cache = mla_forward(
            p["attention"], h, cfg, rope_cos, rope_sin, attention_mask,
            kv_cache=kv_cache, cache_positions=cache_positions,
            page_table=page_table, chunk_counts=chunk_counts,
            write_index=write_index, kv_scales=kv_scales, ctx=ctx,
            layer_id=layer_id)
    else:
        attn_out, new_cache = attention_forward(
            p["attention"], h, cfg, rope_cos, rope_sin, attention_mask,
            kv_cache=kv_cache, cache_index=cache_index,
            cache_positions=cache_positions, page_table=page_table,
            chunk_counts=chunk_counts, write_index=write_index,
            segment_ids=segment_ids, ctx=ctx, kv_scales=kv_scales,
            lora=lora, layer_id=layer_id, zigzag=zigzag, fp8=fp8)
    x = residual + attn_out.to(residual.dtype)
    residual = x
    h = apply_norm(cfg.normalization, x, p["ln2_scale"], p.get("ln2_bias"),
                   cfg.layernorm_epsilon)
    aux = None
    if "moe" in p:
        if lora is not None:
            raise ValueError("lora serving targets the dense fc1/fc2 "
                             "kernels — MoE layers are unsupported")
        mlp_out, aux = moe_forward(p["moe"], h, cfg, layer_id=layer_id,
                                   ctx=ctx if kv_cache is None else None)
    else:
        mlp_out = mlp_forward(p["mlp"], h, cfg, lora=lora,
                              layer_id=layer_id,
                              ctx=ctx if kv_cache is None else None,
                              fp8=fp8)
    x = residual + mlp_out.to(residual.dtype)
    x = get_disturbance().apply("system", x, layer_id)
    x = scope_capture("between_layers", x, layer_id)
    return (x, new_cache), aux


REMAT_POLICIES = ("full", "selective", "selective_attn", "none")


def _remat_wrap(fn, policy: str):
    """The JAX package's _remat_wrap (block.py:204-221). "full" keeps only
    each layer's input and recomputes the layer in the backward
    (torch.utils.checkpoint, non-reentrant). "selective" and
    "selective_attn" choose which products XLA saves; eager PyTorch
    saves every activation autograd needs, which computes the same
    numbers with more memory, so they run like "none"."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}: takes {REMAT_POLICIES}")
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    return fn


def block_forward(layers, x: torch.Tensor, cfg: TransformerConfig,
                  rope_cos=None, rope_sin=None, attention_mask=None,
                  segment_ids=None, ctx=None, layer_ids=None,
                  zigzag: bool = False, fp8=None):
    """Run the layers for training (ctx: the rank grid, see
    layer_forward; under FSDP each layer gathers its leaves and is
    recomputed in the backward, module docstring). layer_ids: each
    layer's global index (a pipeline stage's chunk, JAX's layer_offset),
    so MegaScope's sites see the ids one device gives them; default 0,
    1, ... zigzag: x is this cp rank's share in zigzag order (JAX
    block.py:167). fp8: the step's fp8 state (training/fp8.py Fp8Step).
    Returns (x, moe_aux_sum): the MoE layers' aux losses summed (a zero
    scalar without them)."""
    fsdp = fsdp_on(ctx)

    def run_layer(layer_p, h, lid):
        if fsdp:
            layer_p = fsdp_view(layer_p, ctx)
        (h2, _), aux = layer_forward(layer_p, h, cfg, rope_cos, rope_sin,
                                     attention_mask, segment_ids=segment_ids,
                                     ctx=ctx, layer_id=lid, zigzag=zigzag,
                                     fp8=fp8)
        return h2, aux

    run_layer = _remat_wrap(run_layer, "full" if fsdp else cfg.remat_policy)
    if layer_ids is None:
        layer_ids = range(len(layers))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lid, layer_p in zip(layer_ids, layers):
        x, aux = run_layer(layer_p, x, lid)
        if aux is not None:
            total = total + aux
    return x, total
