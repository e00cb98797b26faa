"""Self-attention sublayer (GQA, RoPE, optional QK-layernorm): the paged
and single-device training branches of the JAX package's
transformer/attention.py.

Param leaf layout (per layer), the JAX [in, out] layout kept so weights
copy across without transposing (``x @ w``):
  q_kernel   [H, n_heads*D]
  kv_kernel  [H, 2*n_kv*D]   (K = the first n_kv heads, V = the next n_kv)
  q_bias     [n_heads*D]
  kv_bias    [2*n_kv*D]
  out_kernel [n_heads*D, H]
  out_bias   [H]
  (optional) q_ln_scale, k_ln_scale [D]
The three kernels may be resident int8 leaves (inference/quantization.py):
``resolve_param`` dequantizes them at matmul entry, as the JAX layer does.

Ported branches: the two paged serving branches (the multi-token ragged
append of chunked prefill and speculative verification, and the
one-token decode append), single-device or head-sharded over a
tensor-parallel group (``ctx``); the two dense-cache branches a draft
model decodes through (the per-row append under an explicit mask and the
static append at ``cache_index``: plain PyTorch, as JAX leaves them to
XLA); and the training branch (no cache: dense attention or the flash
kernels, by the ``attention_impl`` rule), on one device or under a rank
grid (``ctx``) with Megatron's tensor parallelism: the params are this tp
rank's shards (parallel/sharding.py), QKV is column-parallel over the
rank's q heads and their kv groups, attention runs on those local heads
(the flash kernels see the local head counts), and the out-projection is
row-parallel, its bias added once after the reduce. Under context
parallelism (ctx.cp > 1, JAX attention.py:447-466) each rank holds its
share of the sequence and attention runs ops/context_parallel.py's mode
(cfg.cp_comm_type; the zigzag ring when the caller laid the sequence out
in zigzag order) ahead of the flash / dense choice, on the rank's tp
heads. With ``tp_comm_overlap`` (parallel/overlap.py, where
``tp_overlap_eligible`` allows it) QKV runs as one ring of x into the
(q_kernel, kv_kernel) shards and the out-projection through
``matmul_reduce_scatter``, with their fp8 twins when the caller passes
the step's fp8 state (training/fp8.py ``Fp8Step``: the layer's 'qkv' and
'out' sites), as JAX attention.py:146-170 and :570-580 do; where the
predicates fail, the column/row layers above run and the failed one is
logged. Serving branches and LoRA never take the rings.

MegaScope's sites sit where the JAX layer puts them: the 'weight'
disturbance on the three projection kernels, the qkv_q/qkv_k/qkv_v
captures after the QKV split (before QK-norm and rope), 'context' on the
attention output of every branch, and 'attention_probs' inside dense
attention (``dot_product_attention``), so only where attention runs
dense: the flash and paged kernels never form the probabilities.
"""

from __future__ import annotations

from typing import Optional

import torch

from megatronapp_tpu_torch.config.transformer_config import (
    AttnMaskType, TransformerConfig,
)
from megatronapp_tpu_torch.inference.quantization import resolve_param
from megatronapp_tpu_torch.ops import rotary
from megatronapp_tpu_torch.ops.attention import dot_product_attention
from megatronapp_tpu_torch.ops.flash_attention import flash_attention
from megatronapp_tpu_torch.ops.lora import apply_lora_delta, apply_lora_deltas
from megatronapp_tpu_torch.ops.normalization import rms_norm
from megatronapp_tpu_torch.parallel.collectives import (
    copy_to_tp, reduce_from_tp,
)
from megatronapp_tpu_torch.parallel.overlap import (
    all_gather_matmul, matmul_reduce_scatter, overlap_or_log,
)
from megatronapp_tpu_torch.ops.paged_attention import (
    WriteIndex, paged_attention_decode, paged_attention_decode_tp,
    paged_attention_multiquery, paged_attention_multiquery_tp, scale_kwargs,
    write_kv,
)
from megatronapp_tpu_torch.scope.disturbance import get_disturbance
from megatronapp_tpu_torch.scope.hooks import scope_capture
from megatronapp_tpu_torch.utils.params import ParamTree, normal


def init_attention_params(cfg: TransformerConfig, generator: torch.Generator,
                          device, out_std: float) -> ParamTree:
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_query_groups
    std, dt = cfg.init_method_std, cfg.params_dtype
    p = {
        "q_kernel": normal((h, nq * d), std, dt, generator, device),
        "kv_kernel": normal((h, 2 * nkv * d), std, dt, generator, device),
        "out_kernel": normal((nq * d, h), out_std, dt, generator, device),
    }
    if cfg.add_qkv_bias:
        p["q_bias"] = torch.zeros(nq * d, dtype=dt, device=device)
        p["kv_bias"] = torch.zeros(2 * nkv * d, dtype=dt, device=device)
    if cfg.add_bias_linear:
        p["out_bias"] = torch.zeros(h, dtype=dt, device=device)
    if cfg.qk_layernorm:
        p["q_ln_scale"] = torch.ones(d, dtype=dt, device=device)
        p["k_ln_scale"] = torch.ones(d, dtype=dt, device=device)
    return ParamTree(p)


def attention_impl(cfg: TransformerConfig, b: int, nq: int, s: int,
                   device_type: str) -> str:
    """The attention_impl rule of JAX transformer/attention.py:470-489,
    with the TPU read as the card: "auto" takes the flash kernels
    ("pallas") on a CUDA device when S >= flash_min_seq or the dense fp32
    [B, H, S, S] scores and probabilities would pass 1 GiB, else dense
    attention ("reference"); "pallas" and "reference" force one."""
    impl = cfg.attention_impl
    if impl == "auto":
        dense_bytes = 2 * 4 * b * nq * s * s
        impl = ("pallas" if device_type == "cuda"
                and (s >= cfg.flash_min_seq or dense_bytes > 1 << 30)
                else "reference")
    if impl not in ("pallas", "reference"):
        raise ValueError(f"attention_impl {cfg.attention_impl!r}: takes "
                         "'auto', 'pallas' or 'reference'")
    return impl


def weight_of(w, layer_id, dt) -> torch.Tensor:
    """A projection kernel at matmul entry: dequantized (resident int8),
    through MegaScope's 'weight' disturbance, cast to the compute dtype."""
    return get_disturbance().apply("weight", resolve_param(w),
                                   layer_id).to(dt)


def _self_attention(q, k, v, cfg: TransformerConfig, attention_mask,
                    segment_ids, layer_id=None):
    """The training branch's attention (JAX transformer/attention.py:
    470-566, single device). Flash (the kernels on the card, their plain
    versions on the CPU) needs no explicit mask and a causal or
    bidirectional mask type; segment ids go to the kernel, or densify
    into the mask on the dense path."""
    b, s, nq, _ = q.shape
    impl = attention_impl(cfg, b, nq, s, q.device.type)
    use_flash = (impl == "pallas" and attention_mask is None
                 and cfg.attn_mask_type in (AttnMaskType.causal,
                                            AttnMaskType.bidirectional))
    if use_flash:
        return flash_attention(
            q, k, v, causal=cfg.attn_mask_type == AttnMaskType.causal,
            block_q=cfg.flash_block_q, block_kv=cfg.flash_block_kv,
            segment_ids=segment_ids, head_fold=cfg.flash_head_fold)
    if segment_ids is not None:
        seg_mask = (segment_ids[:, None, :, None]
                    == segment_ids[:, None, None, :])
        attention_mask = (seg_mask if attention_mask is None
                          else attention_mask & seg_mask)
    return dot_product_attention(
        q, k, v, mask_type=cfg.attn_mask_type,
        attention_mask=attention_mask,
        softmax_in_fp32=cfg.attention_softmax_in_fp32, layer_id=layer_id)


def _context_attention(q, k, v, cfg: TransformerConfig, attention_mask,
                       segment_ids, ctx, zigzag: bool):
    """The context-parallel branch (JAX attention.py:447-466): this cp
    rank's shares through ops/context_parallel.py's mode."""
    from megatronapp_tpu_torch.ops.context_parallel import (
        cp_attention, zigzag_active,
    )
    if attention_mask is not None:
        raise NotImplementedError(
            "explicit attention_mask is not supported under context "
            "parallelism yet (only causal/bidirectional); run with "
            "context_parallel=1 or drop the mask")
    comm = ("p2p_zigzag" if zigzag and zigzag_active(cfg, ctx)
            else cfg.cp_comm_type)
    return cp_attention(
        q, k, v, ctx, comm,
        causal=cfg.attn_mask_type == AttnMaskType.causal,
        segment_ids=segment_ids, a2a_size=cfg.hierarchical_cp_a2a_size,
        overlap=cfg.cp_comm_overlap)


def _dense_cache_attention(p, q, k, v, cfg: TransformerConfig,
                           attention_mask, kv_cache, cache_index,
                           cache_positions, layer_id=None):
    """The dense-cache branches (JAX transformer/attention.py:413-433):
    kv_cache (k, v) [B, S_max, Hkv, D] is written IN PLACE (the JAX step
    donates it). cache_positions [B]: one token a row, appended at the
    row's own position; causality comes from the caller's per-row
    attention_mask [B, 1, 1, S_max] (required), and rows whose position
    lies past the cache are dropped, as JAX's scatter drops them.
    Otherwise the static append of all S tokens at cache_index, attended
    causally from that offset. Attention runs dense over the whole cache
    (XLA's path on the JAX side: no kernel)."""
    ck, cv = kv_cache
    b, s = q.shape[:2]
    mask_type, q_offset = cfg.attn_mask_type, 0
    if cache_positions is not None:
        if attention_mask is None:
            raise ValueError(
                "per-row decode (cache_positions) requires an explicit "
                "per-row attention_mask; see inference/dynamic_engine.py's "
                "attend mask")
        pos = cache_positions.long()
        keep = pos < ck.shape[1]
        rows = torch.arange(b, device=q.device)[keep]
        ck[rows, pos[keep]] = k[keep, 0].to(ck.dtype)
        cv[rows, pos[keep]] = v[keep, 0].to(cv.dtype)
        mask_type = AttnMaskType.bidirectional
    else:
        ci = int(cache_index)
        ck[:, ci:ci + s] = k.to(ck.dtype)
        cv[:, ci:ci + s] = v.to(cv.dtype)
        q_offset = ci
    attn = dot_product_attention(
        q, ck, cv, mask_type=mask_type, attention_mask=attention_mask,
        softmax_in_fp32=cfg.attention_softmax_in_fp32, q_offset=q_offset,
        layer_id=layer_id)
    return _out_projection(p, attn, cfg, layer_id=layer_id), (ck, cv)


def _out_projection(p, attn, cfg: TransformerConfig, lora=None,
                    layer_id=None, ctx=None, overlap: bool = False,
                    fp8_site=None):
    """attn [B, S, nq, D] → its 'context' capture, then [B, S, nq·D] @
    out_kernel, the out delta between the product and the bias (JAX
    attention.py:567-585), + out_bias. ctx (training under tp): attn holds
    this rank's heads and out_kernel their rows; the partial products are
    summed over tp before the bias (overlap: by matmul_reduce_scatter's
    ring, fp8_site its e4m3 twin's)."""
    dt = cfg.compute_dtype
    b, s = attn.shape[:2]
    attn = scope_capture("context", attn, layer_id).reshape(b, s, -1)
    if overlap:
        out = matmul_reduce_scatter(
            attn, weight_of(p["out_kernel"], layer_id, dt), ctx,
            fp8=fp8_site)
        if "out_bias" in p:
            out = out + p["out_bias"].to(dt)
        return out
    out = attn @ weight_of(p["out_kernel"], layer_id, dt)
    out = apply_lora_delta(out, attn, lora, "out_kernel")
    out = reduce_from_tp(out, ctx)
    if "out_bias" in p:
        out = out + p["out_bias"].to(dt)
    return out


def attention_forward(p, x: torch.Tensor, cfg: TransformerConfig,
                      rope_cos: Optional[torch.Tensor] = None,
                      rope_sin: Optional[torch.Tensor] = None,
                      attention_mask: Optional[torch.Tensor] = None,
                      kv_cache=None, cache_index=None, cache_positions=None,
                      page_table=None, chunk_counts=None,
                      write_index: Optional[WriteIndex] = None,
                      segment_ids: Optional[torch.Tensor] = None, ctx=None,
                      kv_scales=None, lora=None, layer_id=None,
                      zigzag: bool = False, fp8=None):
    """x: [B, S, H] → (out [B, S, H], new_cache).

    Training (no kv_cache): new_cache is None. attention_mask [B,1,S,S]
    (True = keep) and segment_ids [B, S] (packed sequences) restrict
    attention; the attention_impl rule picks the flash kernels or dense
    attention (see ``_self_attention``).

    Dense cache (no page_table): kv_cache is the layer's (k, v) [B,
    S_max, Hkv, D], see ``_dense_cache_attention``.

    Serving: kv_cache is the layer's paged pool pair [NB, bs, Hkv, D],
    written IN PLACE (the JAX step donates it); page_table [B, MB] int32 and
    cache_positions [B] int32 (row b appends at its own position) live on
    the pools' device. chunk_counts [B] (or S > 1) selects the ragged
    multi-query branch: row b's first chunk_counts[b] tokens are real and
    attend the paged context plus the new tail causally; the rest are
    padding whose outputs are garbage. write_index: where the rows land
    in the pool, ``paged_write_index`` of the step (built once for every
    layer; inactive slots and padding rows are not in it, so their writes
    are dropped). K/V are written before attention reads them, as in the
    JAX step. kv_scales: the layer's fp32 scale pools (k_scales, v_scales)
    [NB, bs, Hkv] marking int8/fp8 pools: the new rows are quantized per
    (row, head) and written with their scales through the same index, and
    the kernel dequantizes as it reads; new_cache then holds the four
    pools. lora: one layer's batched adapter deltas (ops/lora.py) — the q,
    kv and out deltas add between each matmul and its bias, as JAX
    attention.py:278-281 and :581-585 place them. ctx: a tensor-parallel
    MeshContext (parallel/mesh.py) whose rank holds kv heads
    ctx.shard(Hkv) in its pools: the projections run whole on every rank
    (replicated params), the rank writes and attends its own heads, and
    the heads are gathered before the replicated out-projection (JAX
    attention.py:66-77, :363-367, :403-407). layer_id: the layer's index,
    MegaScope's attribution of its captures and disturbances. zigzag:
    the training caller laid this cp rank's share out in zigzag order
    (models/gpt.py), so 'p2p' runs the zigzag ring. fp8: the step's fp8
    state (training/fp8.py Fp8Step), for the training branch's rings
    (module docstring)."""
    serving = kv_cache is not None
    tp_train = not serving and ctx is not None and ctx.tp > 1
    paged = serving and page_table is not None
    if paged and (write_index is None or attention_mask is not None
                  or cache_index is not None or segment_ids is not None):
        raise ValueError(
            "the paged branches take a write index and mask themselves: "
            "no attention_mask, cache_index or segment_ids")
    if serving and not paged and (ctx is not None or lora is not None
                                  or kv_scales is not None
                                  or segment_ids is not None):
        raise NotImplementedError(
            "the dense-cache branches serve a draft model on one device: "
            "tensor parallelism, LoRA, quantized caches and packed "
            "segments ride the paged branches only")
    if not serving and (cache_index is not None or page_table is not None
                        or cache_positions is not None):
        raise ValueError("cache arguments without kv_cache")
    b, s, _ = x.shape
    d = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_query_groups
    dt = cfg.compute_dtype
    x = x.to(dt)
    if tp_train:
        if nq % ctx.tp or nkv % ctx.tp:
            raise ValueError(
                f"tensor-parallel attention needs the q heads ({nq}) and kv "
                f"heads ({nkv}) to split over tp {ctx.tp} (JAX falls back "
                "to dense replicated attention there; the port does not)")
    overlap = tp_train and overlap_or_log(cfg, ctx, nq * d, 2 * nkv * d,
                                          batch=b * ctx.batch)
    if fp8 is not None and not overlap:
        raise ValueError(
            "fp8 state passed but the tp-overlap rings are not "
            "eligible here (tp_overlap_eligible is False / decode "
            "path) — check fp8_ineligible_reason at wiring time")
    if tp_train:
        nq, nkv = nq // ctx.tp, nkv // ctx.tp
    if overlap:
        # One ring of x feeds both column-parallel projections.
        q, kv = all_gather_matmul(
            x, (weight_of(p["q_kernel"], layer_id, dt),
                weight_of(p["kv_kernel"], layer_id, dt)), ctx,
            fp8=None if fp8 is None else fp8.site(layer_id, "attention",
                                                  "qkv"))
    else:
        if tp_train:
            x = copy_to_tp(x, ctx)
        q = x @ weight_of(p["q_kernel"], layer_id, dt)
        kv = x @ weight_of(p["kv_kernel"], layer_id, dt)
    q, kv = apply_lora_deltas((q, kv), x, lora, ("q_kernel", "kv_kernel"))
    if "q_bias" in p:
        q = q + p["q_bias"].to(dt)
        kv = kv + p["kv_bias"].to(dt)
    q = q.reshape(b, s, nq, d)
    k, v = kv.reshape(b, s, 2 * nkv, d).split(nkv, dim=2)
    q = scope_capture("qkv_q", q, layer_id)
    k = scope_capture("qkv_k", k, layer_id)
    v = scope_capture("qkv_v", v, layer_id)
    if cfg.qk_layernorm:
        q = rms_norm(q, p["q_ln_scale"], cfg.layernorm_epsilon)
        k = rms_norm(k, p["k_ln_scale"], cfg.layernorm_epsilon)
    if rope_cos is not None:
        q = rotary.apply_rope(q, rope_cos, rope_sin)
        k = rotary.apply_rope(k, rope_cos, rope_sin)

    if not serving:
        if lora is not None:
            raise ValueError("lora deltas ride the paged serving branches "
                             "only")
        if ctx is not None and ctx.cp > 1:
            attn = _context_attention(q, k, v, cfg, attention_mask,
                                      segment_ids, ctx, zigzag)
        else:
            attn = _self_attention(q, k, v, cfg, attention_mask,
                                   segment_ids, layer_id)
        return _out_projection(
            p, attn, cfg, layer_id=layer_id, ctx=ctx if tp_train else None,
            overlap=overlap, fp8_site=None if fp8 is None else fp8.site(
                layer_id, "attention", "out")), None

    if not paged:
        return _dense_cache_attention(p, q, k, v, cfg, attention_mask,
                                      kv_cache, cache_index, cache_positions,
                                      layer_id)
    ck, cv = kv_cache
    if ctx is not None:
        # Tensor-parallel serving (JAX kernel_gen._tp_place): this rank's
        # pools hold its contiguous kv heads; q keeps the matched query
        # heads, and the heads are gathered after the kernel.
        q, k, v = (q[:, :, ctx.shard(nq)], k[:, :, ctx.shard(nkv)],
                   v[:, :, ctx.shard(nkv)])
    write_kv(kv_cache, kv_scales, k, v, write_index)
    sc = scale_kwargs(kv_scales)
    q = q.contiguous()
    if s > 1 or chunk_counts is not None:
        counts = (chunk_counts if chunk_counts is not None else torch.full(
            (b,), s, dtype=torch.int32, device=x.device))
        if ctx is not None:
            attn = paged_attention_multiquery_tp(
                q, ck, cv, page_table, cache_positions + counts, counts, ctx,
                **sc)
        else:
            attn = paged_attention_multiquery(q, ck, cv, page_table,
                                              cache_positions + counts,
                                              counts, **sc)
    elif ctx is not None:
        attn = paged_attention_decode_tp(q[:, 0], ck, cv, page_table,
                                         cache_positions + 1, ctx,
                                         **sc)[:, None]
    else:
        attn = paged_attention_decode(q[:, 0], ck, cv, page_table,
                                      cache_positions + 1, **sc)[:, None]
    out = _out_projection(p, attn.reshape(b, s, nq, d), cfg, lora, layer_id)
    return out, (ck, cv) + tuple(kv_scales or ())
