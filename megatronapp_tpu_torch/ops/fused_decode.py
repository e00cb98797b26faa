"""The fused (megakernel) decode layer: the counterpart of the JAX
package's ``megatronapp_tpu/ops/pallas/kernel_gen.py`` fused section
(:940-2241).

One decode (or chunked-prefill) layer runs as four hand-written CUDA
kernels around the paged-attention kernel: [norm + QKV + rope] → [K/V
append] → [paged attention] → [out-projection + residual] → [norm + fc1 +
activation] → [fc2 + residual]. The kernels' wrappers (the dispatchers
``fused_qkv``, ``fused_out_proj``, ``fused_mlp_fc1``, ``fused_mlp_fc2``:
the kernel for CUDA tensors, the plain version for CPU ones), their plain
versions and launch counters are in ``ops/cuda/fused_decode.py``; this
module adds ``fused_mlp`` (fc1 then fc2), the two layer bodies and the
eligibility check.

The TPU's one-kernel ``_fused_mlp`` becomes the fc1/fc2 pair here
(``fused_mlp``): fc2 contracts every ffn column that fc1 writes, which no
single CUDA kernel can wait for, and the JAX split is exact by design (y
lives in the compute dtype in both). The TPU VMEM tile planning
(``_qkv_tiles``, ``_out_tiles``, ``_mlp_tiles``, the VMEM budget) has no
counterpart: the CUDA kernels plan their own tiles and take any row count.

An MLA layer (``cfg.multi_latent_attention``, kernel_gen.py:1844
``_fused_mla_layer``) runs [fused MLA prologue: norm + q path + rope +
absorption + latent and k_pe rows] (ops/cuda/fused_mla.py, two launches)
→ [latent and k_pe append, quantized per row for int8/fp8 pools] →
[latent paged attention] → the same out-projection and MLP kernels.

``lora=`` (batched multi-tenant LoRA, kernel_gen.py:1950-2092): one layer's
adapter deltas, {"row_adapter": LoraRows of the step's rows, "banks":
{target: (A, B) of this layer}} (ops/lora.py). The four kernels run with
their LoRA epilogue, reading the banks through each row's slot id; JAX's
per-row gather of the factors (``_lora_gathered``) has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.inference.lora import lora_target_dims
from megatronapp_tpu_torch.ops.cuda.fused_decode import (
    fused_mlp_fc1, fused_mlp_fc1_plain, fused_mlp_fc2, fused_mlp_fc2_plain,
    fused_out_proj, fused_qkv, kernel_limits,
)
from megatronapp_tpu_torch.ops.cuda import fused_mla as cuda_mla
from megatronapp_tpu_torch.ops.cuda import paged_latent as cuda_latent
from megatronapp_tpu_torch.ops.lora import lora_kernel_ineligible_reason
from megatronapp_tpu_torch.ops.paged_attention import (
    WriteIndex, paged_attention_decode, paged_attention_multiquery,
    scale_kwargs, write_kv,
)
from megatronapp_tpu_torch.transformer.mla import (
    kv_up_heads, latent_attention,
)


def fused_mlp(x, p, cfg: TransformerConfig, lora=None):
    """Pre-MLP norm + fc1 + activation + fc2 + biases + residual (the
    _fused_mlp contract, with its fc1 and fc2 LoRA deltas) as the fc1 and
    fc2 kernels: x [R, H] → [R, H]."""
    return fused_mlp_fc2(fused_mlp_fc1(x, p, cfg, lora), x, p, cfg, lora)


def fused_mlp_plain(x, p, cfg: TransformerConfig, lora=None):
    """Plain version of ``fused_mlp``."""
    return fused_mlp_fc2_plain(fused_mlp_fc1_plain(x, p, cfg, lora), x, p,
                               cfg, lora)


def _fused_mla_layer(p, x, cfg: TransformerConfig, rope_cos, rope_sin,
                     kv_cache, cache_positions, counts, page_table,
                     write_index: WriteIndex, kv_scales=None):
    """One MLA layer as fused kernels (kernel_gen._fused_mla_layer), the
    s == 1 decode body (counts None) or the ragged chunk (counts [B]), on
    the B·S flattened rows: [fused MLA prologue] → [latent and k_pe append
    at `write_index`, quantized per row when kv_scales marks int8/fp8
    pools] → [latent paged attention] → [fused out-projection + residual]
    → [fused norm+MLP + residual]. Returns ((out [B, S, H], the layer's
    pools), None)."""
    b, s, h = x.shape
    nq, dpe = cfg.num_attention_heads, cfg.qk_pos_emb_head_dim
    klat, dv = cfg.kv_lora_rank, cfg.v_head_dim
    xf = x.reshape(b * s, h)
    cos = rope_cos.reshape(b * s, -1) if rope_cos is not None else None
    sin = rope_sin.reshape(b * s, -1) if rope_sin is not None else None
    q_lat, q_pe, lat, pe = cuda_mla.fused_mla_qkv(xf, p, cfg, cos, sin)
    write_kv(kv_cache, kv_scales, lat.reshape(b, s, klat),
             pe.reshape(b, s, dpe), write_index)
    attn = latent_attention(
        q_lat.reshape(b, s, nq, klat), q_pe.reshape(b, s, nq, dpe), kv_cache,
        kv_scales, page_table, cache_positions, counts,
        kv_up_heads(p["attention"], cfg)[1], cfg)
    x2 = fused_out_proj(attn.reshape(b * s, nq * dv), p, cfg, xf)
    x2 = fused_mlp(x2, p, cfg)
    return (x2.reshape(b, s, h), tuple(kv_cache) + tuple(kv_scales or ())), \
        None


def _no_mla_lora(lora):
    if lora is not None:
        raise ValueError("LoRA targets the GQA projections — "
                         "megakernel_ineligible_reason(lora_rank=) gates "
                         "MLA off")


def fused_layer_decode(p, x, cfg: TransformerConfig, rope_cos, rope_sin,
                       kv_cache, cache_positions, page_table,
                       write_index: WriteIndex, kv_scales=None, lora=None):
    """One decode layer as fused kernels (kernel_gen.fused_layer_decode):
    [fused norm+QKV+rope] → [K/V append] → [paged attention, decode mode]
    → [fused out-projection + residual] → [fused norm+MLP + residual].

    Drop-in for ``layer_forward``'s one-token paged branch: x [B, 1, H],
    rope tables [B, 1, half], the layer's pools written in place at
    `write_index` (inactive slots are not in it). kv_scales: the layer's
    scale pools of an int8/fp8 pool: the new rows are quantized and written
    with their scales, and the paged kernel dequantizes (kernel_gen.py:
    1990-2003). lora: the layer's adapter deltas over the B rows (module
    docstring). An MLA layer runs ``_fused_mla_layer``. Returns ((out [B,
    1, H], the layer's pools), None)."""
    b = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError("fused_layer_decode is the s == 1 decode body")
    if cfg.multi_latent_attention:
        _no_mla_lora(lora)
        return _fused_mla_layer(p, x, cfg, rope_cos, rope_sin, kv_cache,
                                cache_positions, None, page_table,
                                write_index, kv_scales)
    nq, d = cfg.num_attention_heads, cfg.head_dim
    x2 = x[:, 0]
    cos = rope_cos[:, 0] if rope_cos is not None else None
    sin = rope_sin[:, 0] if rope_sin is not None else None
    q, k, v = fused_qkv(x2, p, cfg, cos, sin, lora)
    ck, cv = kv_cache
    write_kv(kv_cache, kv_scales, k[:, None], v[:, None], write_index)
    attn = paged_attention_decode(q, ck, cv, page_table, cache_positions + 1,
                                  **scale_kwargs(kv_scales))       # [B, nq, D]
    x2 = fused_out_proj(attn.reshape(b, nq * d), p, cfg, x2, lora)
    x2 = fused_mlp(x2, p, cfg, lora)
    return (x2[:, None], (ck, cv) + tuple(kv_scales or ())), None


def fused_layer_multiquery(p, x, cfg: TransformerConfig, rope_cos,
                           rope_sin, kv_cache, cache_positions, counts,
                           page_table, write_index: WriteIndex,
                           kv_scales=None, lora=None):
    """One ragged multi-query layer (chunked prefill) as the same fused
    kernels on the B·S flattened rows around the ragged paged-attention
    kernel (kernel_gen.fused_layer_multiquery). x [B, S, H], rope tables
    [B, S, half], counts [B] real rows per slot (the rest are padding with
    finite garbage outputs), kv_scales as for ``fused_layer_decode``, lora
    over the B·S flattened rows (each slot's adapter on its S rows).
    Every fused op is row-wise or contracts the last dim, so flattening
    changes no row. An MLA layer runs ``_fused_mla_layer``. Returns ((out
    [B, S, H], the layer's pools), None)."""
    if cfg.multi_latent_attention:
        _no_mla_lora(lora)
        return _fused_mla_layer(p, x, cfg, rope_cos, rope_sin, kv_cache,
                                cache_positions, counts, page_table,
                                write_index, kv_scales)
    b, s, h = x.shape
    nq, nkv, d = (cfg.num_attention_heads, cfg.num_query_groups,
                  cfg.head_dim)
    xf = x.reshape(b * s, h)
    cos = rope_cos.reshape(b * s, -1) if rope_cos is not None else None
    sin = rope_sin.reshape(b * s, -1) if rope_sin is not None else None
    q, k, v = fused_qkv(xf, p, cfg, cos, sin, lora)
    ck, cv = kv_cache
    write_kv(kv_cache, kv_scales, k.reshape(b, s, nkv, d),
             v.reshape(b, s, nkv, d), write_index)
    attn = paged_attention_multiquery(q.reshape(b, s, nq, d), ck, cv,
                                      page_table, cache_positions + counts,
                                      counts, **scale_kwargs(kv_scales))
    x2 = fused_out_proj(attn.reshape(b * s, nq * d), p, cfg, xf, lora)
    x2 = fused_mlp(x2, p, cfg, lora)
    return (x2.reshape(b, s, h), (ck, cv) + tuple(kv_scales or ())), None


# The capture sites the fused body skips (kernel_gen.py:2134-2135).
_CAPTURE_SITES = ("qkv_q", "qkv_k", "qkv_v", "context", "mlp1", "mlp2",
                  "between_layers")


def megakernel_ineligible_reason(cfg: TransformerConfig, *, batch: int,
                                 params=None, mq_rows: Optional[int] = None,
                                 paged: bool = True, tp_paged: bool = False,
                                 device=None,
                                 lora_rank: Optional[int] = None
                                 ) -> Optional[str]:
    """Why the fused decode step may NOT run — None when eligible, else
    the first failed predicate by name (kernel_gen.
    megakernel_ineligible_reason). The semantic predicates are the JAX
    package's: paged backend, not MoE, not heterogeneous, no tp mesh, no
    MegaScope capture or disturbance active, no LoRA on MLA. The TPU's VMEM size predicates are replaced by the CUDA
    kernels' own limits (``kernel_limits``: compute, residual and weight
    dtypes — bf16, fp32 or resident int8, q_kernel and kv_kernel of one
    kind —, head_dim, alignment of H, ffn and the projections; for MLA the
    prologue's and the latent kernel's widths, bf16 q/kv weights and at
    most 32 rows), which hold where the step runs on the card — `device`,
    else the device of `params`; on the CPU the plain versions take any
    shape. batch and mq_rows are the decode and widest multi-query row
    counts; the GQA kernels take any.
    lora_rank: the adapter rank when an AdapterCache is attached. JAX's
    semantic predicate holds (MLA has no q/kv kernels to adapt); its
    re-plans of the no-grid VMEM bodies are replaced by the LoRA
    epilogues' own limits on the card (rank, fp32 banks:
    ``lora_kernel_ineligible_reason``)."""
    if not paged:
        return ("dense (non-paged) backend — the fused step is built "
                "around the paged-attention kernel")
    if cfg.is_moe:
        return "MoE layers: expert dispatch is not fused yet"
    if getattr(cfg, "heterogeneous_layers_config_json", None):
        return "heterogeneous per-layer configs unroll their own bodies"
    if tp_paged:
        return ("tp head-sharded serving mesh: fused prologue/epilogue "
                "kernels are single-device (the tp engine keeps the "
                "unfused body)")
    from megatronapp_tpu_torch.scope import hooks
    from megatronapp_tpu_torch.scope.disturbance import get_disturbance
    if any(hooks.is_enabled(s) for s in _CAPTURE_SITES):
        return ("MegaScope capture hooks active (fused kernels do not "
                "trace capture sites)")
    dist = get_disturbance()
    if any(dist.active(s) for s in ("weight", "calculation", "system")):
        return ("MegaScope disturbance sites active (fused kernels do "
                "not trace perturbations)")
    if lora_rank and cfg.multi_latent_attention:
        return ("LoRA serving targets the GQA projection kernels — "
                "the MLA megakernel has no q_kernel/kv_kernel to "
                "compose an adapter epilogue onto")
    rows = max(int(batch), int(mq_rows or 0))
    if rows < 1:
        return f"no rows to run (batch {batch}, mq_rows {mq_rows})"
    layer = None
    if params is not None:
        layer = params["layers"][0]
        if device is None:
            device = layer["ln1_scale"].device
    if device is None or torch.device(device).type != "cuda":
        return None
    reason = kernel_limits(cfg, layer)
    if reason is None and cfg.multi_latent_attention:
        reason = (cuda_mla.kernel_limits(cfg, rows, layer)
                  or cuda_latent.kernel_limits(cfg))
    if reason is None and lora_rank:
        for target, (din, dout) in lora_target_dims(cfg).items():
            why = lora_kernel_ineligible_reason(din, dout, int(lora_rank),
                                                rows)
            if why is not None:
                return f"LoRA epilogue ({target}): {why}"
    return reason
