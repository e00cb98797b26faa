"""MLP sublayer, dense and gated (the JAX package's transformer/mlp.py;
its tp-sharded pipeline stage body is not ported).

Param leaf layout:
  fc1_kernel [H, F] or [H, 2F] (gated: [gate | value])
  fc1_bias   [F] / [2F]
  fc2_kernel [F, H]
  fc2_bias   [H]
The two kernels may be resident int8 leaves (inference/quantization.py):
``resolve_param`` dequantizes them at matmul entry, as the JAX MLP does.
MegaScope's sites are the JAX MLP's: the 'weight' disturbance on both
kernels, the 'mlp1' capture and the 'calculation' disturbance on fc1's
output (before the activation), the 'mlp2' capture on the output.

Under a rank grid (``ctx``, training) the leaves are this tp rank's
shards (parallel/sharding.py): fc1 is column-parallel, its gate and value
halves split separately, so the rank's [gate | value] columns pair up;
fc2 is row-parallel, its partial products summed over tp before fc2_bias.
With ``tp_comm_overlap`` (parallel/overlap.py, where
``tp_overlap_eligible`` allows it for the pair) fc1 runs as
``all_gather_matmul`` and fc2 as ``matmul_reduce_scatter``, their fp8
twins when the caller passes the step's fp8 state (the layer's 'fc1' and
'fc2' sites), as JAX mlp.py:78-131 does; otherwise the column/row layers
run and the failed predicate is logged. LoRA serving never takes the
rings.
"""

from __future__ import annotations

import torch

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.ops.activations import apply_activation, is_gated
from megatronapp_tpu_torch.ops.lora import apply_lora_delta
from megatronapp_tpu_torch.parallel.collectives import (
    copy_to_tp, reduce_from_tp,
)
from megatronapp_tpu_torch.parallel.overlap import (
    all_gather_matmul, matmul_reduce_scatter, overlap_or_log,
)
from megatronapp_tpu_torch.scope.disturbance import get_disturbance
from megatronapp_tpu_torch.scope.hooks import scope_capture
from megatronapp_tpu_torch.transformer.attention import weight_of
from megatronapp_tpu_torch.utils.params import ParamTree, normal


def init_mlp_params(cfg: TransformerConfig, generator: torch.Generator,
                    device, out_std: float) -> ParamTree:
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    std, dt = cfg.init_method_std, cfg.params_dtype
    fc1_out = 2 * f if is_gated(cfg.activation) else f
    p = {"fc1_kernel": normal((h, fc1_out), std, dt, generator, device),
         "fc2_kernel": normal((f, h), out_std, dt, generator, device)}
    if cfg.add_bias_linear:
        p["fc1_bias"] = torch.zeros(fc1_out, dtype=dt, device=device)
        p["fc2_bias"] = torch.zeros(h, dtype=dt, device=device)
    return ParamTree(p)


def mlp_forward(p, x: torch.Tensor, cfg: TransformerConfig, lora=None,
                layer_id=None, ctx=None, fp8=None):
    """x [..., H] → [..., H]: fc1 → activation (gate = first half of fc1
    for gated kinds) → fc2. lora: one layer's batched adapter deltas
    (ops/lora.py): fc1's from the normed input and fc2's from the
    activated y, each between its matmul and its bias (JAX mlp.py:
    109-136). layer_id: MegaScope's attribution. ctx: the training grid
    (see the module docstring); fp8: the step's fp8 state
    (training/fp8.py Fp8Step) for the rings."""
    dt = cfg.compute_dtype
    overlap = (ctx is not None and ctx.tp > 1 and lora is None
               and overlap_or_log(cfg, ctx, p["fc1_kernel"].shape[1]
                                  * ctx.tp, p["fc2_kernel"].shape[0]
                                  * ctx.tp, batch=x.shape[0] * ctx.batch))
    if fp8 is not None and not overlap:
        raise ValueError(
            "fp8 state passed but the tp-overlap rings are not "
            "eligible here (tp_overlap_eligible is False) — the fp8 "
            "GEMMs live inside the ring bodies; check "
            "fp8_ineligible_reason at wiring time")
    x = x.to(dt)
    if overlap:
        y = all_gather_matmul(
            x, weight_of(p["fc1_kernel"], layer_id, dt), ctx,
            fp8=None if fp8 is None else fp8.site(layer_id, "mlp", "fc1"))
    else:
        x = copy_to_tp(x, ctx)
        y = x @ weight_of(p["fc1_kernel"], layer_id, dt)
        y = apply_lora_delta(y, x, lora, "fc1_kernel")
    if "fc1_bias" in p:
        y = y + p["fc1_bias"].to(dt)
    y = scope_capture("mlp1", y, layer_id)
    y = get_disturbance().apply("calculation", y, layer_id)
    if is_gated(cfg.activation):
        gate, val = y.chunk(2, dim=-1)
        y = apply_activation(cfg.activation, val, gate)
    else:
        y = apply_activation(cfg.activation, y)
    if overlap:
        out = matmul_reduce_scatter(
            y, weight_of(p["fc2_kernel"], layer_id, dt), ctx,
            fp8=None if fp8 is None else fp8.site(layer_id, "mlp", "fc2"))
    else:
        out = y @ weight_of(p["fc2_kernel"], layer_id, dt)
        out = apply_lora_delta(out, y, lora, "fc2_kernel")
        out = reduce_from_tp(out, ctx)
    if "fc2_bias" in p:
        out = out + p["fc2_bias"].to(dt)
    return scope_capture("mlp2", out, layer_id)
