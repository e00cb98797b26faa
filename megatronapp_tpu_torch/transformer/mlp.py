"""MLP sublayer, dense and gated (the JAX package's transformer/mlp.py
without its tp-overlap and fp8 branches).

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
"""

from __future__ import annotations

import torch

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.ops.activations import apply_activation, is_gated
from megatronapp_tpu_torch.ops.lora import apply_lora_delta
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
                layer_id=None):
    """x [..., H] → [..., H]: fc1 → activation (gate = first half of fc1
    for gated kinds) → fc2. lora: one layer's batched adapter deltas
    (ops/lora.py): fc1's from the normed input and fc2's from the
    activated y, each between its matmul and its bias (JAX mlp.py:
    109-136). layer_id: MegaScope's attribution."""
    dt = cfg.compute_dtype
    x = x.to(dt)
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
    out = y @ weight_of(p["fc2_kernel"], layer_id, dt)
    out = apply_lora_delta(out, y, lora, "fc2_kernel")
    if "fc2_bias" in p:
        out = out + p["fc2_bias"].to(dt)
    return scope_capture("mlp2", out, layer_id)
