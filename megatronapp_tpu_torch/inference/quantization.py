"""Post-training weight quantization for serving: symmetric per-output-
channel int8 (the port's own copy of the JAX package's
inference/quantization.py formulas, on torch tensors on their device).

``quantize_params`` quantizes the matmul kernels of a param tree, leaf by
leaf where each leaf lies (on the card for a served model: no host copy of
the weights is made). ``residentize_params`` turns its result into the
serving form: each of the five ``RESIDENT_KERNELS`` becomes a resident
leaf, a child ``ParamTree`` ``{"qint8": int8 [K, N], "qscale": fp32
[1, N]}`` under the kernel's name, kept int8 on the device; every other
quantized leaf is dequantized eagerly, and its bytes are counted
(``quantized_weights_dequantized_bytes``) and logged. Consumers call
``resolve_param`` at matmul entry (the unfused layers), or hand the int8
bytes and scales to the fused kernels, which dequantize as they load.

Cast a tree to another dtype before quantizing it: ``nn.Module.to(dtype)``
would cast the fp32 scales of a resident leaf too.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import torch
from torch import nn

from megatronapp_tpu_torch.utils import metrics as telemetry
from megatronapp_tpu_torch.utils.params import ParamTree

logger = logging.getLogger(__name__)

# Leaves whose name ends with one of these are quantized (matmul kernels);
# norms, biases, embeddings and routers stay full precision.
QUANT_SUFFIXES = ("kernel", "dense", "head", "pooler", "attn_linear",
                  "mlp_linear")
QUANT_EXCLUDE = ("router_kernel",)
# Kernels whose consumers dequantize at matmul entry (transformer/
# attention.py, transformer/mlp.py and the fused kernels), so they may stay
# int8 on the device.
RESIDENT_KERNELS = ("q_kernel", "kv_kernel", "out_kernel", "fc1_kernel",
                    "fc2_kernel")


class QuantizedLeaf(ParamTree):
    """A ``quantize_params`` entry: int8 ``q`` and fp32 ``scale`` [..., 1,
    N] (one per output column), and the dtype the weight had."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype):
        super().__init__({"q": q, "scale": scale})
        self.orig_dtype = dtype


def _should_quantize(name: str, leaf: torch.Tensor) -> bool:
    if any(name.endswith(s) for s in QUANT_EXCLUDE):
        return False
    return leaf.dim() >= 2 and any(name.endswith(s) for s in QUANT_SUFFIXES)


def quantize_leaf(w: torch.Tensor) -> QuantizedLeaf:
    """Symmetric per-output-channel int8: the absmax reduces over the input
    axis (-2), scale = max(absmax / 127, 1e-12), q = clip(round(w /
    scale), ±127) with rounding half to even."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=-2, keepdim=True) / 127.0,
                            1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedLeaf(q, scale, w.dtype)


def dequantize_leaf(entry: QuantizedLeaf) -> torch.Tensor:
    return (entry["q"].float() * entry["scale"]).to(entry.orig_dtype)


def is_resident_leaf(x) -> bool:
    """A resident leaf: a tree of exactly {"qint8", "qscale"}."""
    if isinstance(x, ParamTree):
        return (not x._modules
                and set(x._parameters) == {"qint8", "qscale"})
    return isinstance(x, dict) and set(x) == {"qint8", "qscale"}


def resolve_param(w, dtype: torch.dtype = None) -> torch.Tensor:
    """Matmul-entry hook: a resident leaf dequantizes here (int8 × its fp32
    column scales); a plain tensor passes through. Then the cast to
    `dtype`, if given."""
    if is_resident_leaf(w):
        w = w["qint8"].float() * w["qscale"]
    return w if dtype is None else w.to(dtype)


def _rebuild(tree, fn, path=()):
    """A new tree of tree's structure with each parameter leaf replaced by
    fn(path, leaf) (a tensor, or a module placed as a child)."""
    if isinstance(tree, nn.ModuleList):
        return nn.ModuleList(_rebuild(m, fn, path + (str(i),))
                             for i, m in enumerate(tree))
    out = fn(path, tree)
    if out is not tree:
        return out
    leaves, children = {}, {}
    items = [(name, fn(path + (name,), t))
             for name, t in tree._parameters.items()]
    items += [(name, _rebuild(m, fn, path + (name,)))
              for name, m in tree._modules.items()]
    for name, new in items:
        (children if isinstance(new, nn.Module) else leaves)[name] = new
    return ParamTree(leaves, **children)


def quantize_params(params, resident_only: bool = False
                    ) -> Tuple[ParamTree, Dict[str, float]]:
    """Quantize the matmul kernels of a param tree; returns (the tree with
    ``QuantizedLeaf`` children in their place, report {path: max |dequant
    - w|}). resident_only quantizes only the leaves ``residentize_params``
    keeps int8 (startup quantization for serving: any other leaf would
    take the rounding error and be dequantized again)."""
    report: Dict[str, float] = {}

    def fn(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        name = path[-1]
        if not _should_quantize(name, leaf) or (
                resident_only
                and not any(name.endswith(s) for s in RESIDENT_KERNELS)):
            return leaf
        entry = quantize_leaf(leaf)
        report["/".join(path)] = float(
            (dequantize_leaf(entry).float() - leaf.float()).abs().max())
        return entry

    return _rebuild(params, fn), report


def residentize_params(tree) -> ParamTree:
    """The serving form of a ``quantize_params`` tree: RESIDENT_KERNELS
    entries become resident leaves {"qint8", "qscale"}; every other
    quantized leaf is dequantized eagerly, its bytes counted into
    ``quantized_weights_dequantized_bytes`` and logged once. A tree without
    quantized leaves comes back with the same leaves."""
    fallback = {"bytes": 0, "paths": []}

    def fn(path, leaf):
        if not isinstance(leaf, QuantizedLeaf):
            return leaf
        name = path[-1] if path else ""
        if any(name.endswith(s) for s in RESIDENT_KERNELS):
            return ParamTree({"qint8": leaf["q"],
                              "qscale": leaf["scale"].float()})
        deq = dequantize_leaf(leaf)
        fallback["bytes"] += deq.numel() * deq.element_size()
        fallback["paths"].append("/".join(path))
        return deq

    out = _rebuild(tree, fn)
    if fallback["bytes"]:
        telemetry.inc("quantized_weights_dequantized_bytes",
                      fallback["bytes"])
        logger.warning(
            "residentize_params: %d quantized leaves have no resolve-aware "
            "consumer and were dequantized eagerly (%d bytes of the "
            "resident win given back): %s", len(fallback["paths"]),
            fallback["bytes"], ", ".join(fallback["paths"][:8]))
    return out


def quantize_for_serving(params) -> Tuple[ParamTree, Dict[str, float]]:
    """Startup post-training quantization of a served model (``serve.py
    --quantized-weights``): resident_only quantization, then the resident
    form. Returns (params, report)."""
    qparams, report = quantize_params(params, resident_only=True)
    return residentize_params(qparams), report


def resident_nbytes(tree) -> int:
    """Device bytes of a (possibly residentized) param tree."""
    return sum(t.numel() * t.element_size() for t in tree.parameters())
