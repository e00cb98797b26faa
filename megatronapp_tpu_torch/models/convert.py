"""Weights carried across from the JAX package.

``params_from_jax`` takes the JAX param pytree as numpy arrays (the
caller does ``jax.tree.map(np.asarray, params)``; the port itself never
imports JAX) and returns the port's ``ParamTree``. The stacked ``block``
leaves [L, ...] are unstacked into ``layers.i``; every other leaf keeps
its name and its [in, out] layout, so nothing is transposed. A leaf the
converter does not know raises.

``adapter_from_jax`` carries a JAX package LoRA adapter
(megatronapp_tpu/inference/lora.py LoraAdapter) across as the port's
LoraAdapter: the same id and rank, its A and B stacks copied as fp32 numpy
(the ``.npz`` files of ``LoraAdapter.save`` are the other bridge).

Resident int8 leaves of a quantized JAX tree (its
inference/quantization.residentize_params: ``{"qint8": int8 [L, K, N],
"qscale": fp32 [L, 1, N]}`` under one of the RESIDENT_KERNELS) become the
port's resident leaves, one per layer, with their dtypes kept: int8 and
fp32, never cast to params_dtype.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.inference.quantization import (
    RESIDENT_KERNELS, is_resident_leaf,
)
from megatronapp_tpu_torch.utils.params import ParamTree

_TOP = {"final_ln_scale", "final_ln_bias", "output"}
_EMBEDDING = {"word", "pos"}
_LAYER = {"ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"}
_ATTENTION = {"q_kernel", "kv_kernel", "out_kernel", "q_bias", "kv_bias",
              "out_bias", "q_ln_scale", "k_ln_scale"}
# An MLA layer's attention leaves (JAX transformer/mla.py:32): q_proj, or
# q_down / q_ln_scale / q_up, then the kv path; out_kernel alone may be
# resident int8.
_MLA = {"q_proj", "q_down", "q_ln_scale", "q_up", "kv_down", "kv_ln_scale",
        "kv_up", "out_kernel"}
_MLP = {"fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias"}


def _tensor(a, cfg: TransformerConfig, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes arrays torch can't read
        a = a.astype(np.float32)
    # A copy: the trainer updates leaves in place, and numpy views of
    # JAX arrays are read-only.
    return torch.tensor(a, device=device).to(cfg.params_dtype)


def _leaves(sub: Mapping, allowed: set, where: str) -> Dict[str, object]:
    for name, val in sub.items():
        if name not in allowed or (isinstance(val, Mapping) and not (
                name in RESIDENT_KERNELS and is_resident_leaf(dict(val)))):
            raise KeyError(f"params_from_jax: unknown leaf {where}{name}")
    return dict(sub)


def _layer_leaf(v, i: int, cfg: TransformerConfig, device):
    """Layer i of a stacked leaf: a tensor in params_dtype, or a resident
    leaf whose int8 and fp32 slices keep their dtypes."""
    if isinstance(v, Mapping):
        return ParamTree({"qint8": torch.tensor(
                              np.asarray(v["qint8"])[i], dtype=torch.int8,
                              device=device),
                          "qscale": torch.tensor(
                              np.asarray(v["qscale"])[i],
                              dtype=torch.float32, device=device)})
    return _tensor(np.asarray(v)[i], cfg, device)


def params_from_jax(tree: Mapping, cfg: TransformerConfig,
                    device="cpu") -> ParamTree:
    for name, val in tree.items():
        if name not in _TOP | {"embedding", "block"} or \
                (name in _TOP and isinstance(val, Mapping)):
            raise KeyError(f"params_from_jax: unknown leaf {name}")
    top = {k: _tensor(v, cfg, device) for k, v in tree.items()
           if k in _TOP}
    emb = {k: _tensor(v, cfg, device)
           for k, v in _leaves(tree["embedding"], _EMBEDDING,
                               "embedding.").items()}
    block = tree["block"]
    subs = {"attention": _MLA if cfg.multi_latent_attention else _ATTENTION,
            "mlp": _MLP}
    for name, val in block.items():
        if name not in _LAYER and name not in subs:
            raise KeyError(f"params_from_jax: unknown leaf block.{name}")
        if (name in subs) != isinstance(val, Mapping):
            raise KeyError(f"params_from_jax: unknown leaf block.{name}")
    for name, allowed in subs.items():
        _leaves(block[name], allowed, f"block.{name}.")
    num = np.asarray(block["ln1_scale"]).shape[0]
    if num != cfg.num_layers:
        raise ValueError(f"params_from_jax: block has {num} layers, cfg "
                         f"{cfg.num_layers}")

    def layer(i: int) -> ParamTree:
        children = {}
        for n in subs:
            leaves = {k: _layer_leaf(v, i, cfg, device)
                      for k, v in block[n].items()}
            children[n] = ParamTree(
                {k: v for k, v in leaves.items()
                 if not isinstance(v, nn.Module)},
                **{k: v for k, v in leaves.items()
                   if isinstance(v, nn.Module)})
        return ParamTree({k: _tensor(np.asarray(v)[i], cfg, device)
                          for k, v in block.items() if k in _LAYER},
                         **children)

    return ParamTree(top, embedding=ParamTree(emb),
                     layers=nn.ModuleList(layer(i) for i in range(num)))


def adapter_from_jax(jax_adapter):
    """The port's LoraAdapter with a JAX LoraAdapter's id, rank and
    factors (``a`` / ``b`` per target, copied as fp32 numpy)."""
    from megatronapp_tpu_torch.inference.lora import (
        LORA_TARGETS, LoraAdapter,
    )
    a = {t: np.array(jax_adapter.a[t], np.float32) for t in LORA_TARGETS}
    b = {t: np.array(jax_adapter.b[t], np.float32) for t in LORA_TARGETS}
    return LoraAdapter(jax_adapter.adapter_id, int(jax_adapter.rank), a, b)
