"""Weights carried across from the JAX package.

``params_from_jax`` takes the JAX param pytree as numpy arrays (the
caller does ``jax.tree.map(np.asarray, params)``; the port itself never
imports JAX) and returns the port's ``ParamTree``. The stacked ``block``
leaves [L, ...] are unstacked into ``layers.i``; every other leaf keeps
its name and its [in, out] layout, so nothing is transposed. A MoE
layer's ``moe`` leaves (transformer/moe.py) come across the same way,
from JAX's uniform stack ([L, e, ...] expert stacks) or from its
``moe_layer_freq`` > 1 groups ({"moe": [G, ...], "dense": [G, freq − 1,
...]}: layer g·freq is group g's MoE layer, layer g·freq + 1 + j its
dense layer j); the router stays fp32, as JAX keeps it. The MTP
depth modules (``mtp``: a list of {hnorm_scale, enorm_scale, proj,
layer}, each layer unstacked) become ``mtp.d``. A leaf the converter does
not know raises.

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
_MOE = {"router_kernel", "fc1_kernel", "fc2_kernel", "shared_fc1",
        "shared_fc2"}


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


def _layer_leaf(v, i, cfg: TransformerConfig, device, name: str = ""):
    """Layer i (an index, or a tuple of them into a grouped stack) of a
    stacked leaf: a tensor in params_dtype (the router in fp32), or a
    resident leaf whose int8 and fp32 slices keep their dtypes."""
    if isinstance(v, Mapping):
        return ParamTree({"qint8": torch.tensor(
                              np.asarray(v["qint8"])[i], dtype=torch.int8,
                              device=device),
                          "qscale": torch.tensor(
                              np.asarray(v["qscale"])[i],
                              dtype=torch.float32, device=device)})
    if name == "router_kernel":
        return torch.tensor(np.asarray(np.asarray(v)[i], np.float32),
                            device=device)
    return _tensor(np.asarray(v)[i], cfg, device)


def params_from_jax(tree: Mapping, cfg: TransformerConfig,
                    device="cpu", ctx=None) -> ParamTree:
    """The port's ParamTree of the JAX tree (the one-device layout: its
    block stacked [L, ...], or grouped under moe_layer_freq > 1); ctx (a
    training grid): this rank's stage's pieces, their tp shards and its ep
    rank's experts (parallel/sharding.py shard_tree)."""
    if ctx is not None and (ctx.tp > 1 or ctx.pp > 1 or ctx.ep > 1
                            or ctx.parallel.fsdp):
        from megatronapp_tpu_torch.parallel.sharding import shard_tree
        return shard_tree(params_from_jax(tree, cfg, device), ctx)
    for name, val in tree.items():
        if name not in _TOP | {"embedding", "block", "mtp"} or \
                (name in _TOP and isinstance(val, Mapping)):
            raise KeyError(f"params_from_jax: unknown leaf {name}")
    top = {k: _tensor(v, cfg, device) for k, v in tree.items()
           if k in _TOP}
    emb = {k: _tensor(v, cfg, device)
           for k, v in _leaves(tree["embedding"], _EMBEDDING,
                               "embedding.").items()}
    block = tree["block"]
    attn = _MLA if cfg.multi_latent_attention else _ATTENTION
    grouped = cfg.is_moe and cfg.moe_layer_freq > 1
    if grouped:
        if set(block) != {"moe", "dense"}:
            raise KeyError("params_from_jax: a moe_layer_freq > 1 block "
                           f"holds 'moe' and 'dense', got {sorted(block)}")
        _check_block(block["moe"], {"attention": attn, "moe": _MOE},
                     "moe.")
        _check_block(block["dense"], {"attention": attn, "mlp": _MLP},
                     "dense.")
        num = np.asarray(block["moe"]["ln1_scale"]).shape[0] \
            * cfg.moe_layer_freq
    else:
        _check_block(block, {"attention": attn,
                             "moe" if cfg.is_moe else "mlp":
                             _MOE if cfg.is_moe else _MLP}, "")
        num = np.asarray(block["ln1_scale"]).shape[0]
    if num != cfg.num_layers:
        raise ValueError(f"params_from_jax: block has {num} layers, cfg "
                         f"{cfg.num_layers}")

    def layer(i: int) -> ParamTree:
        sub, at = block, i
        if grouped:
            g, j = divmod(i, cfg.moe_layer_freq)
            sub, at = ((block["moe"], g) if j == 0
                       else (block["dense"], (g, j - 1)))
        children = {}
        for n in ("attention", "mlp", "moe"):
            if n not in sub:
                continue
            leaves = {k: _layer_leaf(v, at, cfg, device, k)
                      for k, v in sub[n].items()}
            children[n] = ParamTree(
                {k: v for k, v in leaves.items()
                 if not isinstance(v, nn.Module)},
                **{k: v for k, v in leaves.items()
                   if isinstance(v, nn.Module)})
        return ParamTree({k: _tensor(np.asarray(v)[at], cfg, device)
                          for k, v in sub.items() if k in _LAYER},
                         **children)

    subs = {"attention": attn, "mlp": _MLP}
    children = {"embedding": ParamTree(emb),
                "layers": nn.ModuleList(layer(i) for i in range(num))}
    if tree.get("mtp"):
        children["mtp"] = nn.ModuleList(
            _mtp_depth(d, subs, cfg, device, f"mtp.{k}.")
            for k, d in enumerate(tree["mtp"]))
    return ParamTree(top, **children)


_MTP = {"hnorm_scale", "enorm_scale", "proj", "layer"}


def _check_block(block: Mapping, subs: Dict[str, set], where: str) -> None:
    """Raise on a leaf of a stacked layer tree that the converter does
    not know (subs: its sub-trees and their leaves)."""
    for name, val in block.items():
        if name not in _LAYER and name not in subs:
            raise KeyError(f"params_from_jax: unknown leaf block.{where}"
                           f"{name}")
        if (name in subs) != isinstance(val, Mapping):
            raise KeyError(f"params_from_jax: unknown leaf block.{where}"
                           f"{name}")
    for name, allowed in subs.items():
        if name not in block:
            raise KeyError(f"params_from_jax: block.{where}{name} is "
                           "missing")
        _leaves(block[name], allowed, f"block.{where}{name}.")


def _mtp_depth(depth: Mapping, subs, cfg: TransformerConfig, device,
               where: str) -> ParamTree:
    """One MTP depth module: its three leaves and its (unstacked)
    layer."""
    for name, val in depth.items():
        if name not in _MTP or (name == "layer") != isinstance(val,
                                                               Mapping):
            raise KeyError(f"params_from_jax: unknown leaf {where}{name}")
    layer = depth["layer"]
    for name, val in layer.items():
        if (name not in _LAYER and name not in subs) or \
                (name in subs) != isinstance(val, Mapping):
            raise KeyError(f"params_from_jax: unknown leaf {where}layer."
                           f"{name}")
    children = {n: ParamTree({k: _tensor(v, cfg, device) for k, v in
                              _leaves(layer[n], allowed,
                                      f"{where}layer.{n}.").items()})
                for n, allowed in subs.items()}
    return ParamTree(
        {k: _tensor(depth[k], cfg, device)
         for k in ("hnorm_scale", "enorm_scale", "proj")},
        layer=ParamTree({k: _tensor(v, cfg, device) for k, v in
                         layer.items() if k in _LAYER}, **children))


def adapter_from_jax(jax_adapter):
    """The port's LoraAdapter with a JAX LoraAdapter's id, rank and
    factors (``a`` / ``b`` per target, copied as fp32 numpy)."""
    from megatronapp_tpu_torch.inference.lora import (
        LORA_TARGETS, LoraAdapter,
    )
    a = {t: np.array(jax_adapter.a[t], np.float32) for t in LORA_TARGETS}
    b = {t: np.array(jax_adapter.b[t], np.float32) for t in LORA_TARGETS}
    return LoraAdapter(jax_adapter.adapter_id, int(jax_adapter.rank), a, b)
