"""Parameter containers addressed like the JAX package's param pytrees.

``ParamTree`` is an ``nn.Module`` whose parameters and submodules are read
with the pytree's key syntax (``p["q_kernel"]``, ``"q_bias" in p``,
``p.get("ln1_bias")``), so the layer functions keep the JAX code's shape
while the weights live in modules (``state_dict`` names such as
``layers.3.attention.q_kernel``). The stacked JAX ``block`` leaves become
one ``ParamTree`` per layer in an ``nn.ModuleList``.

Leaves are made frozen (``requires_grad=False``), so serving runs no
autograd; the trainer makes them trainable with ``tree.requires_grad_()``
at setup (``training/train.py``).

A resident int8 weight (inference/quantization.py) is a child
``ParamTree`` ``{"qint8": int8 [K, N], "qscale": fp32 [1, N]}`` under the
kernel's name: frozen like any leaf, moved by ``.to(device)`` with the
rest of the tree. (``.to(dtype)`` would cast its fp32 scales too: cast a
tree before quantizing it.)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


class ParamTree(nn.Module):
    def __init__(self, leaves: Optional[Dict[str, torch.Tensor]] = None,
                 **children: nn.Module):
        super().__init__()
        for name, t in (leaves or {}).items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        for name, m in children.items():
            self.add_module(name, m)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def normal(shape, std: float, dtype: torch.dtype, generator: torch.Generator,
           device) -> torch.Tensor:
    """N(0, std^2) draws made directly on `device` from `generator`."""
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, std, generator=generator)
