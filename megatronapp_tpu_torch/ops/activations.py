"""Activation functions + gated-MLP helpers (the JAX package's
ops/activations.py)."""

from __future__ import annotations

import torch.nn.functional as F

from megatronapp_tpu_torch.config.transformer_config import ActivationKind


def gelu(x):
    # tanh approximation, as jax.nn.gelu(approximate=True).
    return F.gelu(x, approximate="tanh")


def squared_relu(x):
    return F.relu(x).square()


def apply_activation(kind: ActivationKind, x, gate=None):
    """Apply activation; for gated kinds `x` is the value and `gate` the
    gate branch (swiglu(y) = silu(gate) * value)."""
    if kind in (ActivationKind.swiglu, ActivationKind.geglu) \
            and gate is None:
        raise ValueError(f"{kind} needs the gate half")
    if kind == ActivationKind.swiglu:
        return F.silu(gate) * x
    if kind == ActivationKind.geglu:
        return gelu(gate) * x
    if kind == ActivationKind.gelu:
        return gelu(x)
    if kind == ActivationKind.relu:
        return F.relu(x)
    if kind == ActivationKind.squared_relu:
        return squared_relu(x)
    raise ValueError(f"unknown activation {kind}")


def is_gated(kind: ActivationKind) -> bool:
    return kind in (ActivationKind.swiglu, ActivationKind.geglu)
