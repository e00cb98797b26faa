"""The optimizer: the JAX package's optax chain (training/optimizer.py),
term by term, on the port's named parameters.

    clip_by_global_norm(clip_grad)
    scale_by_adam(b1, b2, eps)          (or SGD: trace(momentum))
    add_decayed_weights(weight_decay, mask=name-based)   (Adam only)
    scale_by_learning_rate(lr_schedule)

Adam bias-corrects with count + 1 and puts eps outside the square root
(eps_root 0); the update is p + (-lr(count)) · u with the schedule read
at the pre-increment count, so the first update uses lr_schedule(0),
which is 0 during warmup. This is not ``torch.optim.AdamW``, whose
decoupled decay multiplies the params by (1 - lr·wd) and rounds
differently. The scalars (schedule, bias corrections) are computed in
fp32 as jnp does; the updates are in place on fp32 leaves.

At dp = 1 the JAX trainer builds the ZeRO-1 wrapper
(training/distributed_optimizer.py), whose arithmetic is this same chain
leaf for leaf; its sharded layout comes with the parallel-training slice.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from megatronapp_tpu_torch.config.training_config import OptimizerConfig

_NO_DECAY_SUFFIXES = ("_bias", "_scale")
_NO_DECAY_NAMES = frozenset({"A_log", "D"})


def lr_schedule(cfg: OptimizerConfig, train_iters: int):
    """step → learning rate (np.float32): linear warmup, then cosine /
    linear / constant decay to min_lr over lr_decay_iters."""
    decay_iters = cfg.lr_decay_iters or train_iters
    warmup = cfg.lr_warmup_iters
    f = np.float32

    def sched(step: int) -> np.float32:
        step = f(step)
        if step < warmup:
            return f(cfg.lr) * step / f(max(warmup, 1))
        frac = f(np.clip((step - f(warmup)) / f(max(decay_iters - warmup, 1)),
                         f(0.0), f(1.0)))
        if cfg.lr_decay_style == "cosine":
            return f(cfg.min_lr) + f(0.5) * f(cfg.lr - cfg.min_lr) * (
                f(1.0) + np.cos(f(math.pi) * frac))
        if cfg.lr_decay_style == "linear":
            return f(cfg.lr) + f(cfg.min_lr - cfg.lr) * frac
        return f(cfg.lr)

    return sched


def decays(name: str, param: torch.Tensor) -> bool:
    """The JAX weight-decay mask (optimizer.py:50-66): no decay for
    biases, norm scales and Mamba's per-channel leaves, by name; other
    leaves decay when they have more than one dim. Layer leaves
    (``layers.i.*``) count the JAX stack's leading layer axis."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith(_NO_DECAY_SUFFIXES) or leaf in _NO_DECAY_NAMES:
        return False
    stacked = name.startswith("layers.")
    return param.dim() + int(stacked) > 1


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32, on the device."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


class Optimizer:
    """The chain's state and update. State: {"count": int, "mu": {name:
    tensor}, "nu": {name: tensor}} (SGD keeps its trace in "mu"); the
    count advances only on applied updates (a skipped step keeps the
    state, as the JAX step's lax.cond does)."""

    def __init__(self, cfg: OptimizerConfig, train_iters: int):
        self.cfg = cfg
        self.sched = lr_schedule(cfg, train_iters)

    def init(self, named_params: Dict[str, torch.Tensor]) -> dict:
        state = {"count": 0,
                 "mu": {n: torch.zeros_like(p) for n, p in
                        named_params.items()}}
        if self.cfg.optimizer == "adam":
            state["nu"] = {n: torch.zeros_like(p)
                           for n, p in named_params.items()}
        return state

    @torch.no_grad()
    def update(self, named_params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict,
               grad_norm: Tuple[float, torch.Tensor]) -> None:
        """Apply one update in place (params, state and the grads, which
        it consumes). grad_norm: (host value, device fp32 scalar) of the
        grads' global norm."""
        cfg, f = self.cfg, np.float32
        norm_host, norm_dev = grad_norm
        count = state["count"]
        lr = float(self.sched(count))
        if cfg.clip_grad and not norm_host < cfg.clip_grad:
            for g in grads.values():
                g.div_(norm_dev).mul_(cfg.clip_grad)
        if cfg.optimizer == "adam":
            b1, b2 = cfg.adam_beta1, cfg.adam_beta2
            bc1 = float(f(1) - f(b1) ** f(count + 1))
            bc2 = float(f(1) - f(b2) ** f(count + 1))
            for name, p in named_params.items():
                g, mu, nu = grads[name], state["mu"][name], state["nu"][name]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).add_(g.square_(), alpha=1 - b2)
                u = torch.div(mu, bc1)
                u.div_(torch.div(nu, bc2).sqrt_().add_(cfg.adam_eps))
                if cfg.weight_decay and decays(name, p):
                    u.add_(p, alpha=cfg.weight_decay)
                p.add_(u.mul_(-lr))
        else:
            for name, p in named_params.items():
                trace = state["mu"][name]
                trace.mul_(cfg.sgd_momentum).add_(grads[name])
                p.add_(trace, alpha=-lr)
        state["count"] = count + 1
