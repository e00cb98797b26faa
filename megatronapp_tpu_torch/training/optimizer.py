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
leaf for leaf, so this class takes its moment dtypes: exp_avg_dtype /
exp_avg_sq_dtype bf16 store the moments in bf16 with the update math in
fp32 (the moment's decay term rounds in bf16 first, as JAX's weakly typed
``b1 * mu`` does). The port's ZeRO-1 (training/distributed_optimizer.py)
runs this class's leaf update on its dp shard of the grid's flat
buffers, with the model-wide norm of a sharded layout.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from megatronapp_tpu_torch.config.training_config import OptimizerConfig

_NO_DECAY_SUFFIXES = ("_bias", "_scale")
_NO_DECAY_NAMES = frozenset({"A_log", "D"})

STATE_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
                "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def resolve_state_dtype(name: str) -> torch.dtype:
    """'fp32'/'float32'/'bf16'/'bfloat16' → torch dtype (JAX
    distributed_optimizer.py resolve_state_dtype)."""
    try:
        return STATE_DTYPES[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"unknown optimizer-state dtype {name!r}; expected one of "
            f"{sorted(set(STATE_DTYPES))}") from None


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
    """sqrt of the sum of squares of every leaf, fp32, on the device (one
    device; a grid's model-wide norm, its sharded leaves' squares summed
    over tp and its replicated leaves counted once, is
    training/distributed_optimizer.py's)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


class Optimizer:
    """The chain's state and update. State: {"count": int, "mu": {name:
    tensor}, "nu": {name: tensor}} (SGD keeps its trace in "mu"); the
    count advances only on applied updates (a skipped step keeps the
    state, as the JAX step's lax.cond does)."""

    def __init__(self, cfg: OptimizerConfig, train_iters: int):
        self.cfg = cfg
        self.sched = lr_schedule(cfg, train_iters)
        self.mu_dtype = resolve_state_dtype(cfg.exp_avg_dtype)
        self.nu_dtype = resolve_state_dtype(cfg.exp_avg_sq_dtype)

    def init(self, named_params: Dict[str, torch.Tensor]) -> dict:
        state = {"count": 0,
                 "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype)
                        for n, p in named_params.items()}}
        if self.cfg.optimizer == "adam":
            state["nu"] = {n: torch.zeros_like(p, dtype=self.nu_dtype)
                           for n, p in named_params.items()}
        return state

    def scalars(self, count: int) -> Tuple[float, float, float]:
        """(lr, bias correction 1, bias correction 2) of the update at
        `count` (fp32, as jnp computes them)."""
        f, cfg = np.float32, self.cfg
        bc1 = float(f(1) - f(cfg.adam_beta1) ** f(count + 1))
        bc2 = float(f(1) - f(cfg.adam_beta2) ** f(count + 1))
        return float(self.sched(count)), bc1, bc2

    def update_leaf(self, decay: bool, p, g, mu, nu, lr: float, bc1: float,
                    bc2: float) -> None:
        """One leaf's (or one slice's) update in place: p, its moment(s)
        and g (consumed)."""
        cfg = self.cfg
        if cfg.optimizer != "adam":
            if mu.dtype == torch.float32:
                mu.mul_(cfg.sgd_momentum).add_(g)
                p.add_(mu, alpha=-lr)
            else:
                t = (mu * cfg.sgd_momentum).float().add_(g)
                mu.copy_(t)
                p.add_(t, alpha=-lr)
            return
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        if mu.dtype == torch.float32:
            m = mu.mul_(b1).add_(g, alpha=1 - b1)
        else:
            m = (mu * b1).float().add_(g, alpha=1 - b1)
            mu.copy_(m)
        if nu.dtype == torch.float32:
            v = nu.mul_(b2).add_(g.square_(), alpha=1 - b2)
        else:
            v = (nu * b2).float().add_(g.square_(), alpha=1 - b2)
            nu.copy_(v)
        u = torch.div(m, bc1)
        u.div_(torch.div(v, bc2).sqrt_().add_(cfg.adam_eps))
        if cfg.weight_decay and decay:
            u.add_(p, alpha=cfg.weight_decay)
        p.add_(u.mul_(-lr))

    @torch.no_grad()
    def update(self, named_params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict,
               grad_norm: Tuple[float, torch.Tensor]) -> None:
        """Apply one update in place (params, state and the grads, which
        it consumes). grad_norm: (host value, device fp32 scalar) of the
        grads' global norm."""
        cfg = self.cfg
        norm_host, norm_dev = grad_norm
        count = state["count"]
        if cfg.clip_grad and not norm_host < cfg.clip_grad:
            for g in grads.values():
                g.div_(norm_dev).mul_(cfg.clip_grad)
        lr, bc1, bc2 = self.scalars(count)
        nu = state.get("nu", {})
        for name, p in named_params.items():
            self.update_leaf(decays(name, p), p, grads[name],
                             state["mu"][name], nu.get(name), lr, bc1, bc2)
        state["count"] = count + 1
