"""Cross entropy over the full vocabulary (the JAX package's
ops/cross_entropy.py:cross_entropy_loss). The vocab-parallel shard_map
form comes with tensor parallelism.

The per-token loss is a ``torch.autograd.Function`` whose backward builds
the logits' gradient, softmax(logits) · g - onehot(target) · g, in one
buffer: at llama3-8b's vocabulary a [4096, 128256] fp32 tensor is 2.1 GB,
and autograd through logsumexp and gather would hold three or four of
them at once.
"""

from __future__ import annotations

from typing import Optional

import torch


class _TokenCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, z_loss_coeff: float):
        logz = torch.logsumexp(logits, dim=-1)
        per_token = logz - logits.gather(-1, targets[..., None])[..., 0]
        if z_loss_coeff:
            per_token = per_token + z_loss_coeff * logz.square()
        ctx.save_for_backward(logits, logz, targets)
        ctx.z_loss_coeff = z_loss_coeff
        return per_token

    @staticmethod
    def backward(ctx, g):
        logits, logz, targets = ctx.saved_tensors
        coef = g
        if ctx.z_loss_coeff:
            coef = g * (1.0 + 2.0 * ctx.z_loss_coeff * logz)
        grad = torch.sub(logits, logz[..., None]).exp_()
        grad.mul_(coef[..., None])
        grad.scatter_add_(-1, targets[..., None], -g[..., None])
        return grad, None, None


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       loss_mask: Optional[torch.Tensor] = None,
                       z_loss_coeff: float = 0.0):
    """Token-mean CE. logits [B,S,V] (upcast to fp32), targets [B,S] int,
    loss_mask [B,S] (1 = count). Returns (loss, per_token_loss)."""
    per_token = _TokenCrossEntropy.apply(logits.float(), targets.long(),
                                         float(z_loss_coeff))
    if loss_mask is None:
        loss = per_token.mean()
    else:
        loss_mask = loss_mask.float()
        loss = (per_token * loss_mask).sum() / loss_mask.sum().clamp(min=1.0)
    return loss, per_token
