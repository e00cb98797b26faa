"""Cross entropy over the full vocabulary (the JAX package's
ops/cross_entropy.py ``cross_entropy_loss``) and over a vocab-parallel
one (its ``shard_map_cross_entropy``).

The per-token loss is a ``torch.autograd.Function`` whose backward builds
the logits' gradient, softmax(logits) · g - onehot(target) · g, in one
buffer: at llama3-8b's vocabulary a [4096, 128256] fp32 tensor is 2.1 GB,
and autograd through logsumexp and gather would hold three or four of
them at once.

The forward is the reference recipe: local max → all-reduce max, local
sum of exp → all-reduce sum, masked target pick → all-reduce sum (three
all-reduces over tp), with the z-loss on the global log-sum-exp; its
backward needs no collective. Under a rank grid (``ctx``) the logits are
this rank's vocabulary columns (tp rank r holds [r·V/tp, (r+1)·V/tp));
on one device, or at tp 1, they are the whole vocabulary and the same
Function runs with the all-reduces skipped. The token mean is the JAX
step's mean over the whole microbatch: each dp rank divides its masked
sum by the mask count over every dp rank's rows (one all-reduce over dp,
or over the dp × ep "batch" group, whose ranks split the rows under
expert parallelism), so the dp sum of the ranks' losses, and of their
gradients, is the global mean's. Under context parallelism each cp rank holds a share of every
row's tokens, and the count is all-reduced over cp too: the dp × cp sum
of the ranks' losses is JAX's loss.
"""

from __future__ import annotations

from typing import Optional

import torch


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """Per-token CE of this rank's vocabulary columns; ``mesh`` None (or
    a tp group of one rank) is the whole vocabulary, and the three
    all-reduces run nothing."""

    @staticmethod
    def forward(fctx, logits, targets, z_loss_coeff: float, mesh):
        from megatronapp_tpu_torch.parallel.collectives import all_reduce

        def tp_reduce(x, op="sum"):
            return x if mesh is None else all_reduce(x, mesh, "tp", op=op)

        v_local = logits.shape[-1]
        start = 0 if mesh is None else mesh.tp_rank * v_local
        gmax = tp_reduce(logits.max(dim=-1).values, op="max")
        sumexp = tp_reduce(torch.sub(logits, gmax[..., None]).exp_()
                           .sum(dim=-1))
        local = targets - start
        mine = (local >= 0) & (local < v_local)
        picked = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])
        picked = tp_reduce(torch.where(mine, picked[..., 0] - gmax, 0.0))
        logz = sumexp.log() + gmax
        per_token = sumexp.log() - picked
        if z_loss_coeff:
            per_token = per_token + z_loss_coeff * logz.square()
        fctx.save_for_backward(logits, logz, local, mine)
        fctx.z_loss_coeff = z_loss_coeff
        return per_token

    @staticmethod
    def backward(fctx, g):
        logits, logz, local, mine = fctx.saved_tensors
        coef = g
        if fctx.z_loss_coeff:
            coef = g * (1.0 + 2.0 * fctx.z_loss_coeff * logz)
        grad = torch.sub(logits, logz[..., None]).exp_()
        grad.mul_(coef[..., None])
        v_local = logits.shape[-1]
        grad.scatter_add_(-1, local.clamp(0, v_local - 1)[..., None],
                          torch.where(mine, -g, 0.0)[..., None])
        return grad, None, None, None


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       loss_mask: Optional[torch.Tensor] = None,
                       z_loss_coeff: float = 0.0, ctx=None,
                       count: Optional[torch.Tensor] = None):
    """Token-mean CE. logits [B,S,V] (upcast to fp32; under a ctx with tp
    > 1 this rank's V/tp vocabulary columns), targets [B,S] int,
    loss_mask [B,S] (1 = count). Returns (loss, per_token_loss); under a
    ctx with dp or cp > 1 the loss is this rank's share of the
    microbatch's mean (see the module docstring). count: the mean's
    denominator, when the caller has it (the pipeline's mask count over
    every microbatch, dp and cp rank): the loss is then sum(per_token ·
    mask) / count."""
    per_token = _VocabParallelCrossEntropy.apply(
        logits.float(), targets.long(), float(z_loss_coeff), ctx)
    if count is not None:
        mask = (torch.ones_like(per_token) if loss_mask is None
                else loss_mask.float())
        return (per_token * mask).sum() / count, per_token
    shares = 1 if ctx is None else ctx.batch * ctx.cp
    if loss_mask is None:
        if shares == 1:
            return per_token.mean(), per_token
        return per_token.sum() / (per_token.numel() * shares), per_token
    loss_mask = loss_mask.float()
    count = loss_mask.sum()
    if shares > 1:
        from megatronapp_tpu_torch.parallel.collectives import all_reduce
        count = count.clone()
        for axis in ("batch", "cp"):
            count = all_reduce(count, ctx, axis)
    loss = (per_token * loss_mask).sum() / count.clamp(min=1.0)
    return loss, per_token
