"""The train step: microbatch gradient accumulation, then the optimizer
update (the JAX package's training/train_step.py:make_train_step), and
the forward-only eval step (make_eval_step).

Per-microbatch gradients accumulate in fp32 in the params' ``.grad``
(the params are fp32), then scale by 1/num_micro; the loss and metrics
are microbatch means. The global grad norm and the loss are read to the
host once per step — the step's only synchronisation — and a step whose
loss or norm is not finite keeps the params and the optimizer state
(the JAX step's lax.cond skip). Metrics: loss, grad_norm, lr, skipped,
lm_loss, moe_aux_loss.

MegaScan's schedule-phase spans (trace/tracer.py) sit at the host points
of this eager loop, each stamped in stream order: per microbatch
'forward' (the loss function), 'loss' (the loss and metrics summed) and
'backward' (loss.backward()); then 'allreduce' (the grads scaled by
1/num_micro, their global norm and the host read of loss and norm; on one
device there is no reduction to run) and 'optimizer' (the update). They
record nothing outside a traced iteration.

Under a rank grid (``ctx``; the optimizer a
training/distributed_optimizer.py ``DistributedOptimizer``) each rank runs
its dp rows (dp × ep rows under expert parallelism) of each microbatch
through its tp shards; the microbatch losses are this rank's shares of
the token mean over every dp rank's rows (ops/cross_entropy.py), and a
MoE model's aux loss is each rank's share of it (transformer/moe.py). Under pp (``pipeline``, JAX train_step.py:161)
the loss function takes the whole batch and runs the pipeline's forward
and backward (its own 'forward', 'loss' and 'backward' spans): the loss
is the last stage's share of the token mean over all microbatches, the
other stages report zeros. The 'allreduce' span then does the grid's work:
the gradient reduction (tp for the tp-partial leaves, then cp, then dp: a
reduce-scatter under ZeRO-1, an all-reduce without), the model-wide norm
and the metrics (each rank's norm partials and loss shares all-gathered
over the world and summed in rank order, so every rank reads the same
bits), and the host read. Loss and metrics are then means over dp: the
loss shares of a cp group's ranks (each its share of the sequence) add
up to their rows' loss.

fp8 (a TrainState with ``fp8``, training/fp8.py): each microbatch's loss
function gets the step's ``Fp8Step``; the ring Functions' backwards
leave their observations there, combined over the microbatches by
``fp8_accumulate``'s rules. A finite step installs ``fp8_carry_sat(old,
observed)`` into the state's tensors in place; a skipped one keeps the
old state. The fp8 state never meets the 1/num_micro scaling, the norm or
the optimizer (JAX train_step.py:96-104). ZeRO-1's param return follows
the optimizer's dist_opt_comm (training/distributed_optimizer.py).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from megatronapp_tpu_torch.trace.tracer import get_tracer
from megatronapp_tpu_torch.training.optimizer import Optimizer, global_norm
from megatronapp_tpu_torch.training.train_state import TrainState
from megatronapp_tpu_torch.utils.device import host_to


def named_trainable(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in params.named_parameters() if p.requires_grad}


def _fp8_kw(state: TrainState, margin: int) -> dict:
    """The loss function's fp8 keyword: a new Fp8Step for the step when
    the state carries fp8."""
    if state.fp8 is None:
        return {}
    from megatronapp_tpu_torch.training.fp8 import Fp8Step
    return {"fp8": Fp8Step(state.fp8, margin)}


@torch.no_grad()
def _install_fp8(state: TrainState, fp8_step) -> None:
    """fp8_carry_sat(old, observed) copied into the state's tensors."""
    if fp8_step is None or fp8_step.observed is None:
        return
    from megatronapp_tpu_torch.training.fp8 import fp8_carry_sat, flat_fp8
    new = flat_fp8(fp8_carry_sat(state.fp8, fp8_step.observed))
    for key, old in flat_fp8(state.fp8).items():
        old.copy_(new[key])


def _accumulate(loss_fn: Callable, state: TrainState,
                batch: Dict[str, torch.Tensor], tracer, fp8_kw=None):
    """Each microbatch's forward, loss and backward (the grads accumulate
    in the params' .grad): (num_micro, the loss sum, the metric sums).
    fp8_kw: the loss function's fp8 keyword (``_fp8_kw``)."""
    num_micro = next(iter(batch.values())).shape[0]
    loss_sum = None
    aux_sum: Dict[str, torch.Tensor] = {}
    for i in range(num_micro):
        micro = {k: v[i] for k, v in batch.items()}
        with tracer.scope("forward"):
            loss, metrics = loss_fn(state.params, micro, **(fp8_kw or {}))
        with tracer.scope("loss"):
            ld = loss.detach()
            loss_sum = ld if loss_sum is None else loss_sum + ld
            for k, v in metrics.items():
                v = v.detach().float()
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
        with tracer.scope("backward"):
            loss.backward()
        del loss
    return num_micro, loss_sum, aux_sum


def _pipelined(loss_fn: Callable, state: TrainState,
               batch: Dict[str, torch.Tensor], tracer, fp8_kw=None):
    """The pipeline's forward and backward over the whole batch (the
    loss function runs both, with its own phase spans): (1, the loss,
    the metrics)."""
    loss, metrics = loss_fn(state.params, batch)
    return 1, loss.detach(), {k: v.detach().float()
                              for k, v in metrics.items()}


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    check_nan: bool = True, ctx=None,
                    pipeline: bool = False, fp8_margin: int = 0):
    """loss_fn(params, micro) -> (loss, metrics dict of scalar tensors).

    Returns step(state, batch) -> metrics (host floats); batch holds
    [num_micro, micro_batch, ...] tensors on the params' device (under a
    ctx: this dp rank's rows). The state is updated in place. ctx: the
    rank grid (see the module docstring). pipeline (a grid with pp > 1,
    JAX make_train_step's pipeline mode): loss_fn(params, batch) takes
    the whole [num_micro, ...] batch, runs the pipeline's forward and
    backward itself (models/gpt.py gpt_pipeline_loss) and returns the
    step's token-mean loss share, so the grads take no 1/num_micro.
    fp8_margin: the delayed scaling's margin (a state with fp8, module
    docstring)."""

    tracer = get_tracer()
    if ctx is not None:
        return _grid_step(loss_fn, optimizer, check_nan, ctx, tracer,
                          _pipelined if pipeline else _accumulate,
                          fp8_margin)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, float]:
        params = named_trainable(state.params)
        if not params:
            raise ValueError("make_train_step: no trainable params (call "
                             "params.requires_grad_() at setup)")
        bad = [n for n, p in params.items() if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"make_train_step: params {bad[:3]} are not "
                             "fp32; bf16 params with an fp32 master copy "
                             "are not ported")
        for p in params.values():
            p.grad = None
        fp8_kw = _fp8_kw(state, fp8_margin)
        num_micro, loss_sum, aux_sum = _accumulate(loss_fn, state, batch,
                                                   tracer, fp8_kw)
        inv = 1.0 / num_micro
        with tracer.scope("allreduce"):
            grads = {}
            for n, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                grads[n] = g.mul_(inv)
                p.grad = None
            norm = global_norm(grads.values())
            names = list(aux_sum)
            host = torch.stack([loss_sum * inv, norm]
                               + [aux_sum[k] * inv for k in names]).tolist()
        loss_h, norm_h = host[0], host[1]
        finite = math.isfinite(loss_h) and math.isfinite(norm_h)
        skipped = check_nan and not finite
        with tracer.scope("optimizer"):
            if not skipped:
                optimizer.update(params, grads, state.opt_state,
                                 (norm_h, norm))
                _install_fp8(state, fp8_kw.get("fp8"))
        del grads
        out = {"loss": loss_h, "grad_norm": norm_h,
               "lr": float(optimizer.sched(state.step)),
               "skipped": int(skipped)}
        out.update(zip(names, host[2:]))
        state.step += 1
        return out

    return step


def _grid_step(loss_fn: Callable, optimizer, check_nan: bool, ctx,
               tracer, run: Callable, fp8_margin: int = 0):
    """The train step of a rank grid (module docstring); run: how the
    batch's forward and backward go (_accumulate, or _pipelined)."""
    from megatronapp_tpu_torch.parallel.collectives import all_gather_cat

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, float]:
        optimizer.zero_grad()
        fp8_kw = _fp8_kw(state, fp8_margin)
        num_micro, loss_sum, aux_sum = run(loss_fn, state, batch, tracer,
                                           fp8_kw)
        inv = 1.0 / num_micro
        names = list(aux_sum)
        with tracer.scope("allreduce"):
            optimizer.reduce_grads(inv)
            mine = torch.cat([optimizer.norm_partials(), torch.stack(
                [loss_sum * inv] + [aux_sum[k] * inv for k in names])])
            every = all_gather_cat(mine[None], ctx, "world", 0)
            # A cp group's ranks hold the same (cp-summed) grads: sharded
            # leaves' squares count once per cp group, the rest once per
            # (cp, tp) group (dp and ep ranks hold distinct chunks, or
            # distinct experts); the dp, ep and cp ranks' loss shares once
            # per tp group of the last stage (the other stages report
            # zeros).
            tp_lead = [r % ctx.tp == 0 for r in range(ctx.world)]
            cp_lead = [r // ctx.tp % ctx.cp == 0 for r in range(ctx.world)]

            def weights(flags):
                return torch.tensor(flags, dtype=every.dtype,
                                    device=every.device)

            sharded = weights(cp_lead)
            once = weights([a and b for a, b in zip(tp_lead, cp_lead)])
            norm = (every[:, 0] * sharded + every[:, 1] * once).sum().sqrt()
            sums = (every[:, 2:] * weights(tp_lead)[:, None]).sum(dim=0)
            host = torch.cat([sums[:1], norm[None], sums[1:]]).tolist()
        loss_h, norm_h = host[0], host[1]
        finite = math.isfinite(loss_h) and math.isfinite(norm_h)
        skipped = check_nan and not finite
        with tracer.scope("optimizer"):
            if not skipped:
                optimizer.step(state.opt_state, (norm_h, norm))
                _install_fp8(state, fp8_kw.get("fp8"))
        optimizer.release_grads()
        out = {"loss": loss_h, "grad_norm": norm_h,
               "lr": float(optimizer.sched(state.step)),
               "skipped": int(skipped)}
        out.update(zip(names, host[2:]))
        state.step += 1
        return out

    return step


def make_eval_step(loss_fn: Callable, ctx=None, pipeline: bool = False,
                   fp8_margin: int = 0):
    """Forward-only loss (JAX train_step.py:297): the mean of the
    microbatch losses under torch.no_grad(), on the device (a 0-d fp32
    tensor; the caller reads it back). ctx: the rank grid; the dp (dp ×
    ep) and cp ranks' shares are summed over them. pipeline: loss_fn(params,
    batch, grad=False) runs the pipeline's forward over the whole batch;
    the last stage's dp shares (from tp rank 0) are summed over the
    world, so every rank reads the loss. A state with fp8 evaluates
    through the same fp8 forward as training (JAX train_step.py:304), its
    observations dropped.

    Returns eval_step(state, batch), batch as for the train step."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        if pipeline:
            from megatronapp_tpu_torch.parallel.collectives import (
                all_reduce,
            )
            loss, _ = loss_fn(state.params, batch, grad=False)
            keep = ctx.tp_rank == 0 and ctx.is_last_stage
            return all_reduce(loss.float() * float(keep), ctx, "world")
        num_micro = next(iter(batch.values())).shape[0]
        total = torch.zeros((), dtype=torch.float32,
                            device=next(iter(batch.values())).device)
        fp8_kw = _fp8_kw(state, fp8_margin)
        for i in range(num_micro):
            loss, _ = loss_fn(state.params, {k: v[i]
                                             for k, v in batch.items()},
                              **fp8_kw)
            total = total + loss.float()
        total = total / num_micro
        if ctx is not None:
            from megatronapp_tpu_torch.parallel.collectives import (
                all_reduce,
            )
            for axis in ("batch", "cp"):
                total = all_reduce(total, ctx, axis)
        return total

    return eval_step


def to_device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy [num_micro, mb, ...] arrays → tensors on `device`."""
    return {k: host_to(v, device) for k, v in batch.items()}
