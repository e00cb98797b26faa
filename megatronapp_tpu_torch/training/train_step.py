"""The train step: microbatch gradient accumulation, then the optimizer
update (the JAX package's training/train_step.py:make_train_step without
the pipeline, fp8 and manual ZeRO-1 branches).

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

from megatronapp_tpu_torch.trace.tracer import get_tracer
from megatronapp_tpu_torch.training.optimizer import Optimizer, global_norm
from megatronapp_tpu_torch.utils.device import host_to


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module
    opt_state: dict
    step: int = 0


def named_trainable(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in params.named_parameters() if p.requires_grad}


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    check_nan: bool = True):
    """loss_fn(params, micro) -> (loss, metrics dict of scalar tensors).

    Returns step(state, batch) -> metrics (host floats); batch holds
    [num_micro, micro_batch, ...] tensors on the params' device. The
    state is updated in place."""

    tracer = get_tracer()

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
        num_micro = next(iter(batch.values())).shape[0]
        loss_sum = None
        aux_sum: Dict[str, torch.Tensor] = {}
        for i in range(num_micro):
            micro = {k: v[i] for k, v in batch.items()}
            with tracer.scope("forward"):
                loss, metrics = loss_fn(state.params, micro)
            with tracer.scope("loss"):
                ld = loss.detach()
                loss_sum = ld if loss_sum is None else loss_sum + ld
                for k, v in metrics.items():
                    v = v.detach().float()
                    aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
            with tracer.scope("backward"):
                loss.backward()
            del loss
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
        del grads
        out = {"loss": loss_h, "grad_norm": norm_h,
               "lr": float(optimizer.sched(state.step)),
               "skipped": int(skipped)}
        out.update(zip(names, host[2:]))
        state.step += 1
        return out

    return step


def to_device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy [num_micro, mb, ...] arrays → tensors on `device`."""
    return {k: host_to(v, device) for k, v in batch.items()}
