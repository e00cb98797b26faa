"""GPT pretraining on one device (the JAX package's
training/train.py:pretrain_gpt and its loop, single-device part).

Params are made on the device from the seed (or given, e.g. carried
across from the JAX package by ``models/convert.py``) and made trainable;
mock batches come from the seed when no iterator is given; each global
batch is reshaped to [num_micro, micro_batch, S] and run through the
train step; losses are kept at every log_interval, with step time,
tokens/s and TFLOP/s. Checkpoints, evaluation, fault tolerance, the rerun
machine and batch-size rampup raise in ``TrainingConfig``; FBD and
pipelines are not options here (the entry point refuses their flags).

MegaScan (train_cfg.trace): the tracer (trace/tracer.py) is configured on
the trainer's device; iteration it is traced when it % trace_interval <
continuous_trace_iterations, with an 'iteration' window around the
batch and the step and a 'train-step' scope around the step (the step's
own phase spans nest inside); each traced iteration's records are
resolved at its end (one synchronization) and appended to
``<trace_dir>/benchmark-data-1-pipeline-1-tensor-1-process-0.json``, the
JAX trainer's file name on one device. Untraced iterations record
nothing. trace/aggregate.py merges the files into a Chrome trace.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.data.mock import mock_batches
from megatronapp_tpu_torch.models.gpt import gpt_loss, init_gpt_params
from megatronapp_tpu_torch.trace.tracer import get_tracer
from megatronapp_tpu_torch.training.optimizer import Optimizer
from megatronapp_tpu_torch.training.train_step import (
    TrainState, make_train_step, named_trainable, to_device_batch,
)
from megatronapp_tpu_torch.utils.device import resolve_device
from megatronapp_tpu_torch.utils.flops import flops_per_token

# Batch fields the GPT loss reads (position_ids are implied by the model).
_FIELDS = ("tokens", "labels", "loss_mask", "segment_ids")


@dataclasses.dataclass(frozen=True)
class _OneDevice:
    """The single-device layout, naming the trace file as the JAX
    trainer's mesh context does (dp 1, pp 1, tp 1)."""
    dp: int = 1
    pp: int = 1
    tp: int = 1


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    losses: list                   # loss at every logged step
    tokens_per_sec: float          # of the last log window
    step_time_ms: float            # of the last log window
    consumed_samples: int = 0
    # One entry per logged step: the step's metrics plus the window's
    # step_time_ms, tokens_per_sec and tflops.
    log: List[dict] = dataclasses.field(default_factory=list)


class _RowBuffer:
    """Takes exactly-n sample rows from a batch stream, carrying leftovers
    into the next take (train.py:_RowBuffer)."""

    def __init__(self, batch_iter):
        self._iter = batch_iter
        self._buf: Optional[Dict[str, np.ndarray]] = None

    def take(self, n: int) -> Dict[str, np.ndarray]:
        while self._buf is None or \
                next(iter(self._buf.values())).shape[0] < n:
            nxt = next(self._iter)
            self._buf = dict(nxt) if self._buf is None else {
                k: np.concatenate([self._buf[k], nxt[k]]) for k in self._buf}
        out = {k: v[:n] for k, v in self._buf.items()}
        rest = {k: v[n:] for k, v in self._buf.items()}
        self._buf = rest if next(iter(rest.values())).shape[0] else None
        return out


def reshape_global_batch(batch: Dict[str, np.ndarray], num_micro: int
                         ) -> Dict[str, np.ndarray]:
    """[global_batch, seq] → [num_micro, global_batch/num_micro, seq]."""
    return {k: v.reshape(num_micro, v.shape[0] // num_micro, *v.shape[1:])
            for k, v in batch.items()}


def gpt_microbatch_loss(cfg: TransformerConfig):
    def loss_fn(params, micro):
        return gpt_loss(params, micro["tokens"], micro["labels"],
                        micro["loss_mask"], cfg,
                        segment_ids=micro.get("segment_ids"))
    return loss_fn


def pretrain_gpt(model_cfg: TransformerConfig, train_cfg: TrainingConfig,
                 opt_cfg: OptimizerConfig, device=None,
                 batch_iter: Optional[Iterator[Dict[str, np.ndarray]]] = None,
                 log_fn: Callable[[str], None] = print,
                 params: Optional[torch.nn.Module] = None) -> TrainResult:
    """End-to-end GPT pretraining loop on one device (the card unless
    device="cpu"). params: initial weights on `device` (default: made
    from train_cfg.seed); trained in place."""
    device = resolve_device(device)
    num_micro = train_cfg.num_microbatches(1)
    optimizer = Optimizer(opt_cfg, train_cfg.train_iters)
    if params is None:
        gen = torch.Generator(device).manual_seed(train_cfg.seed)
        params = init_gpt_params(model_cfg, gen, device)
    params.requires_grad_(True)
    state = TrainState(params, optimizer.init(named_trainable(params)))
    if batch_iter is None:
        batch_iter = mock_batches(train_cfg.seq_length, model_cfg.vocab_size,
                                  train_cfg.global_batch_size,
                                  seed=train_cfg.seed)
    step_fn = make_train_step(gpt_microbatch_loss(model_cfg), optimizer,
                              check_nan=train_cfg.check_for_nan_in_loss)
    flops_tok = flops_per_token(model_cfg, train_cfg.seq_length)
    rows = _RowBuffer(batch_iter)
    result = TrainResult(state, [], 0.0, 0.0)
    gbs = train_cfg.global_batch_size
    tracer = get_tracer()
    if train_cfg.trace:
        tracer.configure(
            enabled=True, trace_dir=train_cfg.trace_dir,
            interval=train_cfg.trace_interval,
            continuous_iterations=train_cfg.continuous_trace_iterations,
            granularity=train_cfg.trace_granularity, layout=_OneDevice(),
            device=device)
    window_tokens, window_start, window_iter = 0, time.perf_counter(), 0
    # The tracer is process-wide: whatever ends the loop, a traced run
    # leaves it disabled, so a later run in the process records nothing.
    try:
        for it in range(train_cfg.train_iters):
            tracer.iteration_begin(it)
            batch = reshape_global_batch(rows.take(gbs), num_micro)
            batch = to_device_batch({k: v for k, v in batch.items()
                                     if k in _FIELDS}, device)
            with tracer.scope("train-step"):
                metrics = step_fn(state, batch)
            if tracer.active:
                tracer.iteration_end(it)
                tracer.save()
            result.consumed_samples += gbs
            window_tokens += gbs * train_cfg.seq_length
            if (it + 1) % train_cfg.log_interval and it + 1 != \
                    train_cfg.train_iters:
                continue
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            dt = now - window_start
            result.tokens_per_sec = window_tokens / dt
            result.step_time_ms = dt / (it + 1 - window_iter) * 1e3
            tflops = result.tokens_per_sec * flops_tok / 1e12
            result.losses.append(metrics["loss"])
            result.log.append({"iteration": it + 1, **metrics,
                               "step_time_ms": result.step_time_ms,
                               "tokens_per_sec": result.tokens_per_sec,
                               "tflops": tflops})
            log_fn(f"iter {it + 1:6d}/{train_cfg.train_iters} | "
                   f"loss {metrics['loss']:.4f} | grad_norm "
                   f"{metrics['grad_norm']:.3f} | lr {metrics['lr']:.2e} | "
                   f"skipped {metrics['skipped']} | "
                   f"{result.step_time_ms:.1f} ms/step | "
                   f"{result.tokens_per_sec:,.0f} tok/s | "
                   f"{tflops:.1f} TFLOP/s/dev")
            window_tokens, window_start, window_iter = 0, now, it + 1
    finally:
        if train_cfg.trace:
            tracer.finalize()
            tracer.configure(enabled=False)
    return result
