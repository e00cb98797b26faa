"""GPT pretraining on one device or on a pp × dp × ep × cp × tp rank grid (the JAX
package's training/train.py:pretrain_gpt and its loop).

Params are made on the device from the seed (or given, e.g. carried
across from the JAX package by ``models/convert.py``) and made trainable.
The batch stream is the caller's iterator, else
``batch_iter_factory(consumed)`` (an indexed corpus, pretrain_gpt.py
--data-path), else mock batches from the seed, started at the consumed
sample count. Each step takes the rampup schedule's global batch
(training/num_microbatches_calculator.py) through ``_RowBuffer``,
reshaped to [num_micro, micro_batch, S], and runs the train step; losses
are kept at every log_interval, with step time, tokens/s and TFLOP/s,
and go to the metrics sinks (--metrics-jsonl, --tensorboard-dir).

As JAX's loop does on one device (train.py:350-453, :1027-1088):

- restore: the fresher of the local (non-persistent) and the durable
  checkpoint, a tie to the local one; the consumed-sample count from the
  side state, else the rampup schedule replayed over the restored steps;
- evaluation every eval_interval steps over eval_iters batches of the
  caller's eval stream, else of mock batches from seed + 1 (also when
  training reads a corpus, as JAX does);
- durable saves every save_interval steps and at the end, non-persistent
  saves every non_persistent_save_interval steps, and with
  --exit-signal-handler an emergency save of both on SIGTERM, after which
  the loop ends (``TrainResult.interrupted``); exit_interval ends the
  loop after a multiple of it.

The rerun machine, heartbeats, the straggler detector and the inspector
raise in ``TrainingConfig``.

MegaDPP (``parallel`` with use_dpp at pp > 1, one process, no ctx; JAX
train.py:490-545): the one-device trainer above, whose step and
evaluation run through runtime/dpp_train.py over the [pp][dp] stage grid
of ``stage_devices`` (dp: parallel.data_parallel, default 1; each
microbatch holds mb · dp rows), so checkpoints and resumes are the
one-device ones. On a rank grid with use_dpp at pp > 1 and tp or cp > 1
(or MTP) the trainer logs JAX's "falling back to static bfc" line and
runs the pipeline executor under the configured order (the entry point
sets 'bfc'); at tp = cp = 1 on a grid it raises: the DPP runtime is one
process.

MegaFBD (a ctx of parallel/fbd.py ``split_fbd_meshes``, every rank of
the world calling with its half's ctx): ``_pretrain_gpt_fbd`` (JAX
train.py:1123-1290).

On a rank grid (``ctx``, parallel/mesh.py; every rank calls this function
with its own ctx): each rank builds the same global batch (the same seed
or corpus; JAX's globalize_batch assumes the same) and takes its rows of
its (dp, ep) index, contiguous blocks of each microbatch (JAX's
``P(None, (dp, ep))``), whose whole sequences the model cuts to the
rank's cp share (models/gpt.py); the microbatch count is gbs / (mb · dp ·
ep), rampup stages included; the params are the tp shards and the ep
rank's experts of the one-device init (models/gpt.py); the optimizer
is training/distributed_optimizer.py's (ZeRO-1 unless
``distributed_optimizer`` is off). Checkpoints hold every leaf whole
(gathered over dp and tp, written once by rank 0's thread) under the
one-device leaf paths, so a run resumes on another grid (cp included:
the params are replicated over it); meta.json records the grid a step was
written under. A sequence length cp does not divide raises JAX's words
(config/parallel_config.py ``check_context_parallel``).

Pipelines (ctx.pp > 1, JAX train.py's pp wiring): each rank holds its
stage's pieces (models/gpt.py init_gpt_params), the step runs
models/gpt.py ``gpt_pipeline_loss`` over the whole [M, mb, S] batch
(make_train_step's pipeline mode) under parallel_cfg's pp_schedule and
pipeline_order_policy, evaluation runs the pipeline's forward, and the
last stage's loss reaches rank 0's log through the step's metrics
gather. Every rampup stage's microbatch count must divide by pp under
the interleaved 'dfc' order at vpp > 1 (``_validate_schedule_stages``).
``pp_plan_from_trace``: parallel/schedule.py's Planner on rank 0, fed by
every rank's traced ring-hop spans (gathered after a traced iteration)
and the whole-step times; at a log step it may re-plan, rank 0
broadcasts the choice, and every rank swaps the schedule program before
the next step with a loud log (JAX train.py:548-710). A packed batch
(segment_ids) freezes planning and reverts zero-bubble to 1f1b before
its step, as JAX does. Rank 0 alone logs and writes
metrics; the signal handler's flag is agreed over the world
(training/signals.py), so one rank's SIGTERM stops every rank at the same
step with one emergency save. Local (non-persistent) checkpoints stay on
one device (ROADMAP.md Queue 1 item 4).

TP overlap, fp8 and FSDP (``check_grid_features``, before any branch as
JAX checks them): a model with ``tp_comm_overlap`` runs its layers'
projections through parallel/overlap.py's rings on a grid, and with
``fp8`` their e4m3 twins; the fp8 state (training/fp8.py
``init_fp8_state``) rides the train state, so checkpoints carry it and
a resume restores it bitwise, and its /metrics gauges are exported at
each log step. ``ParallelConfig(fsdp=True)`` shards the params' 'embed'
axes over dp (parallel/sharding.py), with ZeRO-1 off
(training/distributed_optimizer.py).

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

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from megatronapp_tpu_torch.config.parallel_config import (
    check_context_parallel, moe_unported,
)
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.data.mock import mock_batches
from megatronapp_tpu_torch.models.gpt import (
    gpt_loss, gpt_pipeline_loss, init_gpt_params,
)
from megatronapp_tpu_torch.trace.tracer import get_tracer
from megatronapp_tpu_torch.training.checkpointing import (
    CheckpointManager, LocalCheckpointManager, read_side_state,
    write_side_state,
)
from megatronapp_tpu_torch.training.distributed_optimizer import (
    DistributedOptimizer,
)
from megatronapp_tpu_torch.training.metrics import MetricsLogger
from megatronapp_tpu_torch.training.num_microbatches_calculator import (
    build_calculator,
)
from megatronapp_tpu_torch.training.optimizer import Optimizer
from megatronapp_tpu_torch.training.train_state import (
    TrainState, load_state_dict, state_dict,
)
from megatronapp_tpu_torch.training.train_step import (
    make_eval_step, make_train_step, named_trainable, to_device_batch,
)
from megatronapp_tpu_torch.utils.device import resolve_device
from megatronapp_tpu_torch.utils.flops import flops_per_token

# Batch fields the GPT loss reads (position_ids are implied by the model).
_FIELDS = ("tokens", "labels", "loss_mask", "segment_ids")


def _quiet(_msg: str) -> None:
    """The log of ranks other than 0."""


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
    consumed_samples: int = 0      # the stream position, resume included
    # One entry per logged step: the step's metrics plus the window's
    # step_time_ms, tokens_per_sec and tflops.
    log: List[dict] = dataclasses.field(default_factory=list)
    # A signal's emergency save ended the run (--exit-signal-handler).
    interrupted: bool = False
    # (iteration, mean loss) of every evaluation.
    eval_losses: List[tuple] = dataclasses.field(default_factory=list)
    # Checkpoint seconds (host clock): "restore" (read and copy in),
    # "save" (each durable save call: the host copy and the write's
    # start), "wait" (the end's wait for the last write).
    checkpoint_s: Dict[str, object] = dataclasses.field(
        default_factory=lambda: {"restore": None, "save": [], "wait": None})


@contextlib.contextmanager
def _signal_exit_context(train_cfg: TrainingConfig, log_fn, ctx=None):
    """The graceful-exit handler for the loop (--exit-signal-handler).
    Python installs signal handlers on the main thread only: elsewhere
    the loop runs without one, with a log line."""
    if not train_cfg.exit_signal_handler:
        yield None
        return
    if threading.current_thread() is not threading.main_thread():
        log_fn("signals: --exit-signal-handler requires the main "
               "thread; running without a signal handler")
        yield None
        return
    from megatronapp_tpu_torch.training.signals import DistSignalHandler
    with DistSignalHandler.for_config(
            sigint=train_cfg.exit_signal_handler_sigint, ctx=ctx) as handler:
        yield handler


class _CheckpointScribe:
    """The loop's checkpoint moments in one place: interval durable,
    interval local, emergency and final, each with the side state (the
    exact stream position, _RowBuffer carry-over included). On a grid
    (dopt, the DistributedOptimizer) every rank gathers the whole state
    and rank 0 writes it; ``saved_step`` is the same on every rank."""

    def __init__(self, ckpt, local_ckpt, train_cfg: TrainingConfig,
                 layout, log_fn, dopt=None):
        self.ckpt = ckpt
        self.local_ckpt = local_ckpt
        self.cfg = train_cfg
        self.layout = layout
        self.log_fn = log_fn
        self.dopt = dopt
        self.lead = dopt is None or dopt.ctx.is_lead
        self.saved_step = ckpt.latest_step if ckpt is not None else None
        self.written_under = (None if dopt is None else {
            "dp": dopt.ctx.dp, "tp": dopt.ctx.tp, "zero1": dopt.zero1,
            **({"pp": dopt.ctx.pp, "vpp": dopt.ctx.vpp}
               if dopt.ctx.pp > 1 else {}),
            **({"cp": dopt.ctx.cp} if dopt.ctx.cp > 1 else {}),
            **({"fsdp": True} if dopt.ctx.parallel.fsdp else {}),
            **({"ep": dopt.ctx.ep} if dopt.ctx.ep > 1 else {})})

    def full_state(self, state: TrainState):
        """The state with whole leaves (None on ranks other than 0)."""
        if self.dopt is None:
            return state_dict(state)
        return self.dopt.full_state_dict(state)

    def save_durable(self, step: int, state: TrainState, consumed: int,
                     force: bool = False,
                     skip_if_current: bool = False) -> None:
        """Durable save + side state. skip_if_current: a step already
        saved is left alone (an emergency save on a save-interval
        step); the side state is rewritten either way."""
        if self.ckpt is None:
            return
        if not (skip_if_current and self.saved_step == step):
            flat = self.full_state(state)
            if self.lead:
                self.ckpt.save(step, flat, force=force, layout=self.layout,
                               written_under=self.written_under)
            self.saved_step = step
        if self.lead:
            write_side_state(self.cfg.save_dir, step,
                             {"consumed": int(consumed)})

    def save_local(self, step: int, state: TrainState, consumed: int,
                   what: str = "local checkpoint") -> None:
        """Best-effort local save, the side state inside: a failure warns
        and the run goes on."""
        if self.local_ckpt is None:
            return
        try:
            self.local_ckpt.save(step, state_dict(state),
                                 extra={"step": int(step),
                                        "consumed": int(consumed)})
        except Exception as e:  # noqa: BLE001 — best-effort path
            self.log_fn(f"{what} save failed at step {step} "
                        f"({type(e).__name__}: {e}); continuing — "
                        "local checkpoints are best-effort")


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


def dp_rows(batch: Dict[str, np.ndarray], ctx) -> Dict[str, np.ndarray]:
    """This rank's rows of [num_micro, mb·dp·ep, ...] microbatches: the
    contiguous block of its (dp, ep) index, dp_rank · ep + ep_rank, of each
    (JAX batch_shardings' P(None, (dp, ep)))."""
    if ctx is None or ctx.batch == 1:
        return batch
    mb = next(iter(batch.values())).shape[1] // ctx.batch
    r = ctx.batch_rank
    return {k: v[:, r * mb:(r + 1) * mb] for k, v in batch.items()}


def check_moe_training(model_cfg: TransformerConfig, ctx, parallel) -> None:
    """A MoE model trains on one device or a dp × ep × tp grid; under
    MegaFBD, MegaDPP, pp or cp it raises, naming its ROADMAP.md item."""
    if not model_cfg.is_moe:
        return
    par = ctx.parallel if ctx is not None else parallel
    for what, on in (
            ("MoE under MegaFBD (--forward-backward-disaggregating)",
             par is not None and par.forward_backward_disaggregating),
            ("MoE under MegaDPP (--use-dpp)", par is not None
             and par.use_dpp),
            ("MoE under pipeline parallelism", par is not None
             and par.pipeline_parallel > 1),
            ("MoE under context parallelism", par is not None
             and par.context_parallel > 1)):
        if on:
            raise NotImplementedError(moe_unported(what))


def gpt_microbatch_loss(cfg: TransformerConfig, ctx=None):
    def loss_fn(params, micro, fp8=None):
        return gpt_loss(params, micro["tokens"], micro["labels"],
                        micro["loss_mask"], cfg,
                        segment_ids=micro.get("segment_ids"), ctx=ctx,
                        fp8=fp8)
    return loss_fn


def check_grid_features(model_cfg: TransformerConfig, ctx, parallel
                        ) -> None:
    """fp8, the TP overlap rings and FSDP where they may run, checked
    before any other branch (JAX train.py:227-238: a silent no-op fp8 run
    is impossible on every path): fp8_ineligible_reason and the rings'
    divisibility in JAX's words, FSDP beside MoE layers naming its
    ROADMAP.md item."""
    from megatronapp_tpu_torch.config.parallel_config import (
        ParallelConfig, fsdp_unported,
    )
    from megatronapp_tpu_torch.config.transformer_config import (
        check_tp_comm_overlap,
    )
    par = ctx.parallel if ctx is not None else (parallel
                                                 or ParallelConfig())
    if model_cfg.fp8:
        from megatronapp_tpu_torch.training.fp8 import fp8_ineligible_reason
        reason = fp8_ineligible_reason(model_cfg, par)
        if reason is not None:
            raise ValueError(reason)
    check_tp_comm_overlap(model_cfg, par.tensor_parallel)
    if par.fsdp and model_cfg.is_moe:
        raise NotImplementedError(fsdp_unported("MoE layers"))


def gpt_pipeline_loss_fn(cfg: TransformerConfig, ctx, schedule: str,
                         order_policy: str):
    """The pipelined loss bound to one schedule program (a re-plan
    rebuilds through this)."""
    def loss_fn(params, batch, grad=True):
        return gpt_pipeline_loss(params, batch, cfg, ctx,
                                 schedule=schedule,
                                 order_policy=order_policy, grad=grad)
    return loss_fn


def _validate_schedule_stages(batch_calc, pp: int, vpp: int,
                              order_policy: str) -> None:
    """Fail at startup (not hours into a ramp) when any batch-size stage
    gives a microbatch count the interleaved pipeline cannot schedule
    (M % pp == 0 for vpp > 1 'dfc'; JAX train.py:165-178)."""
    if pp > 1 and vpp > 1 and order_policy == "dfc":
        for gbs_i, m_i in batch_calc.stages():
            if m_i % pp:
                raise ValueError(
                    f"batch size {gbs_i} in the schedule gives {m_i} "
                    f"microbatches, not divisible by pipeline_parallel="
                    f"{pp} as the interleaved (dfc) pipeline requires; "
                    "adjust the rampup schedule or use order_policy "
                    "'bfc'")


class _PipelinePlanning:
    """--pp-plan-from-trace on a grid (module docstring): rank 0's
    Planner, seeded with the running schedule; every rank calls each
    method (the spans' gather and the choice's broadcast are collective
    over the world)."""

    def __init__(self, model_cfg, ctx, schedule: str, num_micro: int,
                 log_fn):
        import dataclasses as dc

        from megatronapp_tpu_torch.parallel.schedule import Planner
        self.ctx, self.log_fn = ctx, log_fn
        self.frozen = False
        # JAX train.py:562-582: a stage body that carries cp collectives
        # keeps zero-bubble out of the planner's candidates.
        zb_realizable = ctx.cp == 1
        self.planner = Planner(ctx.pp, vpp=ctx.vpp, model_cfg=model_cfg,
                               allow_zero_bubble=zb_realizable)
        if not zb_realizable:
            log_fn("pp-planner: zero-bubble candidate DISABLED on this "
                   "mesh — the stage body carries collectives "
                   "(tp-sharded rings / cp ring / moe ep), so the "
                   "executor runs zero-bubble as masked dual-vjp "
                   "compute that costs more than the bubble saves; "
                   "planning stays among the remaining schedules")
        plan0 = self.planner.plan(num_micro)
        # Seeded with the running schedule, so re-plans measure against
        # it; under vpp > 1 the candidate is named 'vpp'.
        seed = "vpp" if (ctx.vpp > 1 and schedule == "1f1b") else schedule
        self.planner.current = dc.replace(
            plan0, schedule=seed,
            bubble_fraction=plan0.candidates.get(seed,
                                                 plan0.bubble_fraction))
        log_fn(f"pp-planner: active (schedule {schedule!r}, modeled "
               f"bubble {self.planner.current.bubble_fraction:.4f}, "
               "candidates "
               f"{ {k: round(v, 4) for k, v in plan0.candidates.items()} }"
               f", stage costs "
               f"{[round(c, 3) for c in plan0.stage_costs]})")

    def ingest(self, records) -> None:
        """Every rank's records of a traced iteration, merged on rank 0
        into the planner (MegaScan → planner)."""
        import torch.distributed as dist
        every = [None] * self.ctx.world
        dist.all_gather_object(every, list(records),
                               group=self.ctx.world_group)
        if self.ctx.is_lead:
            self.planner.ingest_trace_events(
                [e for recs in every for e in recs])

    def decide(self, step_seconds: float, num_micro: int):
        """At a log step: rank 0 observes, exports and maybe re-plans;
        every rank gets the new schedule (None: keep)."""
        import torch.distributed as dist
        choice = [None]
        if self.ctx.is_lead:
            self.planner.observe_step(step_seconds)
            self.planner.export_metrics()
            if not self.frozen:
                new = self.planner.maybe_replan(num_micro)
                choice[0] = None if new is None else new.schedule
        dist.broadcast_object_list(choice, src=0,
                                   group=self.ctx.world_group)
        return choice[0]

    def revert_to_1f1b(self) -> None:
        import dataclasses as dc
        cur = self.planner.current
        if cur is not None:
            self.planner.current = dc.replace(
                cur, schedule="1f1b", bubble_fraction=cur.candidates.get(
                    "1f1b", cur.bubble_fraction))


# The DPP runtime places every stage itself, in one process.
DPP_ONE_PROCESS = ("--use-dpp at tp 1 runs in one process over a [pp][dp] "
                   "stage grid (runtime/dpp_train.py); launch it without "
                   "torchrun, with --pipeline-model-parallel-size and "
                   "--data-parallel-size")


def pretrain_gpt(model_cfg: TransformerConfig, train_cfg: TrainingConfig,
                 opt_cfg: OptimizerConfig, device=None,
                 batch_iter: Optional[Iterator[Dict[str, np.ndarray]]] = None,
                 log_fn: Callable[[str], None] = print,
                 params: Optional[torch.nn.Module] = None,
                 batch_iter_factory: Optional[Callable] = None,
                 eval_batch_iter: Optional[
                     Iterator[Dict[str, np.ndarray]]] = None,
                 ctx=None, parallel=None) -> TrainResult:
    """End-to-end GPT pretraining loop on one device (the card unless
    device="cpu") or as one rank of the grid `ctx` (on ctx.device; see
    the module docstring). params: initial weights on `device` (default:
    made from train_cfg.seed; on a grid, this rank's shards); trained in
    place, then overwritten by a restored checkpoint.
    batch_iter_factory(consumed) -> batch stream of global batches, used
    when batch_iter is None (resume-aware). parallel: without a ctx, a
    ParallelConfig with use_dpp at pp > 1 (MegaDPP in this process);
    with a ctx, ctx.parallel rules."""
    check_grid_features(model_cfg, ctx, parallel)
    if ctx is not None:
        check_context_parallel(train_cfg.seq_length, ctx.cp)
    check_moe_training(model_cfg, ctx, parallel)
    if ctx is not None and ctx.fbd_role is not None:
        return _pretrain_gpt_fbd(model_cfg, train_cfg, opt_cfg, ctx,
                                 params=params, batch_iter=batch_iter,
                                 log_fn=log_fn,
                                 batch_iter_factory=batch_iter_factory)
    device = ctx.device if ctx is not None else resolve_device(device)
    dpp = None
    if ctx is None and parallel is not None and (
            parallel.pipeline_parallel > 1 or parallel.tensor_parallel > 1):
        if not parallel.use_dpp or parallel.tensor_parallel > 1:
            raise ValueError(
                "pipeline_parallel / tensor_parallel > 1 in one process: "
                "only --use-dpp at tp 1 runs there; a pp x dp x tp grid "
                "is launched with torchrun (ctx)")
        dpp = parallel
    if ctx is not None and ctx.parallel.use_dpp and ctx.pp > 1:
        if ctx.tp == ctx.cp == 1 and not model_cfg.mtp_num_layers:
            raise ValueError(DPP_ONE_PROCESS)
        if ctx.is_lead:
            log_fn("dpp: layout has tp/cp/ep > 1 (or MTP) — host "
                   "runner needs one stage per device per replica; "
                   "falling back to static bfc SPMD ordering")
    dp = 1 if ctx is None else ctx.batch
    if dpp is not None:
        dp = dpp.data_parallel or 1
    lead = ctx is None or ctx.is_lead
    if not lead:
        log_fn = _quiet
    pp = 1 if ctx is None else ctx.pp
    num_micro = train_cfg.num_microbatches(dp)
    batch_calc = build_calculator(train_cfg.global_batch_size,
                                  train_cfg.micro_batch_size, dp,
                                  train_cfg.rampup_batch_size)
    if pp > 1:
        _validate_schedule_stages(batch_calc, pp, ctx.vpp,
                                  ctx.parallel.pipeline_order_policy)
    optimizer = (Optimizer(opt_cfg, train_cfg.train_iters) if ctx is None
                 else DistributedOptimizer(
                     opt_cfg, train_cfg.train_iters, ctx,
                     tied_embedding=not
                     model_cfg.untie_embeddings_and_output_weights))
    if params is None:
        gen = torch.Generator(device).manual_seed(train_cfg.seed)
        params = init_gpt_params(model_cfg, gen, device, ctx)
    params.requires_grad_(True)
    state = TrainState(params, optimizer.init(named_trainable(params)))
    if model_cfg.fp8:
        # The amax histories ride the train state (checkpointed, resumed
        # bitwise).
        from megatronapp_tpu_torch.training.fp8 import init_fp8_state
        state.fp8 = init_fp8_state(model_cfg, device)

    # Checkpoints: restore from load_dir (or save_dir when resuming the
    # same run), save only to save_dir.
    layout = {"pp": 1, "vpp": 1, "num_layers": model_cfg.num_layers}
    ckpt = (CheckpointManager(train_cfg.save_dir,
                              save_interval=train_cfg.save_interval)
            if train_cfg.save_dir else None)
    local_ckpt = None
    if (train_cfg.non_persistent_save_interval
            or train_cfg.non_persistent_ckpt_dir):
        np_dir = train_cfg.resolved_non_persistent_dir()
        if np_dir is None:
            log_fn("local checkpoints disabled: pass "
                   "--non-persistent-ckpt-dir or --save")
        else:
            if ctx is not None and ctx.world > 1:
                raise NotImplementedError(
                    "local (non-persistent) checkpoints on a rank grid are "
                    "not ported yet (ROADMAP.md Queue 1 item 4): durable "
                    "checkpoints (--save) are")
            local_ckpt = LocalCheckpointManager(np_dir)
    restore_dir = train_cfg.load_dir or train_cfg.save_dir
    loader = None
    if restore_dir:
        loader = (CheckpointManager(train_cfg.load_dir)
                  if train_cfg.load_dir
                  and train_cfg.load_dir != train_cfg.save_dir else ckpt)
    # The fresher of (local, durable) wins, a tie to the local copy; a
    # corrupt or stale local file falls to the durable path, and a
    # corrupt durable step walks back to the previous one.
    t_restore = time.perf_counter()
    template = state_dict(state) if ctx is None else None
    restored = side_state = None
    local_step = local_ckpt.latest_step if local_ckpt is not None else None
    durable_step = loader.latest_step if loader is not None else None
    if local_step is not None and (durable_step is None
                                   or local_step >= durable_step):
        out = local_ckpt.restore(template)
        if out is not None:
            restored, side_state = out
            log_fn(f"restoring from local checkpoint (step {local_step})")
    if restored is None and loader is not None:
        restored = loader.restore(template)
        if restored is not None:
            side_state = read_side_state(restore_dir,
                                         int(restored["step"]))
    start_step, restore_s = 0, None
    if restored is not None:
        if ctx is None:
            load_state_dict(state, restored)
        else:
            optimizer.load_full_state_dict(state, restored)
        del restored
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t_restore
        start_step = state.step
        log_fn(f"resumed from checkpoint at step {start_step}")
    if loader is not None and loader is not ckpt:
        loader.close()
    if side_state is not None and \
            int(side_state.get("step", -1)) != start_step:
        side_state = None    # a sidecar of another step: stale
    # The side state's stream position when present; else replay the
    # rampup schedule (consumed samples accumulate the actual sizes).
    if side_state is not None and "consumed" in side_state:
        consumed = int(side_state["consumed"])
    else:
        consumed = 0
        for _ in range(start_step):
            consumed += batch_calc.get(consumed)[0]
    if batch_iter is None:
        if batch_iter_factory is not None:
            batch_iter = batch_iter_factory(consumed)
        else:
            batch_iter = mock_batches(
                train_cfg.seq_length, model_cfg.vocab_size,
                train_cfg.global_batch_size, seed=train_cfg.seed,
                start_idx=consumed)

    pp_schedule = None if ctx is None else ctx.parallel.pp_schedule

    def build_steps(schedule):
        """(loss_fn, step_fn) for one schedule program."""
        fn = (gpt_pipeline_loss_fn(model_cfg, ctx, schedule,
                                   ctx.parallel.pipeline_order_policy)
              if pp > 1 else gpt_microbatch_loss(model_cfg, ctx))
        return fn, make_train_step(
            fn, optimizer, check_nan=train_cfg.check_for_nan_in_loss,
            ctx=ctx, pipeline=pp > 1, fp8_margin=model_cfg.fp8_margin)

    if dpp is not None:
        from megatronapp_tpu_torch.runtime.dpp_train import (
            make_dpp_eval_step, make_dpp_train_step, stage_devices,
        )
        grid = stage_devices(dpp.pipeline_parallel, dp, device)
        dpp_kw = dict(vpp=dpp.virtual_pipeline_parallel,
                      policy=dpp.pipeline_order_policy)
        loss_fn = None
        step_fn = make_dpp_train_step(
            optimizer, opt_cfg, model_cfg, grid, train_cfg.train_iters,
            check_nan=train_cfg.check_for_nan_in_loss, **dpp_kw)
        log_fn(f"dpp: dynamic runtime active (pp="
               f"{dpp.pipeline_parallel}, dp={dp}, vpp="
               f"{dpp.virtual_pipeline_parallel}, "
               f"policy={dpp.pipeline_order_policy})")
    else:
        loss_fn, step_fn = build_steps(pp_schedule)
    if pp > 1 and pp_schedule != "1f1b":
        log_fn(f"pipeline schedule: {pp_schedule} (instruction program "
               "executor, parallel/pipeline.py)")
    planning = None
    if pp > 1 and ctx.parallel.pp_plan_from_trace:
        planning = _PipelinePlanning(model_cfg, ctx, pp_schedule,
                                     num_micro, log_fn)

    def apply_schedule(new_schedule):
        nonlocal loss_fn, step_fn, eval_step_fn, pp_schedule
        log_fn(f"pp-planner: APPLYING schedule {new_schedule!r} (was "
               f"{pp_schedule!r}) — rebuilding the train step")
        pp_schedule = new_schedule
        loss_fn, step_fn = build_steps(new_schedule)
        if eval_step_fn is not None:
            eval_step_fn = make_eval_step(loss_fn, ctx, pipeline=True)

    eval_step_fn = None
    if train_cfg.eval_interval:
        # The caller's eval stream, else a distinct mock stream (seed +
        # 1) — also when training reads a corpus (JAX train.py:486).
        eval_step_fn = (make_eval_step(loss_fn, ctx, pipeline=pp > 1,
                                       fp8_margin=model_cfg.fp8_margin)
                        if dpp is None else
                        make_dpp_eval_step(model_cfg, grid, **dpp_kw))
        if eval_batch_iter is None:
            eval_batch_iter = mock_batches(
                train_cfg.seq_length, model_cfg.vocab_size,
                train_cfg.global_batch_size, seed=train_cfg.seed + 1)
    metrics_logger = MetricsLogger()
    if train_cfg.metrics_jsonl and lead:
        metrics_logger.add_jsonl(train_cfg.metrics_jsonl)
    if train_cfg.tensorboard_dir and lead:
        metrics_logger.add_tensorboard(train_cfg.tensorboard_dir,
                                       warn=log_fn)
    scribe = _CheckpointScribe(ckpt, local_ckpt, train_cfg, layout, log_fn,
                               dopt=None if ctx is None else optimizer)
    flops_tok = flops_per_token(model_cfg, train_cfg.seq_length)
    rows = _RowBuffer(batch_iter)
    result = TrainResult(state, [], 0.0, 0.0)
    result.checkpoint_s["restore"] = restore_s
    tracer = get_tracer()
    if train_cfg.trace:
        tracer.configure(
            enabled=True, trace_dir=train_cfg.trace_dir,
            interval=train_cfg.trace_interval,
            continuous_iterations=train_cfg.continuous_trace_iterations,
            granularity=train_cfg.trace_granularity,
            layout=_OneDevice() if ctx is None else ctx, device=device,
            rank=0 if ctx is None else ctx.rank)
    window_tokens, window_start = 0, time.perf_counter()
    window_iter = start_step
    # The tracer is process-wide: whatever ends the loop, a traced run
    # leaves it disabled, so a later run in the process records nothing.
    try:
        with _signal_exit_context(train_cfg, log_fn, ctx) as sig:
            for it in range(start_step, train_cfg.train_iters):
                tracer.iteration_begin(it)
                # Rampup: exactly cur_gbs rows from the stream; leftovers
                # carry over, so no sample is dropped.
                cur_gbs, cur_micro = batch_calc.get(consumed)
                batch = dp_rows(reshape_global_batch(rows.take(cur_gbs),
                                                     cur_micro), ctx)
                consumed += cur_gbs
                batch = to_device_batch({k: v for k, v in batch.items()
                                         if k in _FIELDS}, device)
                if pp > 1 and "segment_ids" in batch:
                    # Zero-bubble takes no packed batch: the first one
                    # freezes planning, and zero-bubble reverts to 1f1b
                    # before the step (grads are schedule-invariant).
                    if planning is not None and not planning.frozen:
                        planning.frozen = True
                        log_fn("pp-planner: packed batch in the stream — "
                               "planning frozen (zero-bubble does not "
                               "compose with packed sequences)")
                    if pp_schedule == "zero-bubble":
                        log_fn("zero-bubble does not compose with packed "
                               "sequences (segment_ids in batch) — "
                               "reverting to 1f1b (grads are schedule-"
                               "invariant; perf-only change)")
                        apply_schedule("1f1b")
                        if planning is not None:
                            planning.revert_to_1f1b()
                with tracer.scope("train-step"):
                    metrics = step_fn(state, batch)
                if tracer.active:
                    tracer.iteration_end(it)
                    if planning is not None:
                        planning.ingest(tracer.peek())
                    tracer.save()
                window_tokens += cur_gbs * train_cfg.seq_length
                if (it + 1) % train_cfg.log_interval == 0 or \
                        it + 1 == train_cfg.train_iters:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    now = time.perf_counter()
                    dt = now - window_start
                    result.tokens_per_sec = window_tokens / dt
                    result.step_time_ms = dt / (it + 1 - window_iter) * 1e3
                    tflops = result.tokens_per_sec * flops_tok / 1e12
                    result.losses.append(metrics["loss"])
                    result.log.append({
                        "iteration": it + 1, **metrics,
                        "step_time_ms": result.step_time_ms,
                        "tokens_per_sec": result.tokens_per_sec,
                        "tflops": tflops})
                    log_fn(f"iter {it + 1:6d}/{train_cfg.train_iters} | "
                           f"loss {metrics['loss']:.4f} | grad_norm "
                           f"{metrics['grad_norm']:.3f} | lr "
                           f"{metrics['lr']:.2e} | skipped "
                           f"{metrics['skipped']} | "
                           f"{result.step_time_ms:.1f} ms/step | "
                           f"{result.tokens_per_sec:,.0f} tok/s | "
                           f"{tflops:.1f} TFLOP/s/dev")
                    metrics_logger.log(it + 1, {
                        **metrics, "tokens_per_sec": result.tokens_per_sec,
                        "step_time_ms": result.step_time_ms,
                        "tflops_per_device": tflops})
                    if state.fp8 is not None:
                        from megatronapp_tpu_torch.training.fp8 import (
                            export_fp8_metrics,
                        )
                        export_fp8_metrics(state.fp8, model_cfg)
                    window_tokens, window_start = 0, now
                    window_iter = it + 1
                    if planning is not None:
                        new = planning.decide(result.step_time_ms / 1e3,
                                              cur_micro)
                        if new is not None:
                            apply_schedule(new)

                if eval_step_fn is not None and \
                        (it + 1) % train_cfg.eval_interval == 0:
                    t_eval = time.perf_counter()
                    totals = []
                    for _ in range(train_cfg.eval_iters):
                        eb = dp_rows(reshape_global_batch(
                            next(eval_batch_iter), num_micro), ctx)
                        totals.append(eval_step_fn(state, to_device_batch(
                            {k: v for k, v in eb.items() if k in _FIELDS},
                            device)))
                    eval_loss = float(torch.stack(totals).mean())
                    result.eval_losses.append((it + 1, eval_loss))
                    # Eval time stays out of the next train window.
                    window_start += time.perf_counter() - t_eval
                    log_fn(f"eval @ iter {it + 1}: loss {eval_loss:.4f} "
                           f"over {train_cfg.eval_iters} batches")

                if ckpt is not None and train_cfg.save_interval and \
                        (it + 1) % train_cfg.save_interval == 0:
                    t_save = time.perf_counter()
                    scribe.save_durable(it + 1, state, consumed)
                    save_dt = time.perf_counter() - t_save
                    result.checkpoint_s["save"].append(save_dt)
                    window_start += save_dt

                if local_ckpt is not None and \
                        train_cfg.non_persistent_save_interval and \
                        (it + 1) % train_cfg.non_persistent_save_interval \
                        == 0:
                    scribe.save_local(it + 1, state, consumed)

                # Graceful signal exit: the step above finished; force-save
                # the durable and local checkpoints with the side state and
                # end the run.
                if sig is not None and sig.should_exit():
                    log_fn(f"signal: exit requested — emergency checkpoint "
                           f"at iteration {it + 1}")
                    t_save = time.perf_counter()
                    scribe.save_durable(it + 1, state, consumed, force=True,
                                        skip_if_current=True)
                    scribe.save_local(it + 1, state, consumed,
                                      what="local emergency")
                    if ckpt is not None:
                        ckpt.wait()       # durable before exit
                    log_fn(f"signal: emergency save done in "
                           f"{time.perf_counter() - t_save:.2f}s; exiting "
                           "cleanly")
                    result.interrupted = True
                    break

                if train_cfg.exit_interval and \
                        (it + 1) % train_cfg.exit_interval == 0:
                    break
        if ckpt is not None:
            if train_cfg.save_interval and scribe.saved_step != state.step:
                t_save = time.perf_counter()
                scribe.save_durable(state.step, state, consumed, force=True)
                result.checkpoint_s["save"].append(
                    time.perf_counter() - t_save)
            t_wait = time.perf_counter()
            ckpt.wait()
            result.checkpoint_s["wait"] = time.perf_counter() - t_wait
    finally:
        if train_cfg.trace:
            tracer.finalize()
            tracer.configure(enabled=False)
        metrics_logger.close()
    result.consumed_samples = consumed
    return result


def _pretrain_gpt_fbd(model_cfg: TransformerConfig,
                      train_cfg: TrainingConfig, opt_cfg: OptimizerConfig,
                      ctx, *, params=None, batch_iter=None,
                      log_fn: Callable[[str], None] = print,
                      batch_iter_factory: Optional[Callable] = None
                      ) -> TrainResult:
    """The MegaFBD training path (JAX train.py:1123-1290 _pretrain_gpt_fbd),
    one rank of the world with its half's ctx (parallel/fbd.py).

    Both halves take the same global batches (rampup through the
    microbatch calculator over the halved dp, with JAX's stage check)
    and their dp rows of them; parallel/fbd.py ``FBDExecutor`` runs the
    step. The backward half holds the train state (ZeRO-1 over its dp):
    checkpoints are its state, written by its lead as the grid trainer
    writes them; a resume restores it, fast-forwards the stream by the
    rampup schedule replayed over the restored steps (JAX's bookkeeping),
    and streams the restored params to the forward half. The backward
    half's lead alone logs JAX's lines and writes the JSONL /
    TensorBoard rows loss, fwd_loss and grad_norm; every rank's
    TrainResult.log holds the same metrics. MegaScan: each traced
    iteration's 'train-step' scope on every rank. The path runs no
    evaluation and no local checkpoint, as JAX's; the signal handler and
    local checkpoints are not wired (JAX's warning)."""
    from megatronapp_tpu_torch.parallel.fbd import FBDExecutor
    backward = ctx.fbd_role == "backward"
    lead = backward and ctx.is_lead
    if not lead:
        log_fn = _quiet
    low = [v for v in (opt_cfg.exp_avg_dtype, opt_cfg.exp_avg_sq_dtype)
           if str(v).lower() not in ("fp32", "float32")]
    if low:
        raise ValueError(
            "--exp-avg-dtype/--exp-avg-sq-dtype bf16 are not supported "
            "with --forward-backward-disaggregating: the FBD path runs "
            "the replicated optax chain (ZeRO-1 wiring is a ROADMAP "
            "follow-up)")
    if train_cfg.exit_signal_handler or \
            train_cfg.non_persistent_save_interval:
        log_fn("WARNING: fault-tolerance flags (--exit-signal-"
               "handler/--heartbeat-dir/--ft-timeouts/--non-"
               "persistent-save-interval/--simulated-fault) are "
               "NOT wired into the forward_backward_disaggregating "
               "path yet — running without them")
    shape = {"pp": ctx.pp, "dp": ctx.dp, "tp": ctx.tp,
             **({"cp": ctx.cp} if ctx.cp > 1 else {})}
    log_fn(f"FBD: forward mesh {shape} | backward mesh {shape}")
    batch_calc = build_calculator(train_cfg.global_batch_size,
                                  train_cfg.micro_batch_size, ctx.dp,
                                  train_cfg.rampup_batch_size)
    if ctx.pp > 1:
        _validate_schedule_stages(batch_calc, ctx.pp, ctx.vpp,
                                  ctx.parallel.pipeline_order_policy)
    device = ctx.device
    if params is None:
        gen = torch.Generator(device).manual_seed(train_cfg.seed)
        params = init_gpt_params(model_cfg, gen, device, ctx)
    params.requires_grad_(True)
    optimizer = None
    if backward:
        optimizer = DistributedOptimizer(
            opt_cfg, train_cfg.train_iters, ctx,
            tied_embedding=not model_cfg.untie_embeddings_and_output_weights)
        state = TrainState(params, optimizer.init(named_trainable(params)))
    else:
        state = TrainState(params, {})
    executor = FBDExecutor(model_cfg, ctx, state, optimizer,
                           check_nan=train_cfg.check_for_nan_in_loss)

    # Checkpoints of the backward half's state.
    layout = {"pp": 1, "vpp": 1, "num_layers": model_cfg.num_layers}
    ckpt = (CheckpointManager(train_cfg.save_dir,
                              save_interval=train_cfg.save_interval)
            if train_cfg.save_dir and backward else None)
    start_step = 0
    restore_dir = train_cfg.load_dir or train_cfg.save_dir
    if restore_dir and backward:
        loader = (CheckpointManager(train_cfg.load_dir)
                  if train_cfg.load_dir
                  and train_cfg.load_dir != train_cfg.save_dir else ckpt)
        restored = loader.restore(None)
        if restored is not None:
            optimizer.load_full_state_dict(state, restored)
            del restored
            start_step = state.step
        if loader is not ckpt:
            loader.close()
    # The forward half learns the restored step from the backward lead.
    start_step = int(executor.agree([start_step])[0])
    if start_step:
        state.step = start_step
        executor.stream_params()
        log_fn(f"resumed from checkpoint at step {start_step}")
    consumed = 0
    for _ in range(start_step):
        consumed += batch_calc.get(consumed)[0]
    if batch_iter is None:
        if batch_iter_factory is not None:
            batch_iter = batch_iter_factory(consumed)
        else:
            batch_iter = mock_batches(
                train_cfg.seq_length, model_cfg.vocab_size,
                train_cfg.global_batch_size, seed=train_cfg.seed,
                start_idx=consumed)

    metrics_logger = MetricsLogger()
    if train_cfg.metrics_jsonl and lead:
        metrics_logger.add_jsonl(train_cfg.metrics_jsonl)
    if train_cfg.tensorboard_dir and lead:
        metrics_logger.add_tensorboard(train_cfg.tensorboard_dir,
                                       warn=log_fn)
    scribe = _CheckpointScribe(ckpt, None, train_cfg, layout, log_fn,
                               dopt=optimizer) if backward else None
    tracer = get_tracer()
    if train_cfg.trace:
        tracer.configure(
            enabled=True, trace_dir=train_cfg.trace_dir,
            interval=train_cfg.trace_interval,
            continuous_iterations=train_cfg.continuous_trace_iterations,
            granularity=train_cfg.trace_granularity, layout=ctx,
            device=device, rank=ctx.rank)
    result = TrainResult(state, [], 0.0, 0.0)
    rows = _RowBuffer(batch_iter)
    window_tokens, window_start = 0, time.perf_counter()
    window_iter = start_step
    try:
        for it in range(start_step, train_cfg.train_iters):
            tracer.iteration_begin(it)
            cur_gbs, cur_micro = batch_calc.get(consumed)
            batch = dp_rows(reshape_global_batch(rows.take(cur_gbs),
                                                 cur_micro), ctx)
            consumed += cur_gbs
            batch = to_device_batch({k: v for k, v in batch.items()
                                     if k in _FIELDS}, device)
            with tracer.scope("train-step"):
                metrics = executor.step(batch)
            if tracer.active:
                tracer.iteration_end(it)
                tracer.save()
            window_tokens += cur_gbs * train_cfg.seq_length
            if (it + 1) % train_cfg.log_interval == 0 or \
                    it + 1 == train_cfg.train_iters:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                now = time.perf_counter()
                dt = now - window_start
                result.tokens_per_sec = window_tokens / dt
                result.step_time_ms = dt / (it + 1 - window_iter) * 1e3
                result.losses.append(metrics["loss"])
                result.log.append({
                    "iteration": it + 1, **metrics,
                    "step_time_ms": result.step_time_ms,
                    "tokens_per_sec": result.tokens_per_sec,
                    "stream_s": executor.stream_s[-1]})
                log_fn(f"iter {it + 1:6d}/{train_cfg.train_iters} | "
                       f"loss {metrics['loss']:.4f} | fwd-mesh loss "
                       f"{metrics['fwd_loss']:.4f} | grad_norm "
                       f"{metrics['grad_norm']:.3f}")
                metrics_logger.log(it + 1, {
                    "loss": metrics["loss"],
                    "fwd_loss": metrics["fwd_loss"],
                    "grad_norm": metrics["grad_norm"]})
                window_tokens, window_start = 0, now
                window_iter = it + 1
            if scribe is not None and ckpt is not None and \
                    train_cfg.save_interval and \
                    (it + 1) % train_cfg.save_interval == 0:
                scribe.save_durable(it + 1, state, consumed)
            if train_cfg.exit_interval and \
                    (it + 1) % train_cfg.exit_interval == 0:
                break
        if ckpt is not None:
            if train_cfg.save_interval and scribe.saved_step != state.step:
                scribe.save_durable(state.step, state, consumed, force=True)
            ckpt.wait()
            ckpt.close()
    finally:
        if train_cfg.trace:
            tracer.finalize()
            tracer.configure(enabled=False)
        metrics_logger.close()
    result.consumed_samples = consumed
    return result
