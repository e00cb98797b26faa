"""Parallelism configuration: the JAX package's
``config/parallel_config.py`` fields, names and ``__post_init__`` checks.

Ported axes: tensor parallelism (paged serving under ``--serve-tp``, and
training), data parallelism with the ZeRO-1 distributed optimizer,
pipeline parallelism (training: 1F1B, interleaved VPP, zero-bubble, the
'dfc' / 'bfc' chunk orders and the trace-driven planner), context
parallelism (training: ops/context_parallel.py's five modes), MegaFBD
(``forward_backward_disaggregating``: parallel/fbd.py) and MegaDPP
(``use_dpp``: runtime/dpp.py), expert parallelism (training:
transformer/moe.py's all-to-all dispatch on a dp × ep × tp grid, pp 1,
cp 1, without FBD or DPP) and FSDP (``fsdp``: every leaf's 'embed' axis
split over dp, parallel/sharding.py ``FSDP_RULES``; it composes with tp,
pp and cp, and raises beside ep > 1, MoE, FBD or DPP naming
``FSDP_UNPORTED_ITEM``; JAX's CLI has no flag for it, so
``ParallelConfig(fsdp=True)`` is the way in, as in JAX). The port runs
one process a rank, so ``infer_data_parallel`` divides a process count
where JAX divides a device count. An axis the port lacks raises when it
is set away from its default, naming the ROADMAP.md item that ports it
(``UNPORTED_PARALLEL_FIELDS``, empty since FSDP was ported).

JAX's compose checks (config/arguments.py:1163-1180, training/train.py
:240-249) hold here for every caller: FBD and DPP run their own
schedules, so a ``pp_schedule`` other than '1f1b' or the trace-driven
planner beside either raises with JAX's words. ``check_context_parallel``
holds JAX's parse-time checks of a context-parallel run
(config/arguments.py:1191-1204) with JAX's words.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Fields of axes the port lacks → (their flag, the ROADMAP.md item).
UNPORTED_PARALLEL_FIELDS: dict = {}

# What FSDP does not compose with yet, and the ROADMAP.md item that
# ports it.
FSDP_UNPORTED_ITEM = "Queue 1 item 4 (FSDP under ep, MoE, FBD and DPP)"


def fsdp_unported(what: str) -> str:
    """The refusal of FSDP beside `what`."""
    return (f"fsdp=True with {what} is not ported to megatronapp_tpu_torch "
            f"yet (ROADMAP.md {FSDP_UNPORTED_ITEM})")

# What MoE and expert parallelism do not compose with yet, and the
# ROADMAP.md item that ports it.
MOE_UNPORTED_ITEM = ("Queue 1 item 4 (MoE under pp, cp, FBD, DPP, MTP and "
                     "serve-tp)")


def moe_unported(what: str) -> str:
    """The refusal of `what` (MoE or expert parallelism under a layout or
    a feature the port does not compose it with yet)."""
    return (f"{what} is not ported to megatronapp_tpu_torch yet "
            f"(ROADMAP.md {MOE_UNPORTED_ITEM})")

# The pipeline schedule programs (parallel/schedule.py SCHEDULES).
PP_SCHEDULES = ("1f1b", "vpp", "zero-bubble")


@dataclasses.dataclass
class ParallelConfig:
    """Degrees of the parallel dimensions, with the JAX ParallelConfig's
    names and defaults.

    sequence_parallel: accepted, and read by nothing. In the JAX package
    only config/arguments.py reads it; its layers run the same numbers
    with or without it. So here it changes no number either, and it is
    switched off at tp 1 as JAX does.

    data_parallel: None infers it from the rank count
    (``infer_data_parallel``); distributed_optimizer: ZeRO-1, on by
    default as in JAX.

    Pipelines: virtual_pipeline_parallel model chunks a stage;
    pipeline_order_policy 'dfc' (depth-first chunks: the interleaved
    schedule) or 'bfc' (breadth-first: vpp sequential single-chunk
    passes); pp_schedule '1f1b' (interleaved when vpp > 1), 'vpp' (the
    same program, requiring vpp > 1) or 'zero-bubble' (the backward
    split into dgrad and wgrad instructions); pp_plan_from_trace lets
    parallel/schedule.py's Planner re-plan the schedule from the traced
    ring-hop spans. JAX's num_microbatches field, which nothing there
    reads, is left out: the trainer takes the count from the batch sizes
    (TrainingConfig).

    forward_backward_disaggregating: the world splits into a forward and
    a backward half, dp halved on each (parallel/fbd.py). use_dpp: at pp
    > 1 and tp 1 the step runs in one process through the readiness-
    ordered runtime over a [pp][dp] stage grid (runtime/dpp_train.py),
    dp taken from data_parallel (default 1); elsewhere the trainer logs
    that it runs the static 'bfc' order."""

    tensor_parallel: int = 1
    pipeline_parallel: int = 1
    context_parallel: int = 1
    expert_parallel: int = 1
    virtual_pipeline_parallel: int = 1
    sequence_parallel: bool = False
    data_parallel: Optional[int] = None
    distributed_optimizer: bool = True
    fsdp: bool = False
    forward_backward_disaggregating: bool = False
    pipeline_order_policy: str = "dfc"
    use_dpp: bool = False
    pp_schedule: str = "1f1b"
    pp_plan_from_trace: bool = False

    def __post_init__(self):
        for name in ("tensor_parallel", "pipeline_parallel",
                     "context_parallel", "expert_parallel",
                     "virtual_pipeline_parallel"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if self.data_parallel is not None and self.data_parallel < 1:
            raise ValueError(f"data_parallel must be >= 1, got "
                             f"{self.data_parallel}")
        if self.sequence_parallel and self.tensor_parallel == 1:
            self.sequence_parallel = False
        if self.pipeline_order_policy not in ("dfc", "bfc"):
            raise ValueError(
                f"pipeline_order_policy must be 'dfc' or 'bfc', got "
                f"{self.pipeline_order_policy!r}")
        if self.pp_schedule not in PP_SCHEDULES:
            raise ValueError(
                f"pp_schedule must be one of {PP_SCHEDULES}, "
                f"got {self.pp_schedule!r}")
        if self.pp_schedule == "vpp" and self.virtual_pipeline_parallel <= 1:
            raise ValueError(
                "pp_schedule 'vpp' requires virtual_pipeline_parallel > 1 "
                "(--num-layers-per-virtual-pipeline-stage); plain 1F1B "
                "is pp_schedule '1f1b'")
        if self.use_dpp and self.pp_schedule != "1f1b":
            raise ValueError(
                f"--pp-schedule {self.pp_schedule} does not compose with "
                "--use-dpp (the host-driven MegaDPP runtime schedules "
                "dynamically); drop one of the flags")
        if self.use_dpp and self.pp_plan_from_trace:
            raise ValueError(
                "--pp-plan-from-trace does not compose with --use-dpp (the "
                "host runtime already schedules dynamically); drop one")
        if self.forward_backward_disaggregating and (
                self.pp_schedule != "1f1b" or self.pp_plan_from_trace):
            raise ValueError(
                "--pp-schedule/--pp-plan-from-trace do not compose with "
                "--forward-backward-disaggregating (the FBD executor runs "
                "its own schedule); drop one")
        if self.expert_parallel > 1:
            under = [name for name, on in (
                ("pipeline_parallel > 1", self.pipeline_parallel > 1),
                ("context_parallel > 1", self.context_parallel > 1),
                ("forward_backward_disaggregating",
                 self.forward_backward_disaggregating),
                ("use_dpp", self.use_dpp)) if on]
            if under:
                raise NotImplementedError(moe_unported(
                    f"expert_parallel={self.expert_parallel} with "
                    f"{', '.join(under)}"))
        if self.fsdp:
            under = [name for name, on in (
                (f"expert_parallel={self.expert_parallel}",
                 self.expert_parallel > 1),
                ("forward_backward_disaggregating",
                 self.forward_backward_disaggregating),
                ("use_dpp", self.use_dpp)) if on]
            if under:
                raise NotImplementedError(fsdp_unported(", ".join(under)))
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name, (flag, item) in UNPORTED_PARALLEL_FIELDS.items():
            if getattr(self, name) != defaults[name]:
                raise ValueError(
                    f"{name}={getattr(self, name)!r} ({flag}) is not ported "
                    f"to megatronapp_tpu_torch yet (ROADMAP.md {item})")

    def infer_data_parallel(self, num_ranks: int) -> int:
        """dp = ranks / (tp·pp·cp·ep); an explicit data_parallel must
        agree."""
        denom = (self.tensor_parallel * self.pipeline_parallel *
                 self.context_parallel * self.expert_parallel)
        if num_ranks % denom != 0:
            raise ValueError(f"num_devices={num_ranks} not divisible by "
                             f"tp*pp*cp*ep={denom}")
        dp = num_ranks // denom
        if self.data_parallel is not None and self.data_parallel != dp:
            raise ValueError(
                f"explicit data_parallel={self.data_parallel} inconsistent "
                f"with num_devices={num_ranks} (inferred {dp})")
        return dp


def check_context_parallel(seq_length: int, context_parallel: int,
                           cp_comm_type: str = "p2p",
                           hierarchical_sizes: Optional[tuple] = None
                           ) -> None:
    """JAX's checks of a context-parallel run (config/arguments.py:
    1191-1204), with its words: seq_length divisible by cp, and
    hierarchical (a2a, ring) sizes that multiply to cp under cp_comm_type
    'a2a+p2p'."""
    if seq_length % (context_parallel or 1) != 0:
        raise ValueError("--seq-length must be divisible by "
                         "--context-parallel-size")
    if hierarchical_sizes:
        a2a_sz, ring_sz = hierarchical_sizes
        if a2a_sz * ring_sz != context_parallel:
            raise ValueError(
                f"--hierarchical-context-parallel-sizes {a2a_sz} {ring_sz} "
                f"must multiply to --context-parallel-size "
                f"({context_parallel})")
        if cp_comm_type != "a2a+p2p":
            raise ValueError(
                "--hierarchical-context-parallel-sizes requires "
                "--cp-comm-type a2a+p2p")
