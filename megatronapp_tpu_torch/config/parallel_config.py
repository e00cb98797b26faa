"""Parallelism configuration: the JAX package's
``config/parallel_config.py`` fields, names and ``__post_init__`` checks.

Ported axes: tensor parallelism (paged serving under ``--serve-tp``, and
training) and data parallelism with the ZeRO-1 distributed optimizer
(training). The port runs one process a rank, so ``infer_data_parallel``
divides a process count where JAX divides a device count. The other axes
raise when they are set away from their defaults, each naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Fields of axes the port lacks → (their flag, the ROADMAP.md item).
UNPORTED_PARALLEL_FIELDS = {
    "pipeline_parallel": ("--pipeline-model-parallel-size",
                          "Queue 1 item 4 (PP and VPP)"),
    "virtual_pipeline_parallel": ("--num-layers-per-virtual-pipeline-stage",
                                  "Queue 1 item 4 (PP and VPP)"),
    "context_parallel": ("--context-parallel-size",
                         "Queue 1 item 4 (CP)"),
    "expert_parallel": ("--expert-model-parallel-size",
                        "Queue 1 item 4 (MoE and EP)"),
    "fsdp": ("--use-custom-fsdp", "Queue 1 item 4 (FSDP)"),
    "forward_backward_disaggregating": (
        "--forward-backward-disaggregating", "Queue 1 item 5 (MegaFBD)"),
    "use_dpp": ("--use-dpp", "Queue 1 item 5 (MegaDPP)"),
    "pp_schedule": ("--pp-schedule", "Queue 1 item 4 (PP and VPP)"),
}


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
    default as in JAX."""

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
    use_dpp: bool = False
    pp_schedule: str = "1f1b"

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
