"""Parallelism configuration: the field of the JAX package's
``config/parallel_config.py`` that serving consults, with its name.

Only tensor parallelism is ported (tensor-parallel paged serving,
``--serve-tp``); the training axes (pp, cp, ep, dp, sequence parallel,
ZeRO, FSDP) come with the parallel-training slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ParallelConfig:
    """Degrees of the parallel dimensions (the JAX ParallelConfig's
    names); the port takes tensor_parallel."""

    tensor_parallel: int = 1

    def __post_init__(self):
        if self.tensor_parallel < 1:
            raise ValueError(f"tensor_parallel {self.tensor_parallel} < 1")
