"""Global-batch-size schedule: the constant and linear-rampup calculators
(the JAX package's training/num_microbatches_calculator.py, Megatron's
num_microbatches_calculator.py).

``--rampup-batch-size <start> <increment> <samples>`` grows the global
batch from `start` to the configured global_batch_size in `increment`
steps spread evenly over `samples` consumed samples; every intermediate
size must divide by micro_batch_size * dp. Each size is one more batch
shape for the train step (eager here: nothing recompiles).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class ConstantCalculator:
    global_batch_size: int
    micro_batch_size: int
    data_parallel: int

    def get(self, consumed_samples: int) -> Tuple[int, int]:
        """(current_global_batch_size, num_microbatches)."""
        denom = self.micro_batch_size * self.data_parallel
        return self.global_batch_size, self.global_batch_size // denom

    def stages(self):
        """All distinct (global_batch_size, num_microbatches) pairs the
        schedule will ever produce — for fail-fast validation against
        schedule constraints (e.g. interleaved pipeline M % pp)."""
        return [self.get(0)]


@dataclasses.dataclass
class RampupCalculator:
    """Linear batch-size rampup (reference
    RampupBatchsizeNumMicroBatchesCalculator)."""

    start_batch_size: int
    batch_size_increment: int
    rampup_samples: int
    global_batch_size: int
    micro_batch_size: int
    data_parallel: int

    def __post_init__(self):
        denom = self.micro_batch_size * self.data_parallel
        diff = self.global_batch_size - self.start_batch_size
        if diff < 0 or self.batch_size_increment <= 0 or \
                diff % self.batch_size_increment != 0:
            raise ValueError(
                f"rampup: global({self.global_batch_size}) - "
                f"start({self.start_batch_size}) must be a non-negative "
                f"multiple of increment({self.batch_size_increment})")
        for bs in range(self.start_batch_size, self.global_batch_size + 1,
                        self.batch_size_increment):
            if bs % denom != 0:
                raise ValueError(
                    f"rampup: intermediate batch size {bs} not divisible "
                    f"by micro_batch_size*dp={denom}")
        self._num_increments = max(diff // self.batch_size_increment, 1)
        self._samples_per_increment = (self.rampup_samples /
                                       self._num_increments)

    def get(self, consumed_samples: int) -> Tuple[int, int]:
        """(current_global_batch_size, num_microbatches) at this point in
        the sample stream (reference update())."""
        if consumed_samples >= self.rampup_samples:
            bs = self.global_batch_size
        else:
            steps = int(consumed_samples / self._samples_per_increment)
            bs = min(self.start_batch_size +
                     steps * self.batch_size_increment,
                     self.global_batch_size)
        denom = self.micro_batch_size * self.data_parallel
        return bs, bs // denom

    def stages(self):
        """All distinct (global_batch_size, num_microbatches) pairs over
        the ramp, start → final (see ConstantCalculator.stages)."""
        denom = self.micro_batch_size * self.data_parallel
        return [(bs, bs // denom)
                for bs in range(self.start_batch_size,
                                self.global_batch_size + 1,
                                self.batch_size_increment)]


def build_calculator(global_batch_size: int, micro_batch_size: int,
                     data_parallel: int,
                     rampup: Optional[Tuple[int, int, int]] = None):
    """rampup = (start, increment, samples) or None (reference
    --rampup-batch-size triplet)."""
    if rampup is None:
        return ConstantCalculator(global_batch_size, micro_batch_size,
                                  data_parallel)
    start, inc, samples = rampup
    return RampupCalculator(start, inc, samples, global_batch_size,
                            micro_batch_size, data_parallel)
