"""Weighted blend of several datasets (the JAX package's data/blended.py,
Megatron's BlendedDataset): samples are drawn from the constituents in
proportion to their weights through the deficit-tracking index of the
native helpers (build_blending_indices), deterministic across runs.
weights=None is the exhaustive mode (build_exhaustive_blending_indices):
every constituent is consumed exactly once, interleaved in proportion to
its size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from megatronapp_tpu_torch.data.helpers import (
    build_blending_indices, build_exhaustive_blending_indices,
)


class BlendedDataset:
    def __init__(self, datasets: Sequence,
                 weights: Optional[Sequence[float]],
                 num_samples: Optional[int] = None):
        if weights is None:
            # Exhaustive: draw exactly len(d) samples from each d.
            self.datasets = list(datasets)
            sizes = np.asarray([len(d) for d in datasets], np.int64)
            self.dataset_index, self.dataset_sample_index = \
                build_exhaustive_blending_indices(sizes)
            self.num_samples = int(sizes.sum())
            if num_samples is not None and num_samples != self.num_samples:
                raise ValueError(
                    f"exhaustive blend yields {self.num_samples} samples; "
                    f"num_samples={num_samples} conflicts")
            return
        if len(datasets) != len(weights):
            raise ValueError("datasets and weights length mismatch")
        if num_samples is None:
            raise ValueError("num_samples required with explicit weights")
        self.datasets = list(datasets)
        self.num_samples = num_samples
        self.dataset_index, self.dataset_sample_index = \
            build_blending_indices(np.asarray(weights, dtype=np.float64),
                                   num_samples)
        # Validate each constituent can supply its weighted share
        # (reference BlendedDataset size check).
        counts = np.bincount(self.dataset_index, minlength=len(datasets))
        for d, need in enumerate(counts):
            if need > len(self.datasets[d]):
                raise ValueError(
                    f"dataset {d} supplies {need} samples under these "
                    f"weights but only has {len(self.datasets[d])}; reduce "
                    f"num_samples or its weight")

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        d = self.dataset_index[idx]
        s = self.dataset_sample_index[idx]
        return self.datasets[d][int(s)]

    @property
    def seq_length(self):
        return self.datasets[0].seq_length
