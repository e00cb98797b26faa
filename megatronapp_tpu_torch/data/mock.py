"""Mock GPT dataset (the JAX package's data/mock.py): deterministic
pseudo-random token sequences keyed by (seed, index), numpy only, so the
same seed and start index give the same batches byte for byte."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from megatronapp_tpu_torch.data.gpt_dataset import gpt_batches


class MockGPTDataset:
    def __init__(self, seq_length: int, vocab_size: int, seed: int = 0,
                 size: int = 10**9):
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self.seed = seed
        self.size = size

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, idx))
        return rng.integers(0, self.vocab_size,
                            size=self.seq_length + 1).astype(np.int32)


def mock_batches(seq_length: int, vocab_size: int, batch_size: int,
                 seed: int = 0, start_idx: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of global batches from the mock dataset."""
    return gpt_batches(MockGPTDataset(seq_length, vocab_size, seed),
                       batch_size, start_idx=start_idx)
