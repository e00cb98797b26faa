"""GPT batch assembly (the JAX package's data/gpt_dataset.py:gpt_batches;
the indexed, blended and shuffled datasets come later)."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def gpt_batches(dataset, batch_size: int, start_idx: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches with the pretrain_gpt get_batch fields (tokens, labels,
    loss_mask, position_ids) from a dataset of seq_length + 1 tokens per
    sample."""
    idx = start_idx
    seq_length = dataset.seq_length
    while True:
        samples = np.stack([dataset[(idx + i) % len(dataset)]
                            for i in range(batch_size)])
        idx += batch_size
        tokens = samples[:, :-1].astype(np.int32)
        labels = samples[:, 1:].astype(np.int32)
        yield {
            "tokens": tokens,
            "labels": labels,
            "loss_mask": np.ones_like(tokens, dtype=np.float32),
            "position_ids": np.tile(
                np.arange(seq_length, dtype=np.int32),
                (batch_size, 1)),
        }
