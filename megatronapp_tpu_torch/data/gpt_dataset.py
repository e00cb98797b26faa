"""GPT training dataset over an indexed corpus, and batch assembly (the
JAX package's data/gpt_dataset.py: GPTDataset and gpt_batches)."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from megatronapp_tpu_torch.data.helpers import build_sample_idx
from megatronapp_tpu_torch.data.indexed_dataset import IndexedDataset


class GPTDataset:
    """Epoch-aware shuffled sampling over an IndexedDataset (Megatron's
    GPTDataset): documents are concatenated in a shuffled order and cut
    into seq_length-token samples (label = next token, overlapping by
    one), with a second shuffle over samples. The three indices are the
    JAX package's for the same seed: the same ``np.random.default_rng``
    draws in the same order (each epoch's shuffle, then the sample
    shuffle) and the same int64 dtypes."""

    def __init__(self, indexed: IndexedDataset, seq_length: int,
                 num_samples: int, seed: int = 1234,
                 documents: Optional[np.ndarray] = None,
                 shuffle: bool = True):
        """documents: subset of document ids to draw from (split support —
        reference passes per-split document ranges)."""
        self.indexed = indexed
        self.seq_length = seq_length
        self.num_samples = num_samples
        self.seed = seed

        if documents is None:
            documents = np.arange(len(indexed.document_indices) - 1,
                                  dtype=np.int64)
        # Sequences belonging to the chosen documents.
        seq_ids = np.concatenate([
            np.arange(indexed.document_indices[d],
                      indexed.document_indices[d + 1], dtype=np.int64)
            for d in documents]) if len(documents) else np.zeros(
                0, dtype=np.int64)
        sizes = indexed.sequence_lengths

        tokens_per_epoch = int(sizes[seq_ids].sum())
        if tokens_per_epoch == 0:
            raise ValueError("empty document selection")
        # The sample stream needs num_samples*seq_length + 1 tokens (each
        # sample spans seq_length+1 tokens, overlapping the next by one) —
        # reference _get_num_epochs semantics.
        tokens_needed = num_samples * seq_length + 1
        num_epochs = int(np.ceil(tokens_needed / tokens_per_epoch))

        rng = np.random.default_rng(seed)
        # Epoch-expanded shuffled document-stream (reference
        # _build_document_index: each epoch is an independent shuffle).
        chunks = []
        for _ in range(num_epochs):
            order = seq_ids.copy()
            if shuffle:
                rng.shuffle(order)
            chunks.append(order)
        self.doc_idx = np.concatenate(chunks)

        self.sample_idx = build_sample_idx(
            sizes, self.doc_idx, seq_length, num_samples)

        self.shuffle_idx = np.arange(num_samples, dtype=np.int64)
        if shuffle:
            rng.shuffle(self.shuffle_idx)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> np.ndarray:
        """seq_length+1 tokens (inputs + final label token)."""
        idx = self.shuffle_idx[idx % self.num_samples]
        doc_pos0, offset0 = self.sample_idx[idx]
        parts = []
        need = self.seq_length + 1
        pos, off = int(doc_pos0), int(offset0)
        while need > 0 and pos < len(self.doc_idx):
            seq_id = int(self.doc_idx[pos])
            chunk = self.indexed.get(seq_id, offset=off, length=need)
            parts.append(chunk)
            need -= len(chunk)
            pos += 1
            off = 0
        out = np.concatenate(parts).astype(np.int64)
        # The epoch provisioning above guarantees full coverage; a short
        # read here would be a bug, not a tail condition.
        assert len(out) == self.seq_length + 1, (len(out), self.seq_length)
        return out



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
