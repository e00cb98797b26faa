"""Indexed binary dataset (.bin/.idx): the port's copy of the JAX
package's data/indexed_dataset.py, Megatron's on-disk layout byte for byte.

.idx layout (little-endian):
  9s  magic  b"MMIDIDX\\x00\\x00"
  Q   version (1)
  B   dtype code (1=u8 2=i8 3=i16 4=i32 5=i64 6=f64 7=f32 8=u16)
  Q   sequence_count
  Q   document_count
  i32[sequence_count]  sequence lengths (tokens)
  i64[sequence_count]  sequence byte pointers into .bin
  i64[document_count]  sequence indices marking document ends
.bin: raw token arrays back to back.

Reads are zero-copy via np.memmap, so a Megatron-preprocessed corpus, or
one the JAX package wrote, drops in unchanged.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Type

import numpy as np

_INDEX_HEADER = b"MMIDIDX\x00\x00"
_DTYPE_CODES = {
    np.uint8: 1, np.int8: 2, np.int16: 3, np.int32: 4, np.int64: 5,
    np.float64: 6, np.float32: 7, np.uint16: 8,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def best_dtype(vocab_size: int):
    """Smallest integer dtype holding token ids (reference
    DType.optimal_dtype)."""
    return np.uint16 if vocab_size < 65500 else np.int32


class IndexedDatasetWriter:
    """Streaming writer: add_document(tokens) per doc, finalize() at end."""

    def __init__(self, path_prefix: str, dtype: Type[np.number] = np.int32):
        self.path_prefix = path_prefix
        self.dtype = np.dtype(dtype).type
        if self.dtype not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {dtype}")
        self._bin = open(path_prefix + ".bin", "wb")
        self._lengths: List[int] = []
        self._doc_indices: List[int] = [0]

    def add_document(self, tokens: np.ndarray,
                     sequence_lengths: Optional[List[int]] = None):
        """Append one document. By default the document is one sequence;
        pass sequence_lengths to split it (sentence-level datasets)."""
        tokens = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(tokens.tobytes(order="C"))
        if sequence_lengths is None:
            self._lengths.append(len(tokens))
        else:
            assert sum(sequence_lengths) == len(tokens)
            self._lengths.extend(sequence_lengths)
        self._doc_indices.append(len(self._lengths))

    def finalize(self):
        self._bin.close()
        itemsize = np.dtype(self.dtype).itemsize
        pointers = np.zeros(len(self._lengths), dtype=np.int64)
        if len(self._lengths) > 1:
            np.cumsum(np.asarray(self._lengths[:-1], dtype=np.int64)
                      * itemsize, out=pointers[1:])
        with open(self.path_prefix + ".idx", "wb") as f:
            f.write(_INDEX_HEADER)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", _DTYPE_CODES[self.dtype]))
            f.write(struct.pack("<Q", len(self._lengths)))
            f.write(struct.pack("<Q", len(self._doc_indices)))
            f.write(np.asarray(self._lengths, dtype=np.int32)
                    .tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(np.asarray(self._doc_indices, dtype=np.int64)
                    .tobytes(order="C"))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            # Don't leave a valid-looking .idx behind a mid-stream failure.
            self._bin.close()
            for suffix in (".bin", ".idx"):
                try:
                    os.unlink(self.path_prefix + suffix)
                except OSError:
                    pass
            return False
        self.finalize()


class IndexedDataset:
    """mmap reader. ds[i] → np array of sequence i; ds.document_indices
    gives doc boundaries (reference IndexedDataset API)."""

    def __init__(self, path_prefix: str):
        self.path_prefix = path_prefix
        idx_path = path_prefix + ".idx"
        bin_path = path_prefix + ".bin"
        if not (os.path.exists(idx_path) and os.path.exists(bin_path)):
            raise FileNotFoundError(f"missing {idx_path} or {bin_path}")
        with open(idx_path, "rb") as f:
            header = f.read(9)
            if header != _INDEX_HEADER:
                raise ValueError(f"bad index header in {idx_path}")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"unsupported index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = _CODE_DTYPES[code]
            (seq_count,) = struct.unpack("<Q", f.read(8))
            (doc_count,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        idx_buf = np.memmap(idx_path, mode="r", order="C")
        o = offset
        self.sequence_lengths = np.frombuffer(
            idx_buf, dtype=np.int32, count=seq_count, offset=o)
        o += seq_count * 4
        self.sequence_pointers = np.frombuffer(
            idx_buf, dtype=np.int64, count=seq_count, offset=o)
        o += seq_count * 8
        self.document_indices = np.frombuffer(
            idx_buf, dtype=np.int64, count=doc_count, offset=o)
        self._bin = np.memmap(bin_path, mode="r", order="C")
        self._itemsize = np.dtype(self.dtype).itemsize

    def __len__(self) -> int:
        return len(self.sequence_lengths)

    def __getitem__(self, idx: int) -> np.ndarray:
        ptr = self.sequence_pointers[idx]
        length = self.sequence_lengths[idx]
        return np.frombuffer(self._bin, dtype=self.dtype, count=length,
                             offset=ptr)

    def get(self, idx: int, offset: int = 0,
            length: Optional[int] = None) -> np.ndarray:
        """Partial sequence read (reference IndexedDataset.get)."""
        seq_len = int(self.sequence_lengths[idx])
        if not 0 <= offset <= seq_len:
            raise IndexError(
                f"offset {offset} out of range for sequence {idx} "
                f"(length {seq_len})")
        ptr = self.sequence_pointers[idx] + offset * self._itemsize
        max_len = seq_len - offset
        length = max_len if length is None else min(length, max_len)
        # np.frombuffer treats ANY negative count as "read to the end" —
        # never let one through.
        length = max(int(length), 0)
        return np.frombuffer(self._bin, dtype=self.dtype, count=length,
                             offset=int(ptr))

    @property
    def num_tokens(self) -> int:
        return int(self.sequence_lengths.sum())
