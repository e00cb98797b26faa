"""ctypes bindings for the C++ dataset index builders, with numpy
fallbacks (the port's copy of the JAX package's data/helpers.py).

The library builds from the port's own ``data/native/helpers.cpp`` with
``g++ -O3 -shared -fPIC`` at first use into
``build/native/libdata_helpers-<hash>.so``, where the hash covers the
source and the flags: an edited source builds anew, an unchanged one is
reused. It is written under a temporary name and renamed into place, so
a concurrent reader never loads a half-written file. Where no compiler
exists (or the build fails) the builders run their numpy versions, which
give the same indices; the first such fallback warns once with the
compiler's error. ``native_available()`` says which path runs. These are
host code: the index builders run once per dataset, not per step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "data", "native", "helpers.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_LIB = None
_LOAD_ERROR: Optional[str] = None
_LOCK = threading.Lock()


def library_path() -> str:
    """build/native/libdata_helpers-<hash of source and flags>.so."""
    digest = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libdata_helpers-{digest.hexdigest()[:12]}.so")


def _build() -> str:
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exit {proc.returncode}: "
                               f"{proc.stderr.strip()}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.build_sample_idx.restype = ctypes.c_int64
    lib.build_sample_idx.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.build_blending_indices.restype = None
    lib.build_blending_indices.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int64,
    ]
    lib.build_mapping.restype = ctypes.c_int64
    lib.build_mapping.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_uint64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.build_exhaustive_blending_indices.restype = None
    lib.build_exhaustive_blending_indices.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
    ]
    lib.build_blocks_mapping.restype = ctypes.c_int64
    lib.build_blocks_mapping.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_uint64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    return lib


def _load_native() -> Optional[ctypes.CDLL]:
    """The built library, or None (after one warning naming the
    compiler's error) when it cannot be built or loaded."""
    global _LIB, _LOAD_ERROR
    with _LOCK:
        if _LIB is not None or _LOAD_ERROR is not None:
            return _LIB
        try:
            _LIB = _bind(ctypes.CDLL(_build()))
        except Exception as e:  # noqa: BLE001 — the numpy path takes over
            _LOAD_ERROR = f"{type(e).__name__}: {e}"
            warnings.warn(
                "data helpers: the native index builders are unavailable "
                f"({_LOAD_ERROR}); using the numpy versions (same indices, "
                "slower)", RuntimeWarning, stacklevel=3)
        return _LIB


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray,
                     seq_length: int, num_samples: int) -> np.ndarray:
    """[num_samples+1, 2] (doc_pos, offset) pairs; sample i spans tokens
    from sample_idx[i] to sample_idx[i+1] (+1 label token overlap)."""
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, dtype=np.int64)
    lib = _load_native()
    if lib is not None:
        out = np.zeros((num_samples + 1, 2), dtype=np.int64)
        rc = lib.build_sample_idx(
            _ptr(sizes, ctypes.c_int32), _ptr(doc_idx, ctypes.c_int64),
            len(doc_idx), seq_length, num_samples,
            _ptr(out, ctypes.c_int64))
        if rc != 0:
            raise ValueError(
                "document stream exhausted before num_samples; add epochs")
        return out
    return _build_sample_idx_np(sizes, doc_idx, seq_length, num_samples)


def _build_sample_idx_np(sizes, doc_idx, seq_length, num_samples):
    out = np.zeros((num_samples + 1, 2), dtype=np.int64)
    doc_pos, doc_offset = 0, 0
    for i in range(1, num_samples + 1):
        remaining = seq_length
        while remaining > 0:
            if doc_pos >= len(doc_idx):
                raise ValueError(
                    "document stream exhausted before num_samples; "
                    "add epochs")
            doc_len = sizes[doc_idx[doc_pos]] - doc_offset
            if doc_len > remaining:
                doc_offset += remaining
                remaining = 0
            else:
                remaining -= doc_len
                doc_offset = 0
                doc_pos += 1
        out[i] = (doc_pos, doc_offset)
    return out


def build_blending_indices(weights: np.ndarray, size: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(dataset_index[size] int16, dataset_sample_index[size] int64)."""
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    lib = _load_native()
    ds_idx = np.zeros(size, dtype=np.int16)
    ds_sample = np.zeros(size, dtype=np.int64)
    if lib is not None:
        lib.build_blending_indices(
            _ptr(ds_idx, ctypes.c_int16), _ptr(ds_sample, ctypes.c_int64),
            _ptr(weights, ctypes.c_double), len(weights), size)
        return ds_idx, ds_sample
    consumed = np.zeros(len(weights), dtype=np.int64)
    for i in range(size):
        err = weights * (i + 1) - consumed
        best = int(np.argmax(err))
        ds_idx[i] = best
        ds_sample[i] = consumed[best]
        consumed[best] += 1
    return ds_idx, ds_sample


def build_mapping(document_indices: np.ndarray,
                  sentence_lengths: np.ndarray, num_epochs: int,
                  max_num_samples: int, max_seq_length: int,
                  short_seq_prob: float, seed: int,
                  min_num_sent: int = 2) -> np.ndarray:
    """Sentence-span sample map (the masked-LM datasets') → int64 [N, 3]
    (first_sentence, end_sentence, target_seq_length), shuffled; native,
    or the numpy version on the same splitmix64 stream (the JAX package's
    data/masked_dataset.py:_build_mapping_np)."""
    docs = np.ascontiguousarray(document_indices, dtype=np.int64)
    sizes = np.ascontiguousarray(sentence_lengths, dtype=np.int32)
    lib = _load_native()
    if lib is None:
        return _build_mapping_np(docs, sizes, num_epochs, max_num_samples,
                                 max_seq_length, short_seq_prob, seed,
                                 min_num_sent)
    n_docs = len(docs) - 1
    args = (_ptr(docs, ctypes.c_int64), n_docs,
            _ptr(sizes, ctypes.c_int32), num_epochs, max_num_samples,
            max_seq_length, short_seq_prob, seed, min_num_sent)
    count = lib.build_mapping(*args, None, 0)
    if count < 0:
        raise ValueError("build_mapping: invalid arguments")
    out = np.zeros((count, 3), dtype=np.int64)
    filled = lib.build_mapping(*args, _ptr(out, ctypes.c_int64), count)
    if filled != count:
        raise RuntimeError(
            f"build_mapping pass disagreement: {count} vs {filled}")
    return out


_LONG_SENTENCE_LEN = 512
_U64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64_int(state: int) -> Tuple[int, int]:
    """(new_state, value): the C++ splitmix64 on Python ints."""
    state = (state + 0x9E3779B97F4A7C15) & _U64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return state, z ^ (z >> 31)


def _build_mapping_np(docs, sizes, num_epochs, max_num_samples,
                      max_seq_length, short_seq_prob, seed, min_num_sent):
    state = int(seed) & _U64

    def target_len(state):
        state, r = _splitmix64_int(state)
        if short_seq_prob > 0 and \
                (r >> 11) * (1.0 / 9007199254740992.0) < short_seq_prob:
            state, r2 = _splitmix64_int(state)
            return state, 2 + int(r2 % (max_seq_length - 1))
        return state, max_seq_length

    triples = []
    for _epoch in range(num_epochs):
        if max_num_samples > 0 and len(triples) >= max_num_samples:
            break
        for doc in range(len(docs) - 1):
            first, last = int(docs[doc]), int(docs[doc + 1])
            if last - first < min_num_sent:
                continue
            if np.any(sizes[first:last] > _LONG_SENTENCE_LEN):
                continue
            start, seq_len, num_sent = first, 0, 0
            state, tgt = target_len(state)
            for s in range(first, last):
                seq_len += int(sizes[s])
                num_sent += 1
                remain = last - s - 1
                if (seq_len >= tgt and remain > 1 and
                        num_sent >= min_num_sent) or remain == 0:
                    triples.append((start, s + 1, tgt))
                    start, seq_len, num_sent = s + 1, 0, 0
                    state, tgt = target_len(state)
    if max_num_samples > 0:
        triples = triples[:max_num_samples]
    out = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
    # Fisher-Yates on the seed + 1 stream, as the C++ does.
    sstate = (int(seed) + 1) & _U64
    for i in range(len(out) - 1, 0, -1):
        sstate, r = _splitmix64_int(sstate)
        j = int(r % (i + 1))
        out[[i, j]] = out[[j, i]]
    return out


def build_exhaustive_blending_indices(sizes: np.ndarray
                                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Blend datasets drawing EXACTLY sizes[d] samples from dataset d
    (reference build_exhaustive_blending_indices, helpers.cpp:21-74):
    largest-deficit-first with size-proportional weights, datasets drop
    out of contention once exhausted. Deterministic."""
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    ds_idx = np.zeros(total, dtype=np.int16)
    ds_sample = np.zeros(total, dtype=np.int64)
    lib = _load_native()
    if lib is not None:
        lib.build_exhaustive_blending_indices(
            _ptr(ds_idx, ctypes.c_int16), _ptr(ds_sample, ctypes.c_int64),
            _ptr(sizes, ctypes.c_int64), len(sizes))
        return ds_idx, ds_sample
    weights = sizes / total if total else sizes.astype(np.float64)
    consumed = np.zeros(len(sizes), dtype=np.int64)
    spent = sizes == 0
    for i in range(total):
        err = weights * max(float(i), 1.0) - consumed
        err[spent] = -np.inf
        best = int(np.argmax(err))
        ds_idx[i] = best
        ds_sample[i] = consumed[best]
        consumed[best] += 1
        if consumed[best] >= sizes[best]:
            spent[best] = True
    return ds_idx, ds_sample


def build_blocks_mapping(document_indices: np.ndarray,
                         sentence_lengths: np.ndarray,
                         title_lengths: np.ndarray,
                         num_epochs: int, max_num_samples: int,
                         max_seq_length: int, seed: int,
                         use_one_sent_blocks: bool = False) -> np.ndarray:
    """Block sample map for ICT/REALM retrieval pretraining → int64 [N,4]
    (first_sentence, end_sentence, doc, block_id). Reference semantics:
    build_blocks_mapping_impl (helpers.cpp:564-804); per-doc target length
    is max_seq_length - title_len so the title can be prepended. Native
    path with bit-identical numpy fallback (shared shuffle stream)."""
    docs = np.ascontiguousarray(document_indices, dtype=np.int64)
    sizes = np.ascontiguousarray(sentence_lengths, dtype=np.int32)
    titles = np.ascontiguousarray(title_lengths, dtype=np.int32)
    n_docs = len(docs) - 1
    if len(titles) < n_docs:
        raise ValueError(
            f"title_lengths has {len(titles)} entries but the block "
            f"dataset has {n_docs} documents — wrong titles companion?")
    min_num_sent = 1 if use_one_sent_blocks else 2
    lib = _load_native()
    if lib is not None:
        args = (_ptr(docs, ctypes.c_int64), n_docs,
                _ptr(sizes, ctypes.c_int32), _ptr(titles, ctypes.c_int32),
                num_epochs, max_num_samples, max_seq_length, seed,
                min_num_sent)
        count = lib.build_blocks_mapping(*args, None, 0)
        if count < 0:
            raise ValueError("build_blocks_mapping: invalid arguments")
        out = np.zeros((count, 4), dtype=np.int64)
        filled = lib.build_blocks_mapping(
            *args, _ptr(out, ctypes.c_int64), count)
        if filled != count:
            raise RuntimeError(
                f"build_blocks_mapping pass disagreement: {count} vs "
                f"{filled}")
        return out
    # numpy fallback — same traversal, same shuffle stream.
    rows = []
    long_sent = 512  # kLongSentenceLen
    for epoch in range(num_epochs):
        if max_num_samples > 0 and len(rows) >= max_num_samples:
            break
        block_id = 0
        for doc in range(n_docs):
            first, last = int(docs[doc]), int(docs[doc + 1])
            remain = last - first
            if remain < min_num_sent:
                continue
            if np.any(sizes[first:last] > long_sent):
                continue
            tgt = max_seq_length - int(titles[doc])
            start, seq_len, num_sent = first, 0, 0
            for s in range(first, last):
                seq_len += int(sizes[s])
                num_sent += 1
                remain -= 1
                if ((seq_len >= tgt and remain >= min_num_sent and
                     num_sent >= min_num_sent) or remain == 0):
                    rows.append((start, s + 1, doc, block_id))
                    block_id += 1
                    start = s + 1
                    seq_len, num_sent = 0, 0
    if max_num_samples > 0:
        rows = rows[:max_num_samples]
    out = np.asarray(rows, dtype=np.int64).reshape(-1, 4)
    state = (int(seed) + 1) & _U64
    for i in range(len(out) - 1, 0, -1):
        state, r = _splitmix64_int(state)
        j = r % (i + 1)
        out[[i, j]] = out[[j, i]]
    return out


def native_available() -> bool:
    return _load_native() is not None
