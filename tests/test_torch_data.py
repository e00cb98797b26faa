"""The port's indexed data against the JAX package's, on the CPU.

- IndexedDatasetWriter: the same documents give byte-identical .bin/.idx
  files on both sides (one sequence a document, and documents split into
  sentences), and each side's reader reads the other's files.
- The five index builders (sample index, weighted and exhaustive blending
  indices, the sentence-span map, the ICT block map): the port's native
  library (built from its own helpers.cpp into build/native/) and its
  numpy versions both equal JAX's builders exactly.
- GPTDataset: doc_idx, sample_idx and shuffle_idx equal JAX's for a seed
  (values and dtypes, shuffled and not, several epochs, a document
  subset), and the gpt_batches stream from a start index is JAX's byte for
  byte; BlendedDataset (weighted and exhaustive) likewise.
- The library is keyed on the source's hash; a source that does not
  compile warns once with the compiler's error and the numpy versions
  take over.
"""

import os
import warnings

import numpy as np
import pytest

from megatronapp_tpu.data import blended as jblended
from megatronapp_tpu.data import gpt_dataset as jgpt
from megatronapp_tpu.data import helpers as jhelpers
from megatronapp_tpu.data import indexed_dataset as jidx
from megatronapp_tpu.data.masked_dataset import (
    build_sentence_sample_mapping,
)
from megatronapp_tpu_torch.data import blended as tblended
from megatronapp_tpu_torch.data import gpt_dataset as tgpt
from megatronapp_tpu_torch.data import helpers as thelpers
from megatronapp_tpu_torch.data import indexed_dataset as tidx


def _docs(seed, n=40, vocab=1000, lo=3, hi=90):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(lo, hi)) for _ in range(n)]


def _write(mod, prefix, docs, dtype, split=False):
    with mod.IndexedDatasetWriter(prefix, dtype) as w:
        for d in docs:
            if split and len(d) > 6:
                cut = len(d) // 3
                w.add_document(d, sequence_lengths=[cut, len(d) - cut])
            else:
                w.add_document(d)


@pytest.fixture
def numpy_path(monkeypatch):
    """The port's builders on their numpy versions."""
    monkeypatch.setattr(thelpers, "_load_native", lambda: None)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
@pytest.mark.parametrize("split", [False, True])
def test_writer_bytes_equal_jax_and_each_reads_the_other(tmp_path, dtype,
                                                         split):
    docs = _docs(1)
    _write(jidx, str(tmp_path / "j"), docs, dtype, split)
    _write(tidx, str(tmp_path / "t"), docs, dtype, split)
    for suffix in (".bin", ".idx"):
        assert (tmp_path / f"j{suffix}").read_bytes() == \
            (tmp_path / f"t{suffix}").read_bytes(), suffix
    for reader, prefix in ((tidx.IndexedDataset, "j"),
                           (jidx.IndexedDataset, "t")):
        ds = reader(str(tmp_path / prefix))
        other = (jidx if reader is tidx.IndexedDataset
                 else tidx).IndexedDataset(str(tmp_path / prefix))
        assert len(ds) == len(other) and ds.dtype == other.dtype
        np.testing.assert_array_equal(ds.document_indices,
                                      other.document_indices)
        for i in range(len(ds)):
            np.testing.assert_array_equal(ds[i], other[i])
            np.testing.assert_array_equal(ds.get(i, 1, 4),
                                          other.get(i, 1, 4))
        assert ds.num_tokens == sum(len(d) for d in docs)


def test_best_dtype_is_jax():
    for v in (1000, 50257, 65499, 65500, 128256):
        assert tidx.best_dtype(v) == jidx.best_dtype(v)


def _sizes_docidx(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 60, 30).astype(np.int32)
    doc_idx = np.concatenate([rng.permutation(30) for _ in range(3)])
    return sizes, doc_idx.astype(np.int64)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_sample_and_blending_builders_equal_jax(path, request):
    if path == "numpy":
        request.getfixturevalue("numpy_path")
    else:
        assert thelpers.native_available()
    sizes, doc_idx = _sizes_docidx(2)
    for seq, n in ((16, 100), (33, 60), (7, 300)):
        np.testing.assert_array_equal(
            thelpers.build_sample_idx(sizes, doc_idx, seq, n),
            jhelpers.build_sample_idx(sizes, doc_idx, seq, n))
    for w in ([0.5, 0.3, 0.2], [1.0, 3.0], [0.1] * 7):
        for a, b in zip(thelpers.build_blending_indices(np.asarray(w), 500),
                        jhelpers.build_blending_indices(np.asarray(w), 500)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for sz in ([5, 9, 0, 3], [40, 1], [7]):
        for a, b in zip(
                thelpers.build_exhaustive_blending_indices(np.asarray(sz)),
                jhelpers.build_exhaustive_blending_indices(np.asarray(sz))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _sentences(seed):
    rng = np.random.default_rng(seed)
    per_doc = rng.integers(1, 9, 25)
    docs = np.concatenate([[0], np.cumsum(per_doc)]).astype(np.int64)
    sizes = rng.integers(2, 40, int(per_doc.sum())).astype(np.int32)
    sizes[5] = 600          # a document with a long sentence is skipped
    titles = rng.integers(1, 6, 25).astype(np.int32)
    return docs, sizes, titles


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_mapping_builders_equal_jax(path, request):
    if path == "numpy":
        request.getfixturevalue("numpy_path")
    docs, sizes, titles = _sentences(3)
    for args in ((2, 0, 64, 0.1, 7, 2), (3, 50, 32, 0.0, 11, 1),
                 (1, 0, 128, 0.5, 5, 2)):
        np.testing.assert_array_equal(
            thelpers.build_mapping(docs, sizes, *args),
            build_sentence_sample_mapping(docs, sizes, *args))
    for args in ((2, 0, 64, 7, False), (1, 10, 32, 3, True)):
        np.testing.assert_array_equal(
            thelpers.build_blocks_mapping(docs, sizes, titles, *args),
            jhelpers.build_blocks_mapping(docs, sizes, titles, *args))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("corpus") / "c")
    _write(tidx, prefix, _docs(4, n=60, vocab=500, lo=5, hi=120),
           np.uint16)
    return prefix


@pytest.mark.parametrize("kw", [
    dict(seq_length=16, num_samples=50, seed=1234),
    dict(seq_length=40, num_samples=400, seed=7),          # several epochs
    dict(seq_length=8, num_samples=30, seed=3, shuffle=False),
    dict(seq_length=12, num_samples=64, seed=9,
         documents=np.arange(10, 40, dtype=np.int64)),
])
def test_gpt_dataset_indices_equal_jax(corpus, kw):
    j = jgpt.GPTDataset(jidx.IndexedDataset(corpus), **kw)
    t = tgpt.GPTDataset(tidx.IndexedDataset(corpus), **kw)
    for name in ("doc_idx", "sample_idx", "shuffle_idx"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for i in range(0, len(t), 7):
        np.testing.assert_array_equal(t[i], j[i])


@pytest.mark.parametrize("start", [0, 13])
def test_gpt_batches_stream_equals_jax(corpus, start):
    j = jgpt.GPTDataset(jidx.IndexedDataset(corpus), 16, 60, seed=5)
    t = tgpt.GPTDataset(tidx.IndexedDataset(corpus), 16, 60, seed=5)
    jit = jgpt.gpt_batches(j, 6, start_idx=start)
    tit = tgpt.gpt_batches(t, 6, start_idx=start)
    for _ in range(12):          # past the end: the stream wraps
        a, b = next(tit), next(jit)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("weights", [[0.6, 0.4], None])
def test_blended_dataset_equals_jax(corpus, weights):
    def parts(g, i):
        return [g.GPTDataset(i.IndexedDataset(corpus), 16, n, seed=s)
                for n, s in ((40, 1), (25, 2))]
    n = 50 if weights else None
    j = jblended.BlendedDataset(parts(jgpt, jidx), weights, n)
    t = tblended.BlendedDataset(parts(tgpt, tidx), weights, n)
    assert len(t) == len(j)
    np.testing.assert_array_equal(t.dataset_index, j.dataset_index)
    np.testing.assert_array_equal(t.dataset_sample_index,
                                  j.dataset_sample_index)
    for i in range(len(t)):
        np.testing.assert_array_equal(t[i], j[i])
    assert t.seq_length == 16


def test_blended_dataset_refuses_what_jax_refuses(corpus):
    d = [tgpt.GPTDataset(tidx.IndexedDataset(corpus), 16, 5, seed=1)]
    with pytest.raises(ValueError, match="only has 5"):
        tblended.BlendedDataset(d + d, [0.9, 0.1], 40)
    with pytest.raises(ValueError, match="num_samples required"):
        tblended.BlendedDataset(d, [1.0])


def test_library_is_the_ports_own_and_keyed_on_its_source():
    assert thelpers.native_available()
    path = thelpers.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.startswith(os.path.join(repo, "build", "native",
                                        "libdata_helpers-"))
    assert os.path.exists(path)
    assert thelpers.SOURCE == os.path.join(
        repo, "megatronapp_tpu_torch", "data", "native", "helpers.cpp")
    with open(thelpers.SOURCE) as f:
        ours = f.read()
    with open(os.path.join(repo, "megatronapp_tpu", "data", "native",
                           "helpers.cpp")) as f:
        theirs = f.read()
    # A copy: the same code below each file's header comment.
    assert ours[ours.index("#include"):] == theirs[theirs.index("#include"):]


def test_a_source_that_does_not_compile_warns_once(tmp_path, monkeypatch):
    bad = tmp_path / "helpers.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(thelpers, "SOURCE", str(bad))
    monkeypatch.setattr(thelpers, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(thelpers, "_LIB", None)
    monkeypatch.setattr(thelpers, "_LOAD_ERROR", None)
    with pytest.warns(RuntimeWarning, match="numpy versions") as rec:
        assert not thelpers.native_available()
    assert "g++ exit" in str(rec[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not thelpers.native_available()
        sizes, doc_idx = _sizes_docidx(4)
        np.testing.assert_array_equal(
            thelpers.build_sample_idx(sizes, doc_idx, 10, 20),
            jhelpers.build_sample_idx(sizes, doc_idx, 10, 20))
    assert not list((tmp_path / "out").glob("*.tmp"))
