"""The port's paged attention (plain version and page-write helpers)
against the JAX package: the Pallas kernel ``kernel_gen.paged_attention``
(interpret mode on the CPU) and its jnp references, in decode and ragged
modes, fp32, atol 1e-5 (the two sides sum in different orders; fp32
epsilon times the few-hundred-term sums stays well below it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.ops.pallas import kernel_gen
from megatronapp_tpu.ops.pallas import paged_attention as jpa
from megatronapp_tpu_torch.ops import paged_attention as tpa
from megatronapp_tpu_torch.ops.cuda import paged_attention as cuda_pa

ATOL = 1e-5
NEG_INF_T = cuda_pa.NEG_INF


def _case(seed, b, hq, hkv, d, bs, mb, lens, s_q=None):
    rng = np.random.default_rng(seed)
    nb = b * mb + 2
    q_shape = (b, hq, d) if s_q is None else (b, s_q, hq, d)
    return {
        "q": rng.normal(size=q_shape).astype(np.float32),
        "k": rng.normal(size=(nb, bs, hkv, d)).astype(np.float32),
        "v": rng.normal(size=(nb, bs, hkv, d)).astype(np.float32),
        "table": rng.permutation(nb)[:b * mb].reshape(b, mb).astype(
            np.int32),
        "lens": np.asarray(lens, np.int32),
    }


def _port(c, q_lens=None):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    out = cuda_pa.paged_attention(
        t["q"], t["k"], t["v"], t["table"], t["lens"],
        q_lens=None if q_lens is None else torch.from_numpy(q_lens))
    return out.numpy()


def _jax(c, fn, q_lens=None):
    args = [jnp.asarray(c[k]) for k in ("q", "k", "v", "table", "lens")]
    if q_lens is not None:
        args.append(jnp.asarray(q_lens))
    return np.asarray(fn(*args))


DECODE_SHAPES = [(4, 2, 16, 4), (8, 8, 8, 8), (6, 2, 32, 16), (4, 1, 8, 4)]


@pytest.mark.parametrize("hq,hkv,d,bs", DECODE_SHAPES)
def test_decode_matches_jax_kernel_and_reference(hq, hkv, d, bs):
    """GQA and MHA groupings; lengths 1, bs+1 (not a multiple of bs) and
    the full table."""
    mb = 4
    c = _case(hq * 100 + bs, 3, hq, hkv, d, bs, mb, [1, bs + 1, mb * bs])
    got = _port(c)
    assert got.shape == c["q"].shape
    np.testing.assert_allclose(got, _jax(c, kernel_gen.paged_attention),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, _jax(c, jpa.paged_attention_reference),
                               atol=ATOL, rtol=ATOL)


RAGGED_SHAPES = [(4, 2, 16, 4, 8), (8, 8, 8, 8, 5), (4, 1, 16, 4, 6)]


@pytest.mark.parametrize("hq,hkv,d,bs,s_q", RAGGED_SHAPES)
def test_ragged_matches_jax_kernel_and_reference(hq, hkv, d, bs, s_q):
    """Ragged multi-query rows, padding rows included: a padding row
    (s >= q_len) sits past the causal tail and attends every valid
    position on both sides, finite."""
    mb = 5
    lens = [3, bs + 2, mb * bs]
    q_lens = np.asarray([1, min(s_q, bs + 2), s_q - 1], np.int32)
    c = _case(hq * 10 + s_q, 3, hq, hkv, d, bs, mb, lens, s_q=s_q)
    got = _port(c, q_lens)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, _jax(c, lambda q, k, v, t, n, ql: kernel_gen.paged_attention(
            q, k, v, t, n, q_lens=ql), q_lens),
        atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        got, _jax(c, jpa.paged_attention_multiquery_reference, q_lens),
        atol=ATOL, rtol=ATOL)


def test_ragged_q_len_one_equals_decode():
    """A ragged row with q_len 1 is the decode row."""
    c = _case(3, 3, 4, 2, 16, 4, 4, [2, 7, 16])
    dec = _port(c)
    rag = dict(c, q=c["q"][:, None])
    out = _port(rag, np.ones(3, np.int32))[:, 0]
    np.testing.assert_allclose(out, dec, atol=ATOL, rtol=ATOL)


def test_dispatchers_match_plain_version():
    """paged_attention_decode / _multiquery and the references route to
    the same function on CPU tensors."""
    c = _case(9, 2, 4, 2, 16, 4, 3, [5, 11])
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    args = (t["q"], t["k"], t["v"], t["table"], t["lens"])
    ref = tpa.paged_attention_reference(*args)
    torch.testing.assert_close(tpa.paged_attention_decode(*args), ref)
    q4 = t["q"][:, None]
    ql = torch.ones(2, dtype=torch.int32)
    mq = tpa.paged_attention_multiquery(q4, *args[1:], ql)
    torch.testing.assert_close(mq[:, 0], ref)
    torch.testing.assert_close(
        tpa.paged_attention_multiquery_reference(q4, *args[1:], ql), mq)


def test_plain_version_counts_no_launch():
    before = dict(cuda_pa.launches)
    c = _case(1, 2, 4, 2, 16, 4, 3, [5, 11])
    _port(c)
    assert cuda_pa.launches == before


# ---------------------------------------------------------------------------
# the bf16-pool kernel's split KV: its partials and their merge, in plain
# PyTorch (the kernel runs only on the card), against the Pallas kernel
# ---------------------------------------------------------------------------

def _split_merged(c, splits, q_lens=None):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    acc, m, l = cuda_pa.split_partials_plain(
        t["q"], t["k"], t["v"], t["table"], t["lens"],
        None if q_lens is None else torch.from_numpy(q_lens), splits)
    out = cuda_pa.merge_split_partials(acc, m, l)
    return (out[:, 0] if q_lens is None else out).numpy(), l.numpy()


# name: (bs, mb, kv lens, splits); capacities of 448-1024 positions: 7-16
# kv tiles of 64 rows, dealt to the splits in turn.
SPLIT_DECODE_CASES = {
    "one_split": (16, 28, [1, 200, 448], 1),
    "two_splits": (16, 28, [64, 65, 448], 2),
    "seven_splits_bs64": (64, 7, [1, 130, 448], 7),
    "splits_past_kv_len": (16, 64, [70, 5, 129], 7),
    "kv_len_under_one_tile": (64, 8, [5, 63, 1], 4),
}


@pytest.mark.parametrize("name", sorted(SPLIT_DECODE_CASES))
def test_split_merge_decode_matches_jax_kernel(name):
    """Decode rows: the kernel's split partials merged in split order equal
    the Pallas kernel, whatever the split count, with splits wholly past a
    slot's kv_len (zero weight, l = 0) and kv_len under one kv tile."""
    bs, mb, lens, splits = SPLIT_DECODE_CASES[name]
    c = _case(splits * 10 + bs, 3, 4, 2, 16, bs, mb, lens)
    got, l = _split_merged(c, splits)
    for b, n in enumerate(lens):   # splits past kv_len carry no weight
        assert (l[b, 0, :, -(-n // cuda_pa.KV_TILE):] == 0).all()
    np.testing.assert_allclose(got, _jax(c, kernel_gen.paged_attention),
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("bs,splits", [(16, 2), (16, 7), (64, 7)])
def test_split_merge_ragged_matches_jax_kernel(bs, splits):
    """Ragged chunks: padding rows (finite, attending all kv_len
    positions) and rows whose causal limit ends before the later splits
    (l = 0 there) merge to the Pallas kernel's rows."""
    mb = 448 // bs
    s_q = 6
    lens = [448, 100, 7]
    q_lens = np.asarray([6, 3, 4], np.int32)
    c = _case(bs + splits, 3, 4, 2, 16, bs, mb, lens, s_q=s_q)
    got, l = _split_merged(c, splits, q_lens)
    assert np.isfinite(got).all()
    # Slot 1's row 0 sees positions [0, 98), kv tiles 0 and 1: the later
    # splits give it no weight, while slot 1's last row has weight in
    # every split that holds one of its tiles 0-1.
    assert (l[1, 0, :, 2:] == 0).all()
    assert (l[1, 2, :, :2] > 0).all()
    np.testing.assert_allclose(
        got, _jax(c, lambda q, k, v, t, n, ql: kernel_gen.paged_attention(
            q, k, v, t, n, q_lens=ql), q_lens),
        atol=ATOL, rtol=ATOL)


def test_merge_skips_splits_without_weight():
    """A split with l = 0 is never read (its acc may hold anything) and a
    row with no weight in any split gives zeros, not NaN."""
    acc = torch.randn(2, 3, 8)
    m = torch.tensor([[0.5, NEG_INF_T, 1.5], [NEG_INF_T] * 3])
    l = torch.tensor([[2.0, 0.0, 3.0], [0.0] * 3])
    acc[:, 1] = float("nan")
    acc[1] = float("inf")
    out = cuda_pa.merge_split_partials(acc, m, l)
    w = torch.exp(torch.tensor([0.5, 1.5]) - 1.5)
    want = (acc[0, 0] * w[0] + acc[0, 2] * w[1]) / (2.0 * w[0] + 3.0 * w[1])
    torch.testing.assert_close(out[0], want)
    assert torch.equal(out[1], torch.zeros(8))


SPLIT_PLAN_SHAPES = {
    # name: (q shape, pool shape, page table shape) -> splits
    "llama3_8b_decode_b8_kv1024": ((8, 32, 128), (600, 16, 8, 128),
                                   (8, 64), 4),
    "llama3_8b_ragged_b1_kv1024": ((1, 32, 32, 128), (600, 16, 8, 128),
                                   (1, 64), 8),
    "llama3_8b_engine_decode": ((8, 32, 128), (1024, 16, 8, 128),
                                (8, 128), 4),
    "llama3_8b_engine_chunk": ((1, 32, 32, 128), (1024, 16, 8, 128),
                               (1, 128), 16),
    "gpt2_decode_b4": ((4, 12, 64), (300, 16, 12, 64), (4, 64), 6),
    "one_page": ((8, 32, 128), (64, 16, 8, 128), (8, 1), 1),
}


@pytest.mark.parametrize("name", sorted(SPLIT_PLAN_SHAPES))
def test_split_count_reads_only_shapes(name):
    """The host's split count comes from the launch's shapes: given meta
    tensors (shapes without values) it gives the same count as the plan on
    plain integers, and never more splits than kv tiles, nor more than
    half as many when a block holds over 32 rows."""
    q_shape, pool_shape, table_shape, want = SPLIT_PLAN_SHAPES[name]
    meta = {"device": "meta"}
    q = torch.empty(q_shape, dtype=torch.bfloat16, **meta)
    pages = torch.empty(pool_shape, dtype=torch.bfloat16, **meta)
    table = torch.empty(table_shape, dtype=torch.int32, **meta)
    splits = cuda_pa.launch_split_count(q, pages, table)
    assert splits == want
    capacity = table_shape[1] * pool_shape[1]
    group = q_shape[-2] // pool_shape[2]
    rows = (q_shape[1] if len(q_shape) == 4 else 1) * group
    assert splits == cuda_pa.kv_split_plan(q_shape[0], pool_shape[2], rows,
                                           capacity)
    tiles = -(-capacity // cuda_pa.KV_TILE)
    assert 1 <= splits <= (tiles if rows <= 32 else max(1, tiles // 2))


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("name", sorted(SPLIT_PLAN_SHAPES))
def test_quantized_split_count_reads_only_shapes(name, dtype):
    """On int8 / fp8 pools the split count comes from the same shapes
    (meta tensors: no values), and it is the bf16 pools' count."""
    q_shape, pool_shape, table_shape, want = SPLIT_PLAN_SHAPES[name]
    meta = {"device": "meta"}
    q = torch.empty(q_shape, dtype=torch.bfloat16, **meta)
    pages = torch.empty(pool_shape, dtype=dtype, **meta)
    table = torch.empty(table_shape, dtype=torch.int32, **meta)
    assert cuda_pa.launch_split_count(q, pages, table) == want


# ---------------------------------------------------------------------------
# page writes: rows outside a slot's valid run are dropped, never clamped
# ---------------------------------------------------------------------------


def _pools(seed, nb=6, bs=4, hkv=2, d=8):
    return np.random.default_rng(seed).normal(
        size=(nb, bs, hkv, d)).astype(np.float32)


def test_append_token_pages_matches_jax_and_drops_inactive():
    nb, bs = 6, 4
    pages = _pools(0, nb, bs)
    vals = np.random.default_rng(1).normal(size=(3, 2, 8)).astype(
        np.float32)
    # Slot 2 is inactive and its table points at the LAST live block:
    # a clamped write would land there.
    table = np.asarray([[0, 1], [2, 3], [nb - 1, nb - 1]], np.int32)
    pos = np.asarray([5, 2, 3], np.int32)
    active = np.asarray([True, True, False])
    want = np.asarray(jpa.append_token_pages(
        jnp.asarray(pages), jnp.asarray(vals), jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(active)))
    got = torch.from_numpy(pages.copy())
    tpa.append_token_pages(got, torch.from_numpy(vals),
                           torch.from_numpy(table), torch.from_numpy(pos),
                           torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[nb - 1], pages[nb - 1])


def test_append_chunk_pages_matches_jax_and_drops_padding():
    nb, bs, s = 6, 4, 6
    pages = _pools(2, nb, bs)
    vals = np.random.default_rng(3).normal(size=(3, s, 2, 8)).astype(
        np.float32)
    # Slot 0: 2 real rows of 6 starting at 6 — its padding rows run past
    # the 2-block table (positions up to 11 → block index 2, clipped to
    # the last table entry by the gather). Slot 1: full chunk. Slot 2:
    # inactive, pointing at the last block.
    table = np.asarray([[0, 1], [2, 3], [nb - 1, nb - 1]], np.int32)
    starts = np.asarray([6, 1, 0], np.int32)
    counts = np.asarray([2, 6, 4], np.int32)
    active = np.asarray([True, True, False])
    want = np.asarray(jpa.append_chunk_pages(
        jnp.asarray(pages), jnp.asarray(vals), jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(active)))
    got = torch.from_numpy(pages.copy())
    tpa.append_chunk_pages(got, torch.from_numpy(vals),
                           torch.from_numpy(table), torch.from_numpy(starts),
                           torch.from_numpy(counts),
                           torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[nb - 1], pages[nb - 1])
    # Slot 0 wrote exactly its 2 rows (positions 6, 7 of block 1).
    changed = (got.numpy() != pages).any(axis=(2, 3))
    assert changed[1].tolist() == [False, False, True, True]


def test_write_index_lists_only_valid_rows():
    table = torch.tensor([[4, 5], [1, 2]], dtype=torch.int32)
    rows, blocks, offsets = tpa.paged_write_index(
        table, torch.tensor([3, 0]), torch.tensor([2, 1]),
        torch.tensor([True, False]), 4, 3)
    assert rows.tolist() == [0, 1]
    assert blocks.tolist() == [4, 5]
    assert offsets.tolist() == [3, 0]
