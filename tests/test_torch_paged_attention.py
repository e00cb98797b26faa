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
