"""Quantized (int8 / fp8 e4m3) KV pools of the port against the JAX
package.

- ``quantize_kv_rows``: the same int8 / fp8 bytes and bitwise the same
  fp32 scales as JAX's on the same rows. torch and XLA both cast fp32 to
  e4m3 rounding to nearest even; a differing byte is reported with its
  value, never tolerated.
- The plain quantized paged attention against the Pallas kernel
  ``kernel_gen.paged_attention(..., k_scales=, v_scales=)`` (interpret
  mode on the CPU) and its jnp references, decode and ragged, int8 and fp8,
  GQA and MHA. Both sides dequantize float(page) × scale and compute in
  fp32 throughout (the quantized body never rounds q or P), so they differ
  only in summation order: rtol 1e-5 / atol 1e-6.
- The pool (tests/test_kv_quant.py:165-318 in kind): dtype-aware bytes,
  copy-on-write copies scales with the pages, the page writes drop what
  they must. Preemption and resume on quantized pools, against JAX's
  engine: tests/test_torch_quant_engine.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import LLAMA_SMALL, cfg_pair

from megatronapp_tpu.ops.pallas import kernel_gen
from megatronapp_tpu.ops.pallas import paged_attention as jpa
from megatronapp_tpu_torch.inference.paged_cache import (
    KV_CACHE_DTYPES, PagedKVCache, validate_kv_cache_dtype,
)
from megatronapp_tpu_torch.ops import paged_attention as tpa
from megatronapp_tpu_torch.ops.cuda import paged_attention as cuda_pa

RTOL, ATOL = 1e-5, 1e-6
KINDS = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _bytes(t: torch.Tensor) -> np.ndarray:
    return cuda_pa.storage_view(t).view(torch.uint8).numpy()


def _jbytes(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _quantized(rows: np.ndarray, kind: str):
    """(port (q, scales), JAX (q, scales)) of the same fp32 rows."""
    tdt, jdt = KINDS[kind]
    return (tpa.quantize_kv_rows(torch.from_numpy(rows), tdt),
            jpa.quantize_kv_rows(jnp.asarray(rows), dtype=jdt))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_quantize_kv_rows_matches_jax_bitwise(kind):
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(5, 7, 3, 32)).astype(np.float32)
    rows[0, 0, 0] = 0.0                          # all-zero row: scale 1e-12
    rows[1, 2] *= 1e3                            # large rows saturate nothing
    (tq, ts), (jq, js) = _quantized(rows, kind)
    assert tq.dtype == KINDS[kind][0] and ts.dtype == torch.float32
    assert tuple(ts.shape) == rows.shape[:-1]
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    got, want = _bytes(tq), _jbytes(jq)
    bad = np.flatnonzero(got.ravel() != want.ravel())
    assert bad.size == 0, (
        f"{bad.size} {kind} bytes differ, first at {bad[0]}: port "
        f"{got.ravel()[bad[0]]:#04x}, JAX {want.ravel()[bad[0]]:#04x}")
    # The round trip stays within half a quantum (int8) of each element.
    back = tq.float() * ts[..., None]
    if kind == "int8":
        assert float((back - torch.from_numpy(rows)).abs().max()) <= \
            float(ts.max()) / 2 + 1e-6
    assert bool(torch.isfinite(back).all())


def test_fp8_quantize_saturates_instead_of_nan():
    """e4m3 overflow is NaN: the clip to ±448 keeps every row finite."""
    rows = torch.tensor([[[1.0, -2.0, 3.0e5, 7.0]]])
    q, s = tpa.quantize_kv_rows(rows, torch.float8_e4m3fn)
    assert bool(torch.isfinite(q.float()).all())
    assert float(q.float().abs().max()) == 448.0
    assert tpa.quant_dtype_of(torch.float8_e4m3fn) == "fp8"
    assert tpa.quant_qmax_of(torch.int8) == 127.0
    assert tpa.quant_dtype_of(torch.bfloat16) is None
    with pytest.raises(ValueError, match="not a registered"):
        tpa.quant_qmax_of(torch.bfloat16)


# ---------------------------------------------------------------------------
# quantized paged attention: plain version vs the Pallas kernel
# ---------------------------------------------------------------------------


def _case(seed, kind, b, hq, hkv, d, bs, mb, lens, s_q=None):
    rng = np.random.default_rng(seed)
    nb = b * mb + 2
    q_shape = (b, hq, d) if s_q is None else (b, s_q, hq, d)
    kv = [rng.normal(size=(nb, bs, hkv, d)).astype(np.float32)
          for _ in range(2)]
    (kq, ks), (jkq, jks) = _quantized(kv[0], kind)
    (vq, vs), (jvq, jvs) = _quantized(kv[1], kind)
    return {
        "q": rng.normal(size=q_shape).astype(np.float32),
        "table": rng.permutation(nb)[:b * mb].reshape(b, mb).astype(
            np.int32),
        "lens": np.asarray(lens, np.int32),
        "port": (kq, vq, ks, vs), "jax": (jkq, jvq, jks, jvs),
    }


def _port(c, q_lens=None):
    kq, vq, ks, vs = c["port"]
    out = cuda_pa.paged_attention(
        torch.from_numpy(c["q"]), kq, vq, torch.from_numpy(c["table"]),
        torch.from_numpy(c["lens"]),
        q_lens=None if q_lens is None else torch.from_numpy(q_lens),
        k_scales=ks, v_scales=vs)
    return out.numpy()


def _jax(c, q_lens=None, reference=False):
    kq, vq, ks, vs = c["jax"]
    args = (jnp.asarray(c["q"]), kq, vq, jnp.asarray(c["table"]),
            jnp.asarray(c["lens"]))
    if reference:
        if q_lens is None:
            return np.asarray(jpa.paged_attention_reference(
                *args, k_scales=ks, v_scales=vs))
        return np.asarray(jpa.paged_attention_multiquery_reference(
            *args, jnp.asarray(q_lens), k_scales=ks, v_scales=vs))
    return np.asarray(kernel_gen.paged_attention(
        *args, q_lens=None if q_lens is None else jnp.asarray(q_lens),
        k_scales=ks, v_scales=vs))


SHAPES = {"gqa": (4, 2, 16, 4), "mha": (4, 4, 32, 8)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_decode_matches_jax_quantized_kernel(kind, shape):
    hq, hkv, d, bs = SHAPES[shape]
    mb = 4
    c = _case(hq * 10 + bs, kind, 3, hq, hkv, d, bs, mb,
              [1, bs + 1, mb * bs])
    got = _port(c)
    assert got.shape == c["q"].shape
    np.testing.assert_allclose(got, _jax(c), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _jax(c, reference=True), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ragged_matches_jax_quantized_kernel(kind, shape):
    """Ragged rows with padding: the real rows against the kernel and the
    reference, every row finite."""
    hq, hkv, d, bs = SHAPES[shape]
    mb, s_q = 5, 6
    lens = [3, bs + 2, mb * bs]
    q_lens = np.asarray([1, min(s_q, bs + 2), s_q - 1], np.int32)
    c = _case(hq + s_q, kind, 3, hq, hkv, d, bs, mb, lens, s_q=s_q)
    got = _port(c, q_lens)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(c, q_lens), rtol=RTOL, atol=ATOL)
    real = np.arange(s_q)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(got[real], _jax(c, q_lens, True)[real],
                               rtol=RTOL, atol=ATOL)


def test_quantized_plain_version_is_the_function_on_dequantized_pools():
    """The plain version's quantized branch is the unquantized function on
    the dequantized pools (float(page) × scale)."""
    c = _case(5, "int8", 2, 4, 2, 16, 4, 3, [5, 12])
    kq, vq, ks, vs = c["port"]
    deq = [p.float() * s[..., None] for p, s in ((kq, ks), (vq, vs))]
    want = cuda_pa.paged_attention_plain(
        torch.from_numpy(c["q"]), *deq, torch.from_numpy(c["table"]),
        torch.from_numpy(c["lens"]))
    np.testing.assert_allclose(_port(c), want.numpy(), rtol=RTOL, atol=ATOL)


def test_quantized_plain_version_counts_no_launch():
    before = dict(cuda_pa.launches)
    _port(_case(1, "fp8", 2, 4, 2, 16, 4, 3, [5, 11]))
    assert cuda_pa.launches == before
    assert {"decode_int8", "decode_fp8", "ragged_int8",
            "ragged_fp8"} <= set(before)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_write_kv_quantizes_and_drops_inactive_rows(kind):
    """write_kv writes quantized rows and their scales at the write index
    (the JAX append's quantize-then-scatter); inactive rows land nowhere."""
    nb, bs, hkv, d = 6, 4, 2, 8
    tdt = KINDS[kind][0]
    pages = [torch.zeros(nb, bs, hkv, d, dtype=tdt) for _ in range(2)]
    scales = [torch.ones(nb, bs, hkv) for _ in range(2)]
    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.normal(size=(3, 1, hkv, d)).astype(
        np.float32)) for _ in range(2))
    table = torch.tensor([[0, 1], [2, 3], [nb - 1, nb - 1]],
                         dtype=torch.int32)
    pos = torch.tensor([5, 2, 3], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    index = tpa.paged_write_index(table, pos,
                                  torch.ones(3, dtype=torch.int32), active,
                                  bs, 1)
    tpa.write_kv(pages, scales, k, v, index)
    for got, sc, rows in ((pages[0], scales[0], k), (pages[1], scales[1], v)):
        q, s = tpa.quantize_kv_rows(rows[:, 0], tdt)
        for slot, (blk, off) in enumerate(((1, 1), (2, 2))):
            assert np.array_equal(_bytes(got[blk, off]), _bytes(q[slot]))
            assert torch.equal(sc[blk, off], s[slot])
        assert not _bytes(got[nb - 1]).any()          # inactive: dropped
        assert bool((sc[nb - 1] == 1).all())


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def _pool(kind, num_blocks=8, block_size=4, max_batch=2, dtype=None):
    _, tc = cfg_pair(**LLAMA_SMALL)
    if dtype is not None:
        import dataclasses
        tc = dataclasses.replace(tc, compute_dtype=dtype)
    return tc, PagedKVCache(tc, max_batch, 32, num_blocks=num_blocks,
                            block_size=block_size, kv_cache_dtype=kind)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pool_bytes_are_dtype_aware(kind):
    """One byte an element plus fp32 scales: (D + 4) / (c D) of a
    compute-dtype pool of itemsize c (tests/test_kv_quant.py:166)."""
    tc, base = _pool("bf16", dtype=torch.bfloat16)
    _, pool = _pool(kind)
    d = tc.head_dim
    assert pool.quantized and not base.quantized
    assert pool.pages[0].dtype == KINDS[kind][0]
    assert all(s.dtype == torch.float32 and tuple(s.shape) == tuple(
        pool.pages[0].shape[:-1]) for s in pool.scales)
    assert pool.bytes_total / base.bytes_total == (d + 4) / (2 * d)
    assert pool.bytes_per_block * pool.num_blocks == pool.bytes_total
    assert base.scales is None


def test_kv_cache_dtype_registry():
    assert sorted(KV_CACHE_DTYPES) == ["bf16", "fp8", "int8"]
    assert KV_CACHE_DTYPES["fp8"].qmax == 448.0
    assert KV_CACHE_DTYPES["int8"].page_dtype == torch.int8
    with pytest.raises(ValueError, match="kv_cache_dtype must be one of"):
        validate_kv_cache_dtype("int4")
    with pytest.raises(ValueError, match="requires the paged backend"):
        validate_kv_cache_dtype("int8", paged=False)
    assert validate_kv_cache_dtype("bf16", paged=False).name == "bf16"


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cow_copies_scales_with_the_pages(kind):
    """A copy-on-write block carries the shared block's quantized rows and
    their scales verbatim (no re-quantization), every layer."""
    tc, pool = _pool(kind)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.normal(size=(
        tc.num_layers, 4, tc.num_query_groups, tc.head_dim)).astype(
        np.float32))
    q, s = tpa.quantize_kv_rows(rows, KINDS[kind][0])
    toks = np.arange(4, dtype=np.int32)
    blk = pool.admit(0, toks).blocks[0]
    for p, sc in zip(pool.pages, pool.scales):
        cuda_pa.storage_view(p)[:, blk] = cuda_pa.storage_view(q)
        sc[:, blk] = s
    pool.release(0, toks, 4)
    plan = pool.admit(1, toks)                 # full hit → CoW
    assert plan.cow and plan.blocks[-1] != blk
    dst = plan.blocks[-1]
    for p, sc in zip(pool.pages, pool.scales):
        assert np.array_equal(_bytes(p[:, dst]), _bytes(p[:, blk]))
        assert torch.equal(sc[:, dst], sc[:, blk])
    pool.audit()


# ---------------------------------------------------------------------------
# the quantized kernel's arithmetic on the tensor cores, in plain PyTorch
# ---------------------------------------------------------------------------


def test_every_int8_code_is_a_bf16_value():
    """The kernel widens int8 codes to bf16 for the mma: all 256 exactly."""
    codes = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    widened = codes.float().to(torch.bfloat16).float()
    assert torch.equal(widened, codes.float())
    assert widened.unique().numel() == 256


def test_every_finite_e4m3_code_is_a_bf16_value():
    """Every finite e4m3 bit pattern (254 of 256: 0x7f and 0xff are NaN)
    widens to bf16 exactly, subnormals (0x01-0x07) included."""
    codes = torch.arange(256, dtype=torch.int16).to(torch.uint8)
    vals = codes.view(torch.float8_e4m3fn).float()
    finite = torch.isfinite(vals)
    assert int(finite.sum()) == 254
    assert torch.equal(vals[finite].to(torch.bfloat16).float(), vals[finite])
    assert float(vals[finite].abs().max()) == 448.0
    assert float(vals[1]) == 2.0 ** -9


def _split_err(x, terms):
    got = sum(t.double() for t in cuda_pa.split_bf16_terms(x, terms))
    return (got - x.double()).abs(), x.double().abs()


@pytest.mark.parametrize("values", ["random", "large", "subnormal"])
def test_split_bf16_terms_accuracy(values):
    """Three bf16 terms give back every normal fp32 value exactly; two
    agree to 2^-16 of it. fp32 subnormals lie below bf16's own subnormal
    step 2^-133, so there the terms agree to that step."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=4096) * np.exp(rng.uniform(-20, 20, 4096))
    x = {"random": base,
         "large": np.sign(base) * rng.uniform(1e30, 3.3e38, 4096),
         "subnormal": np.sign(base) * rng.uniform(1e-45, 1.1e-38, 4096),
         }[values]
    x = torch.from_numpy(x.astype(np.float32))
    for t in cuda_pa.split_bf16_terms(x, 3):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    err3, mag = _split_err(x, 3)
    err2, _ = _split_err(x, 2)
    if values == "subnormal":
        assert bool((err3 <= 2.0 ** -134).all())
        assert bool((err2 <= 2.0 ** -134).all())
    else:
        assert bool((err3 == 0).all())
        assert bool((err2 <= mag * 2.0 ** -16).all())
        assert float((err2 / mag).max()) > 2.0 ** -20   # two terms do lose


# kind x mode x splits: the quantized kernel's split partials (scores from
# raw bf16 q and the codes, x scale s_k; P s_v in three bf16 terms)
# merged in split order, against the Pallas kernel in interpret mode.
# Capacity 640 positions: 10 kv tiles of 64, dealt to the splits in turn.
_QSPLIT = dict(hq=4, hkv=2, d=16, bs=16, mb=40)
_QSPLIT_TOL = 1e-5    # of the (row, head)'s output RMS


@functools.lru_cache(maxsize=None)
def _qsplit_case(kind, mode):
    """The case with q rounded to bf16 values (the kernel takes bf16 q), and
    the Pallas kernel's output on it."""
    g = _QSPLIT
    ragged = mode == "ragged"
    lens = [640, 100, 7] if ragged else [1, 300, 640]
    q_lens = np.asarray([6, 3, 4], np.int32) if ragged else None
    c = _case(len(kind) * 7 + len(mode), kind, 3, g["hq"], g["hkv"], g["d"],
              g["bs"], g["mb"], lens, s_q=6 if ragged else None)
    c["q"] = torch.from_numpy(c["q"]).to(torch.bfloat16).float().numpy()
    return c, q_lens, _jax(c, q_lens)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("mode", ["decode", "ragged"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_quantized_split_mirror_matches_jax_kernel(kind, mode, splits):
    c, q_lens, want = _qsplit_case(kind, mode)
    kq, vq, ks, vs = c["port"]
    acc, m, l = cuda_pa.split_partials_plain(
        torch.from_numpy(c["q"]), kq, vq, torch.from_numpy(c["table"]),
        torch.from_numpy(c["lens"]),
        None if q_lens is None else torch.from_numpy(q_lens), splits,
        k_scales=ks, v_scales=vs)
    got = cuda_pa.merge_split_partials(acc, m, l)
    got = (got[:, 0] if q_lens is None else got).numpy()
    assert np.isfinite(got).all()
    if q_lens is not None:      # padding rows are finite garbage
        real = np.arange(got.shape[1])[None, :] < q_lens[:, None]
        got, want = got[real], want[real]
    rms = np.sqrt((want.astype(np.float64) ** 2).mean(-1, keepdims=True))
    assert float((np.abs(got - want) / rms).max()) <= _QSPLIT_TOL
