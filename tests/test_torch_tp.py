"""The port's tensor-parallel paged attention against the JAX package's,
on the same numpy inputs on the CPU:

- the plain versions of the two latent tp kernels
  (``latent_block_scores_plain``, ``latent_block_wsum_plain``) against
  JAX's ``_latent_block_scores`` / ``_latent_block_wsum`` in interpret
  mode: decode and ragged rows, bf16, int8 and fp8 pools, lengths that end
  inside a block (the rows past kv_len in its last block are stale pool
  bytes, computed by both) and blocks wholly past kv_len (zeros / skipped).
  Scores: fp32 sums of products that are exact on both sides, atol/rtol
  2e-5 of values of order 1-10. Weighted sums: the port sums p·latent
  and expands once where the TPU body expands every tile first — the
  same function reassociated, atol/rtol 2e-5;
- the tp composition (``paged_attention_latent_shards``: two column
  shards in one process, their partials summed) against JAX's
  ``paged_attention_latent(..., mesh=)`` on 2 virtual CPU devices, at
  JAX's own atol/rtol 2e-5 (tests/test_kernel_gen.py:631-672);
- the dense head-sharded decode and ragged functions on each rank's heads,
  gathered, against JAX's ``paged_attention_decode_tp`` /
  ``_multiquery_tp`` (tests/test_disagg.py:70-131 tolerances, 1e-5);
- ``tp_paged_ineligible_reason``'s messages, equal to JAX's;
- the latent writer's full-row scale: a rank's int8 latent columns carry
  the scale of the WHOLE row, so the ranks' bytes concatenate to the
  single-device pool's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from test_torch_mla import KINDS, _to_torch, mla_pair

from megatronapp_tpu.config.parallel_config import TP_AXIS
from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.ops.pallas import kernel_gen as jkg
from megatronapp_tpu.ops.pallas import paged_attention as jpa
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu_torch.ops import paged_attention as tpa
from megatronapp_tpu_torch.ops.cuda import latent_tp as tlt

TOL = dict(atol=2e-5, rtol=2e-5)
SCALE = 1.0 / (16 + 8) ** 0.5
POOL_KINDS = ("bf16", "int8", "fp8")


def _pool(rng, nb, bs, d, kind):
    """(JAX pages, JAX scales or None) of random rows in `kind`."""
    rows = jnp.asarray(rng.normal(size=(nb, bs, d)), jnp.float32)
    if kind == "bf16":
        return rows.astype(jnp.bfloat16), None
    return jpa.quantize_kv_rows(rows, dtype=KINDS[kind][0])


def _tables(rng, b, mb, bs):
    """A shuffled page table and lengths: one slot ends inside a block,
    one at a block edge, one at a single row (blocks past each length
    stay in the table)."""
    nb = b * mb + 1
    table = (rng.permutation(nb - 1)[:b * mb].reshape(b, mb) + 1).astype(
        np.int32)
    lens = np.asarray([bs + 3, 2 * bs, 1][:b], np.int32)
    return nb, jnp.asarray(table), jnp.asarray(lens)


PHASE_CASES = [(mode, kind) for mode in ("decode", "ragged")
               for kind in POOL_KINDS]


@pytest.mark.parametrize("mode,kind", PHASE_CASES,
                         ids=["-".join(c) for c in PHASE_CASES])
def test_block_scores_plain_matches_jax_kernel(mode, kind):
    rng = np.random.default_rng(PHASE_CASES.index((mode, kind)))
    b, bs, mb, d, nq = 3, 4, 4, 16, 4
    rows = nq * (1 if mode == "decode" else 3)
    nb, table, lens = _tables(rng, b, mb, bs)
    pages, scales = _pool(rng, nb, bs, d, kind)
    q = jnp.asarray(rng.normal(size=(b, rows, d)), jnp.float32)
    want = np.asarray(jkg._latent_block_scores(q, pages, table, lens,
                                               scales))
    got = tlt.latent_block_scores(_to_torch(q), _to_torch(pages),
                                  _to_torch(table), _to_torch(lens),
                                  _to_torch(scales))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Blocks wholly past kv_len are exact zeros on both sides; the stale
    # rows of slot 0's last block (kv 7 of 8) are computed by both.
    past = np.arange(mb * bs)[None, :] // bs * bs >= np.asarray(lens)[:, None]
    assert not got.numpy()[np.broadcast_to(past[:, None, :],
                                           want.shape)].any()
    assert want[0, :, bs + 3].any() and got.numpy()[0, :, bs + 3].any()


@pytest.mark.parametrize("mode,kind", PHASE_CASES,
                         ids=["-".join(c) for c in PHASE_CASES])
def test_block_wsum_plain_matches_jax_kernel(mode, kind):
    rng = np.random.default_rng(10 + PHASE_CASES.index((mode, kind)))
    b, bs, mb, d, nq, dv = 3, 4, 4, 16, 4, 8
    rows = nq * (1 if mode == "decode" else 3)
    nb, table, lens = _tables(rng, b, mb, bs)
    pages, scales = _pool(rng, nb, bs, d, kind)
    # Positive weights everywhere, the stale rows and the blocks past
    # kv_len included: both sides skip only the latter.
    p = jnp.asarray(rng.uniform(size=(b, rows, mb * bs)), jnp.float32)
    w_v = jnp.asarray(rng.normal(size=(d, nq, dv)), jnp.bfloat16)
    want = np.asarray(jkg._latent_block_wsum(p, pages, table, lens, w_v,
                                             scales))
    got = tlt.latent_block_wsum(_to_torch(p), _to_torch(pages),
                                _to_torch(table), _to_torch(lens),
                                _to_torch(w_v), _to_torch(scales))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _latent_inputs(seed, s_q, kind):
    """JAX inputs of the latent kernel at JAX's test widths (nq 4, klat
    32, dpe 8, dv 16, bs 8, mb 4), fp32 queries, fp32 or quantized pools
    (tests/test_kernel_gen.py:_mk_latent_inputs with lengths that end
    inside a block)."""
    rng = np.random.default_rng(seed)
    b, nq, klat, dpe, dv, bs, mb = 3, 4, 32, 8, 16, 8, 4
    nb = b * mb + 1
    qs = (b, s_q, nq) if s_q else (b, nq)
    f = lambda *s: jnp.asarray(rng.normal(size=s), jnp.float32)  # noqa: E731
    q_lat, q_pe = f(*qs, klat), f(*qs, dpe)
    lat, pe, w_v = f(nb, bs, klat), f(nb, bs, dpe), f(klat, nq, dv)
    table = jnp.asarray(rng.permutation(nb - 1)[:b * mb].reshape(b, mb) + 1,
                        jnp.int32)
    lens = jnp.asarray([max(s_q, 5), 13, 32], jnp.int32)
    ls = ps = None
    if kind != "fp32":
        lat, ls = jpa.quantize_kv_rows(lat, dtype=KINDS[kind][0])
        pe, ps = jpa.quantize_kv_rows(pe, dtype=KINDS[kind][0])
    return q_lat, q_pe, lat, pe, table, lens, w_v, ls, ps


COMPOSE_CASES = [(mode, kind) for mode in ("decode", "ragged")
                 for kind in ("fp32", "int8", "fp8")]


@pytest.mark.parametrize("mode,kind", COMPOSE_CASES,
                         ids=["-".join(c) for c in COMPOSE_CASES])
def test_latent_tp_composition_matches_jax_mesh(devices8, mode, kind):
    """Two latent-column shards summed in one process against JAX's
    latent-column tp placement on a 2-device mesh (and both against the
    single-device kernel)."""
    s_q = 5 if mode == "ragged" else 0
    ins = _latent_inputs(20 + COMPOSE_CASES.index((mode, kind)), s_q, kind)
    q_lat, q_pe, lat, pe, table, lens, w_v, ls, ps = ins
    q_lens = jnp.asarray([5, 2, 1], jnp.int32) if s_q else None
    ctx = j_build_mesh(JPC(tensor_parallel=2), devices=devices8[:2])
    kw = dict(q_lens=q_lens, softmax_scale=SCALE, lat_scales=ls,
              pe_scales=ps)
    want = np.asarray(jkg.paged_attention_latent(
        q_lat, q_pe, lat, pe, table, lens, w_v, mesh=ctx.mesh, **kw))
    single = np.asarray(jkg.paged_attention_latent(
        q_lat, q_pe, lat, pe, table, lens, w_v, **kw))
    t = [_to_torch(a) for a in ins]
    got = tpa.paged_attention_latent_shards(
        t[0], t[1], t[2], t[3], t[4], t[5], t[6], 2,
        q_lens=_to_torch(q_lens), softmax_scale=SCALE, lat_scales=t[7],
        pe_scales=t[8]).numpy()
    if s_q:
        real = np.arange(s_q)[None, :] < np.asarray(q_lens)[:, None]
        got, want, single = got[real], want[real], single[real]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, single, **TOL)


def test_latent_tp_refuses_an_uneven_split():
    t = [_to_torch(a) for a in _latent_inputs(0, 0, "fp32")]
    with pytest.raises(ValueError, match="does not split over tp 3"):
        tpa.paged_attention_latent_shards(t[0], t[1], t[2], t[3], t[4],
                                          t[5], t[6], 3,
                                          softmax_scale=SCALE)


@pytest.mark.parametrize("mode", ["decode", "ragged"])
def test_dense_tp_matches_jax_tp(devices8, mode, monkeypatch):
    """tests/test_disagg.py:70-131's inputs: rank r attends heads r of
    each kind; the ranks' outputs, concatenated as the all-gather
    concatenates them, equal JAX's head-sharded kernel."""
    rng = np.random.default_rng(0 if mode == "decode" else 1)
    b, hq, hkv, d, bs, mb = 3, 4, 2, 16, 8, 4
    nb = b * mb
    ragged = mode == "ragged"
    q = rng.normal(size=(b, 3, hq, d) if ragged else (b, hq, d))
    kp = rng.normal(size=(nb, bs, hkv, d))
    vp = rng.normal(size=(nb, bs, hkv, d))
    table = rng.permutation(nb).reshape(b, mb).astype(np.int32)
    lens = np.asarray([3, bs + 3, mb * bs], np.int32)
    q_lens = np.asarray([3, 2, 1], np.int32) if ragged else None
    ctx = j_build_mesh(JPC(tensor_parallel=2), devices=devices8[:2])
    head = P(None, None, TP_AXIS, None) if ragged else P(None, TP_AXIS, None)
    pool = NamedSharding(ctx.mesh, P(None, None, TP_AXIS, None))
    jq = jax.device_put(jnp.asarray(q, jnp.float32),
                        NamedSharding(ctx.mesh, head))
    jk = jax.device_put(jnp.asarray(kp, jnp.float32), pool)
    jv = jax.device_put(jnp.asarray(vp, jnp.float32), pool)
    if ragged:
        want = jpa.paged_attention_multiquery_tp(
            jq, jk, jv, jnp.asarray(table), jnp.asarray(lens),
            jnp.asarray(q_lens), ctx.mesh)
    else:
        want = jpa.paged_attention_decode_tp(jq, jk, jv, jnp.asarray(table),
                                             jnp.asarray(lens), ctx.mesh)
    gathered = []

    def gather(x, _ctx, dim):
        gathered.append(dim)
        return x
    monkeypatch.setattr(tpa, "all_gather_heads", gather)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    parts = []
    for rank in range(2):
        qr = t(q)[..., rank * 2:(rank + 1) * 2, :].contiguous()
        kr = t(kp)[:, :, rank:rank + 1].contiguous()
        vr = t(vp)[:, :, rank:rank + 1].contiguous()
        if ragged:
            parts.append(tpa.paged_attention_multiquery_tp(
                qr, kr, vr, tt, tl, torch.from_numpy(q_lens), None))
        else:
            parts.append(tpa.paged_attention_decode_tp(qr, kr, vr, tt, tl,
                                                       None))
    got = torch.cat(parts, dim=-2).numpy()
    assert gathered == [2 if ragged else 1] * 2
    want = np.asarray(want)
    if ragged:
        for i, ql in enumerate(q_lens):
            np.testing.assert_allclose(got[i, :ql], want[i, :ql],
                                       atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


class _Ctx:
    tp = 2


def _cfg_pair(**over):
    from test_torch_layers import LLAMA_SMALL, cfg_pair
    return cfg_pair(**{**LLAMA_SMALL, **over})


REASON_CASES = [
    ("eligible", dict()),
    ("heads", dict(num_attention_heads=3, num_query_groups=3)),
    ("groups", dict(num_attention_heads=4, num_query_groups=1)),
    ("mla_ok", "mla"),
    ("mla_klat", dict(kv_lora_rank=33)),
]


@pytest.mark.parametrize("name,over", REASON_CASES,
                         ids=[c[0] for c in REASON_CASES])
def test_ineligible_reasons_equal_jax(name, over):
    if over == "mla" or name.startswith("mla"):
        jc, tc = mla_pair(**({} if over == "mla" else over))
    else:
        jc, tc = _cfg_pair(**over)
    for ctx in (None, _Ctx()):
        assert tpa.tp_paged_ineligible_reason(tc, ctx) == \
            jpa.tp_paged_ineligible_reason(jc, ctx)
        assert tpa.tp_paged_eligible(tc, ctx) == \
            jpa.tp_paged_eligible(jc, ctx)

    class One:
        tp = 1
    assert tpa.tp_paged_ineligible_reason(tc, One()) == \
        jpa.tp_paged_ineligible_reason(jc, One())


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_latent_writer_keeps_the_whole_rows_scale(kind):
    """Each rank writes its latent columns quantized with the scale of the
    WHOLE row (JAX's scale pool replicates): the two ranks' pages side by
    side are the single-device pool's bytes, and every rank's scale pool
    equals it. Per-shard scales would differ."""
    from megatronapp_tpu_torch.ops.cuda.paged_attention import storage_view
    from megatronapp_tpu_torch.ops.paged_attention import (
        paged_write_index, write_kv,
    )
    dt = KINDS[kind][1]
    rng = np.random.default_rng(5)
    b, s, klat, dpe, nb, bs = 2, 3, 32, 8, 6, 4
    latent = torch.from_numpy(rng.normal(size=(b, s, klat)).astype(
        np.float32))
    latent[..., :16] *= 20.0        # the halves' absmax differ widely
    k_pe = torch.from_numpy(rng.normal(size=(b, s, dpe)).astype(np.float32))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    index = paged_write_index(table, torch.tensor([1, 4]),
                              torch.tensor([3, 2]), torch.ones(b, dtype=bool),
                              bs, s)

    def pools(cols):
        return ((torch.zeros(nb, bs, cols, dtype=dt),
                 torch.zeros(nb, bs, dpe, dtype=dt)),
                (torch.ones(nb, bs), torch.ones(nb, bs)))
    whole, whole_sc = pools(klat)
    write_kv(whole, whole_sc, latent, k_pe, index)
    ranks = []
    for rank in range(2):
        cache, sc = pools(klat // 2)
        write_kv(cache, sc, latent, k_pe, index,
                 k_cols=slice(rank * 16, (rank + 1) * 16))
        ranks.append((cache, sc))
        for a, w in zip(sc, whole_sc):
            assert torch.equal(a, w)
        assert torch.equal(storage_view(cache[1]), storage_view(whole[1]))
    joined = torch.cat([storage_view(r[0][0]) for r in ranks], dim=-1)
    assert torch.equal(joined, storage_view(whole[0]))
    # A per-shard scale would be the half-row's: not what JAX stores.
    from megatronapp_tpu_torch.ops.paged_attention import quantize_kv_rows
    _, half_scale = quantize_kv_rows(latent[..., 16:], dt)
    _, row_scale = quantize_kv_rows(latent, dt)
    assert not torch.equal(half_scale, row_scale)
