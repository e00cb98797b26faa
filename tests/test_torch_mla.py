"""The port's multi-latent attention (MLA) against the JAX package's, on
the same numpy inputs on the CPU, at the widths of JAX's own MLA tests
(kv_lora_rank 32, qk_head_dim 16, qk_pos_emb_head_dim 8, v_head_dim 16):

- the latent paged-attention kernel's plain version against JAX's
  ``paged_attention_latent`` (interpret mode, as TestLatentKernelPins runs
  it) and its dense reference: decode and ragged, bf16/int8/fp8 pools, a
  q_len of 1, a full chunk and a ragged tail; tolerances fp32 2e-5 and
  bf16 3e-2, JAX's own (tests/test_kernel_gen.py:542-544);
- rope tables over the decoupled width, the parameter leaves and count,
  the latent pools (shapes, scale pools, CoW, bytes), the row writers and
  quantizer on latent rows (bytes identical), the converter and the PTQ;
- one MLA layer, paged decode and ragged on compute-dtype and quantized
  pools, and the dense no-cache branch, in fp32: every element within
  1e-5 of the largest |element| (outputs of order 10-50 from the 0.4-std
  weights: the two sides sum in other orders over widths of 16-96).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import LLAMA_SMALL, _jtree, cfg_pair, random_layer, tree

from megatronapp_tpu.inference import paged_cache as jpc
from megatronapp_tpu.inference import quantization as jq
from megatronapp_tpu.models.gpt import gpt_rope_tables as j_tables
from megatronapp_tpu.models.gpt import init_gpt_params as j_init
from megatronapp_tpu.ops.pallas import kernel_gen as jkg
from megatronapp_tpu.ops.pallas import paged_attention as jpa
from megatronapp_tpu.transformer.block import layer_forward as j_layer
from megatronapp_tpu_torch.inference import paged_cache as tpc
from megatronapp_tpu_torch.inference import quantization as tq
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.models.gpt import gpt_rope_tables as t_tables
from megatronapp_tpu_torch.models.gpt import init_gpt_params as t_init
from megatronapp_tpu_torch.ops import paged_attention as tpa
from megatronapp_tpu_torch.transformer.block import layer_forward as t_layer

MLA = dict(multi_latent_attention=True, kv_lora_rank=32, qk_head_dim=16,
           qk_pos_emb_head_dim=8, v_head_dim=16)
SCALE = 1.0 / (16 + 8) ** 0.5
TOL = {"fp32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=3e-2,
                                                         rtol=3e-2)}
LAYER_TOL = 1e-5


def assert_close(got, want, rel=LAYER_TOL):
    """Every element within rel of the largest |element| of want."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * float(np.abs(want).max()), (err, np.abs(want).max())
KINDS = {"int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def mla_pair(**over):
    """The llama-shaped test config with MLA's test widths, fp32, as a JAX
    and a port config."""
    return cfg_pair(**{**LLAMA_SMALL, **MLA, **over})


# ---------------------------------------------------------------------------
# row 7's plain version against JAX's latent kernel
# ---------------------------------------------------------------------------


def _latent_inputs(seed, b, s_q, kind, dtype, nq=4, klat=32, dpe=8, dv=16,
                   bs=4, mb=4):
    """numpy inputs of the latent kernel: (q_lat, q_pe, lat, pe, w_v, table,
    kv_lens, lat_scales, pe_scales); pools quantized by JAX's
    quantize_kv_rows for int8/fp8."""
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    qs = (b, s_q, nq) if s_q else (b, nq)
    q_lat = rng.normal(size=qs + (klat,))
    q_pe = rng.normal(size=qs + (dpe,))
    lat = rng.normal(size=(nb, bs, klat))
    pe = rng.normal(size=(nb, bs, dpe))
    w_v = rng.normal(size=(klat, nq, dv))
    table = (rng.permutation(nb - 1)[:b * mb].reshape(b, mb) + 1).astype(
        np.int32)
    lens = rng.integers(max(s_q, 1), bs * mb, b).astype(np.int32)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    arrs = [jnp.asarray(a, jdt) for a in (q_lat, q_pe, lat, pe, w_v)]
    ls = ps = None
    if kind != "none":
        arrs[2], ls = jpa.quantize_kv_rows(arrs[2], dtype=KINDS[kind][0])
        arrs[3], ps = jpa.quantize_kv_rows(arrs[3], dtype=KINDS[kind][0])
    return arrs + [jnp.asarray(table), jnp.asarray(lens), ls, ps]


def _to_torch(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


LATENT_CASES = [(mode, kind, dtype)
                for mode in ("decode", "ragged", "one-row", "full-chunk")
                for kind in ("none", "int8", "fp8")
                for dtype in ("fp32", "bf16")]


@pytest.mark.parametrize("mode,kind,dtype", LATENT_CASES,
                         ids=["-".join(c) for c in LATENT_CASES])
def test_latent_plain_matches_jax_kernel(mode, kind, dtype):
    """Decode; ragged with q_lens [5, 3, 1] (a ragged tail and a q_len of
    1); every row q_len 1 (S_q 1); every row a full chunk of 5."""
    s_q = {"decode": 0, "one-row": 1}.get(mode, 5)
    ins = _latent_inputs(LATENT_CASES.index((mode, kind, dtype)), 3, s_q,
                         kind, dtype)
    q_lat, q_pe, lat, pe, w_v, table, lens, ls, ps = ins
    q_lens = None
    if s_q:
        q_lens = jnp.asarray({"ragged": [5, 3, 1], "one-row": [1, 1, 1],
                              "full-chunk": [5, 5, 5]}[mode], jnp.int32)
    want = jkg.paged_attention_latent(
        q_lat, q_pe, lat, pe, table, lens, w_v, q_lens=q_lens,
        softmax_scale=SCALE, lat_scales=ls, pe_scales=ps)
    ref = jpa.paged_attention_latent_reference(
        q_lat, q_pe, lat, pe, table, lens, w_v, q_lens=q_lens,
        softmax_scale=SCALE, lat_scales=ls, pe_scales=ps)
    t = [_to_torch(a) for a in ins]
    got = tpa.paged_attention_latent(
        t[0], t[1], t[2], t[3], t[5], t[6], t[4],
        q_lens=_to_torch(q_lens), softmax_scale=SCALE, lat_scales=t[7],
        pe_scales=t[8])
    assert got.dtype == t[0].dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if q_lens is not None:
        real = np.arange(s_q)[None, :] < np.asarray(q_lens)[:, None]
        got, want, ref = got[real], np.asarray(want)[real], \
            np.asarray(ref)[real]
    for other in (want, ref):
        np.testing.assert_allclose(got, np.asarray(other, np.float32),
                                   **TOL[dtype])
    port_ref = tpa.paged_attention_latent_reference(
        t[0], t[1], t[2], t[3], t[5], t[6], t[4],
        q_lens=_to_torch(q_lens), softmax_scale=SCALE, lat_scales=t[7],
        pe_scales=t[8]).float().numpy()
    if q_lens is not None:
        port_ref = port_ref[real]
    np.testing.assert_array_equal(port_ref, got)


def test_latent_kernel_requires_a_softmax_scale():
    t = [_to_torch(a) for a in _latent_inputs(0, 2, 0, "none", "fp32")]
    with pytest.raises(ValueError, match="softmax_scale"):
        tpa.paged_attention_latent(t[0], t[1], t[2], t[3], t[5], t[6], t[4])


def test_dequantize_latent_pages_matches_jax():
    ins = _latent_inputs(4, 2, 0, "int8", "fp32")
    want = jpa.dequantize_latent_pages(ins[2], ins[7])
    got = tpa.dequantize_latent_pages(_to_torch(ins[2]), _to_torch(ins[7]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# rope, params, pools, writers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos", ["rope", "yarn"])
def test_rope_tables_cover_the_decoupled_heads(pos):
    over = {} if pos == "rope" else dict(
        position_embedding="yarn", rope_scaling_factor=4.0,
        yarn_original_max_position=32)
    jc, tc = mla_pair(**over)
    jcos, jsin = j_tables(jc, 40)
    tcos, tsin = t_tables(tc, 40)
    assert tuple(tcos.shape) == (40, 4)         # qk_pos_emb_head_dim / 2
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)


@pytest.mark.parametrize("q_lora_rank", [None, 24])
def test_param_leaves_and_count_match_jax(q_lora_rank):
    jc, tc = mla_pair(q_lora_rank=q_lora_rank)
    jp, _ = j_init(jax.random.PRNGKey(0), jc)
    tp = t_init(tc, torch.Generator().manual_seed(0), "cpu")
    want = {k: tuple(v.shape[1:]) for k, v in jp["block"]["attention"].items()}
    got = {k: tuple(v.shape) for k, v in
           tp["layers"][0]["attention"].named_parameters()}
    assert got == want
    assert ("q_proj" in got) == (q_lora_rank is None)
    assert tc.attention_parameters() == sum(
        t.numel() for t in tp["layers"][0]["attention"].parameters())


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_latent_pools_match_jax(kind):
    """Pool and scale-pool shapes, bytes, and a copy-on-write of a full
    prefix hit that copies quantized rows and their scales verbatim."""
    jc, tc = mla_pair()
    jc = dataclasses.replace(jc, compute_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, compute_dtype=torch.bfloat16)
    jpool = jpc.PagedKVCache(jc, 2, 32, block_size=4, kv_cache_dtype=kind)
    pool = tpc.PagedKVCache(tc, 2, 32, block_size=4, kv_cache_dtype=kind)
    assert [tuple(p.shape) for p in pool.pages] == [
        tuple(p.shape) for p in jpool.pages] == [(2, 16, 4, 32),
                                                 (2, 16, 4, 8)]
    assert pool.bytes_total == jpool.bytes_total
    if kind == "bf16":
        assert pool.scales is None and pool.pages[0].dtype == torch.bfloat16
        return
    assert [tuple(s.shape) for s in pool.scales] == [(2, 16, 4)] * 2
    assert pool.pages[0].dtype == KINDS[kind][1]
    toks = np.arange(8, dtype=np.int32)
    plan = pool.admit(0, toks)
    rng = np.random.default_rng(1)
    for pages, scales in zip(pool.pages, pool.scales):
        q, s = tpa.quantize_kv_rows(torch.from_numpy(rng.normal(
            size=tuple(pages.shape)).astype(np.float32)), pages.dtype)
        tpa.storage_view(pages).copy_(tpa.storage_view(q))
        scales.copy_(s)
    pool.release(0, toks, 8)
    hit = pool.admit(1, toks)
    assert hit.cow and hit.cached_tokens == 7
    src, dst = plan.blocks[-1], hit.blocks[-1]
    for t in pool.pages + pool.scales:
        assert torch.equal(tpa.storage_view(t)[:, dst],
                           tpa.storage_view(t)[:, src])
    pool.audit()


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_kv_rows_on_latent_rows_matches_jax_bytes(kind):
    """quantize_kv_rows over a latent row's trailing dim: one scale a row,
    the JAX package's bytes."""
    rows = np.random.default_rng(2).normal(size=(3, 5, 32)).astype(
        np.float32) * 4
    jqv, js = jpa.quantize_kv_rows(jnp.asarray(rows), dtype=KINDS[kind][0])
    tqv, ts = tpa.quantize_kv_rows(torch.from_numpy(rows), KINDS[kind][1])
    assert tuple(ts.shape) == (3, 5)
    np.testing.assert_array_equal(
        tqv.view(torch.uint8).numpy(), np.asarray(jqv).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kind", ["none", "int8"])
def test_write_kv_takes_latent_rows(kind):
    """write_kv (the GQA pools' writer) scatters latent and roped-key rows
    [B, S, d] and their per-row scales [B, S] as JAX's append_chunk_pages
    does, padding rows and inactive slots dropped."""
    rng = np.random.default_rng(3)
    b, s, nb, bs = 3, 5, 13, 4
    table = (1 + rng.permutation(12)).reshape(3, 4).astype(np.int32)
    starts = np.asarray([2, 0, 6], np.int32)
    counts = np.asarray([5, 3, 2], np.int32)
    active = np.asarray([True, True, False])
    lat, pe = (rng.normal(size=(b, s, d)).astype(np.float32)
               for d in (32, 8))
    pools = [np.zeros((nb, bs, d), np.float32) for d in (32, 8)]
    scales = None
    if kind == "int8":
        pools = [np.zeros((nb, bs, d), np.int8) for d in (32, 8)]
        scales = [np.ones((nb, bs), np.float32) for _ in range(2)]
    t_pools = tuple(torch.from_numpy(p.copy()) for p in pools)
    t_scales = (None if scales is None
                else tuple(torch.from_numpy(x.copy()) for x in scales))
    index = tpa.paged_write_index(
        torch.from_numpy(table), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(active), bs, s)
    tpa.write_kv(t_pools, t_scales, torch.from_numpy(lat),
                 torch.from_numpy(pe), index)
    args = (jnp.asarray(table), jnp.asarray(starts), jnp.asarray(counts),
            jnp.asarray(active))
    rows = [jnp.asarray(lat), jnp.asarray(pe)]
    want = []
    for i, pool in enumerate(pools):
        if kind == "int8":
            q, sc = jpa.quantize_kv_rows(rows[i])
            want.append(jpa.append_chunk_pages(jnp.asarray(pool), q, *args))
            want.append(jpa.append_chunk_pages(jnp.asarray(scales[i]), sc,
                                               *args))
        else:
            want.append(jpa.append_chunk_pages(jnp.asarray(pool), rows[i],
                                               *args))
    got = [t_pools[0]] + ([t_scales[0]] if scales else []) + [t_pools[1]] \
        + ([t_scales[1]] if scales else [])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_mla_tree(jc, seed=0):
    params, _ = j_init(jax.random.PRNGKey(seed), jc)
    return jax.tree.map(np.asarray, params)


def test_convert_places_mla_leaves_and_refuses_others():
    jc, tc = mla_pair(q_lora_rank=24)
    t = _jax_mla_tree(jc)
    p = params_from_jax(t, tc)
    a = p["layers"][1]["attention"]
    np.testing.assert_array_equal(a["q_up"].numpy(),
                                  t["block"]["attention"]["q_up"][1])
    bad = jax.tree.map(lambda x: x, t)
    bad["block"]["attention"]["q_kernel"] = np.zeros((2, 64, 64), np.float32)
    with pytest.raises(KeyError, match="unknown leaf"):
        params_from_jax(bad, tc)
    bad = jax.tree.map(lambda x: x, t)
    bad["block"]["attention"]["q_up"] = {
        "qint8": np.zeros((2, 24, 96), np.int8),
        "qscale": np.ones((2, 1, 96), np.float32)}
    with pytest.raises(KeyError, match="unknown leaf"):
        params_from_jax(bad, tc)


def test_ptq_of_an_mla_tree_matches_jax_bytes():
    """quantize_for_serving on an MLA tree: out_kernel and the MLP go
    resident int8 with JAX's bytes; the q/kv path stays as it is (JAX's
    name-gated RESIDENT_KERNELS leave it)."""
    jc, tc = mla_pair()
    t = _jax_mla_tree(jc)
    jqt = jq.residentize_params(jq.quantize_params(t, resident_only=True)[0])
    tp = tq.quantize_for_serving(params_from_jax(t, tc))[0]
    ja, ta = jqt["block"]["attention"], tp["layers"][1]["attention"]
    for name in ("out_kernel",):
        assert tq.is_resident_leaf(ta[name])
        np.testing.assert_array_equal(ta[name]["qint8"].numpy(),
                                      np.asarray(ja[name]["qint8"])[1])
        np.testing.assert_array_equal(ta[name]["qscale"].numpy(),
                                      np.asarray(ja[name]["qscale"])[1])
    for name in ("q_proj", "kv_down", "kv_up"):
        assert not tq.is_resident_leaf(ta[name])
        np.testing.assert_array_equal(ta[name].numpy(),
                                      np.asarray(ja[name])[1])
    fc1 = tp["layers"][1]["mlp"]["fc1_kernel"]
    np.testing.assert_array_equal(
        fc1["qint8"].numpy(),
        np.asarray(jqt["block"]["mlp"]["fc1_kernel"]["qint8"])[1])


# ---------------------------------------------------------------------------
# one MLA layer: paged decode and ragged, and the dense branch
# ---------------------------------------------------------------------------


def _rope_at(jc, tc, pos):
    jcos, jsin = j_tables(jc, 64)
    tcos, tsin = t_tables(tc, 64)
    idx = torch.from_numpy(pos).long()
    return (jcos[pos], jsin[pos]), (tcos[idx], tsin[idx])


LAYER_CASES = [(mode, kind, q) for mode in ("decode", "ragged")
               for kind in ("none", "int8", "fp8")
               for q in ("q_proj", "q_lora")]


@pytest.mark.parametrize("mode,kind,q", LAYER_CASES,
                         ids=["-".join(c) for c in LAYER_CASES])
def test_mla_layer_matches_jax(mode, kind, q):
    """One paged MLA layer (fp32): decode (one token a slot, one slot
    inactive) and ragged (chunk rows with padding), the output and the
    written pools (quantized: the dequantized rows)."""
    over = dict(q_lora_rank=24 if q == "q_lora" else None)
    if kind == "none":
        over.update(position_embedding="yarn", rope_scaling_factor=4.0,
                    yarn_original_max_position=32)
    jc, tc = mla_pair(**over)
    p = random_layer(tc, 5)
    ragged = mode == "ragged"
    b, s, bs, mb = 3, (5 if ragged else 1), 4, 6
    nb = b * mb + 1
    rng = np.random.default_rng(6)
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    x = rng.normal(size=(b, s, tc.hidden_size)).astype(np.float32)
    starts = np.asarray([3, 9, 0], np.int32)
    counts = np.asarray([5, 2, 4], np.int32) if ragged else None
    active = np.asarray([True, True, ragged])
    pos = np.minimum(starts[:, None] + np.arange(s)[None, :], 63)
    (jcos, jsin), (tcos, tsin) = _rope_at(jc, tc, pos)
    pools = [rng.normal(size=(nb, bs, d)).astype(np.float32)
             for d in (32, 8)]
    scales = None
    if kind != "none":
        qs = [jpa.quantize_kv_rows(jnp.asarray(pl), dtype=KINDS[kind][0])
              for pl in pools]
        pools = [np.asarray(q_) for q_, _ in qs]
        scales = [np.asarray(s_) for _, s_ in qs]
    (j_out, j_cache), _ = j_layer(
        _jtree(p), jnp.asarray(x), jc, jcos, jsin, None,
        kv_cache=tuple(jnp.asarray(pl) for pl in pools),
        cache_positions=jnp.asarray(starts), page_table=jnp.asarray(table),
        active=jnp.asarray(active),
        chunk_counts=None if counts is None else jnp.asarray(counts),
        kv_scales=None if scales is None else tuple(
            jnp.asarray(sc) for sc in scales))
    t_pools = tuple(_to_torch(pl) for pl in pools)
    t_scales = (None if scales is None
                else tuple(torch.from_numpy(sc.copy()) for sc in scales))
    index = tpa.paged_write_index(
        torch.from_numpy(table), torch.from_numpy(starts),
        torch.from_numpy(np.full(b, s, np.int32) if counts is None
                         else counts), torch.from_numpy(active), bs, s)
    (t_out, t_cache), _ = t_layer(
        tree(p), torch.from_numpy(x), tc, tcos, tsin, kv_cache=t_pools,
        cache_positions=torch.from_numpy(starts),
        page_table=torch.from_numpy(table),
        chunk_counts=None if counts is None else torch.from_numpy(counts),
        write_index=index, kv_scales=t_scales)
    assert t_cache[0] is t_pools[0] and t_cache[1] is t_pools[1]
    out_j, out_t = np.asarray(j_out), t_out.numpy()
    keep = (np.arange(s)[None, :] < counts[:, None]) if ragged else active
    assert_close(out_t[keep], out_j[keep])
    for i in range(2):
        got, want = t_cache[i], np.asarray(j_cache[i])
        if scales is not None:
            got = tpa.dequantize_latent_pages(got, t_cache[2 + i])
            want = np.asarray(jpa.dequantize_latent_pages(
                j_cache[i], j_cache[2 + i]))
            # A row quantizes from values 1e-6 apart: at most one step of
            # its scale apart.
            step = np.asarray(j_cache[2 + i])[..., None]
            assert np.all(np.abs(got.numpy() - want) <= step * 1.01)
            continue
        assert_close(got.numpy(), want)


@pytest.mark.parametrize("pos", ["rope", "yarn"])
def test_dense_mla_layer_matches_jax(pos):
    """The no-cache branch (the dense greedy oracle of JAX's tests)."""
    over = {} if pos == "rope" else dict(
        position_embedding="yarn", rope_scaling_factor=4.0,
        yarn_original_max_position=32)
    jc, tc = mla_pair(q_lora_rank=24, **over)
    p = random_layer(tc, 8)
    x = np.random.default_rng(9).normal(size=(2, 7, 64)).astype(np.float32)
    jcos, jsin = j_tables(jc, 7)
    tcos, tsin = t_tables(tc, 7)
    (j_out, _), _ = j_layer(_jtree(p), jnp.asarray(x), jc, jcos, jsin)
    (t_out, cache), _ = t_layer(tree(p), torch.from_numpy(x), tc, tcos,
                                tsin)
    assert cache is None
    assert_close(t_out.numpy(), np.asarray(j_out))


def test_lora_on_an_mla_layer_raises():
    _, tc = mla_pair()
    p = tree(random_layer(tc, 1))
    with pytest.raises(ValueError, match="no q_kernel/kv_kernel"):
        t_layer(p, torch.zeros(1, 1, 64), tc, lora={})


# ---------------------------------------------------------------------------
# row 11's plain version against JAX's fused MLA prologue
# ---------------------------------------------------------------------------


PROLOGUE_CASES = [(q, pos, dtype) for q in ("q_proj", "q_lora")
                  for pos in ("rope", "yarn") for dtype in ("fp32", "bf16")]


@pytest.mark.parametrize("q,pos,dtype", PROLOGUE_CASES,
                         ids=["-".join(c) for c in PROLOGUE_CASES])
def test_fused_mla_prologue_plain_matches_jax(q, pos, dtype):
    """fused_mla_qkv's plain version against JAX's _fused_mla_qkv (interpret
    mode) on 5 rows with per-row rope tables. fp32: q_lat, q_pe, latent,
    k_pe within 1e-5 of their largest element. bf16: q_pe, latent and k_pe
    within one bf16 ulp of each element (the same rounding points); XLA
    keeps excess precision where the interpreted body rounds q_nope to
    bf16 (tests/test_torch_fused_decode.py says more), and the absorption
    carries those one-ulp differences on, so q_lat is held within one ulp
    of each element plus four ulps of its (row, head)'s RMS, as fc1 is
    there; on the q_lora path q_pe too, since q_up carries the excess
    precision of the normed q_down product."""
    from test_torch_fused_decode import _within_bf16_ulps
    from megatronapp_tpu_torch.ops.cuda import fused_mla
    over = dict(q_lora_rank=24 if q == "q_lora" else None)
    if pos == "yarn":
        over.update(position_embedding="yarn", rope_scaling_factor=4.0,
                    yarn_original_max_position=32)
    jc, tc = mla_pair(**over)
    if dtype == "bf16":
        jc = dataclasses.replace(jc, compute_dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, compute_dtype=torch.bfloat16)
    p = random_layer(tc, 12)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    pos_ids = rng.integers(0, 60, 5)
    jcos, jsin = j_tables(jc, 64)
    tcos, tsin = t_tables(tc, 64)
    jp = _jtree(p)
    attn = {**jp["attention"], "ln1_scale": jp["ln1_scale"]}
    jx = jnp.asarray(x, jc.compute_dtype)
    want = jkg._fused_mla_qkv(jx, attn, jc, jcos[pos_ids], jsin[pos_ids])
    tx = torch.from_numpy(x).to(tc.compute_dtype)
    idx = torch.from_numpy(pos_ids).long()
    got = fused_mla.fused_mla_qkv(tx, tree(p), tc, tcos[idx], tsin[idx])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == tc.compute_dtype and tuple(g.shape) == w.shape
        if dtype == "fp32":
            assert_close(g.numpy(), np.asarray(w))
        else:
            carried = i == 0 or (i == 1 and q == "q_lora")
            rows = g.reshape(-1, g.shape[-1])
            _within_bf16_ulps(rows, np.asarray(w, np.float32).reshape(
                rows.shape), 4 if carried else 0)
