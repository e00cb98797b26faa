"""The port's batched-LoRA modules against the JAX package's.

- ``AdapterCache``: the same acquire/release sequence through both caches
  gives the same slots, hits, misses, evictions, pinned raises and audits,
  and the same bank contents;
- ``.npz`` adapters load bit for bit in the other package, plain and
  PTQ-int8;
- ``lora_segment_info`` equals JAX's; ``LoraRows`` groups rows as it says;
- ``lora_delta_plain`` against JAX's ``lora_delta_reference`` and its
  segmented Pallas kernel in interpret mode (as tests/test_lora.py runs
  it), fp32 rtol 1e-5 / atol 1e-6, over ranks {1, 4, 8}, three (din,
  dout) and the four id mixes of tests/test_lora.py;
- the four fused plain versions with ``lora=`` against JAX's
  ``_fused_qkv`` / ``_fused_out_proj`` / ``_fused_mlp`` with ``lora=`` at
  no-grid shapes: fp32 rtol 1e-5 / atol 1e-6, bf16 one ulp (the bf16 MLP
  runs JAX's activation at the port's rounding points, as
  tests/test_torch_fused_decode.py argues);
- the ineligible reasons are named.

Inputs are made with numpy from seeds and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_decode import (
    _bf16, _close, _jattn, _layer0, _port_rounding_activation, _weights,
    _within_bf16_ulps,
)
from test_torch_layers import LLAMA_SMALL, cfg_pair

from megatronapp_tpu.inference import lora as jl
from megatronapp_tpu.ops.pallas import kernel_gen as kg
from megatronapp_tpu_torch.inference import lora as tl
from megatronapp_tpu_torch.models.convert import adapter_from_jax
from megatronapp_tpu_torch.ops import fused_decode as fd
from megatronapp_tpu_torch.ops import lora as tlo
from megatronapp_tpu_torch.ops.cuda import fused_decode as cuda_fd
from megatronapp_tpu_torch.utils import chaos

RTOL, ATOL = 1e-5, 1e-6
RANK = 4


@pytest.fixture(scope="module")
def cfgs():
    return cfg_pair(**LLAMA_SMALL)


def _adapters(jc, ids, rank=RANK, zero_b=False):
    return [jl.LoraAdapter.random(a, jc, rank=rank, seed=10 + i,
                                  zero_b=zero_b)
            for i, a in enumerate(ids)]


def _caches(jc, tc, ids, max_resident=2):
    jreg, treg = jl.AdapterRegistry(), tl.AdapterRegistry()
    for ad in _adapters(jc, ids):
        jreg.register(ad)
        treg.register(adapter_from_jax(ad))
    return (jl.AdapterCache(jc, jreg, max_resident=max_resident, rank=RANK),
            tl.AdapterCache(tc, treg, max_resident=max_resident, rank=RANK,
                            device="cpu"))


def _same_books(jcache, tcache):
    jcache.audit()
    tcache.audit()
    js, ts = jcache.stats_snapshot(), tcache.stats_snapshot()
    assert ts == js
    assert list(tcache._free) == list(jcache._free)
    assert list(tcache._lru) == list(jcache._lru)
    for t in tl.LORA_TARGETS:
        for j, g in zip(jcache.banks[t], tcache.banks[t]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))


# (op, adapter id or the index of an earlier acquire's slot to release)
SEQUENCES = {
    "hit_miss_null": [("acq", None), ("acq", "a"), ("acq", "a"),
                      ("rel", 1), ("rel", 2), ("rel", 0)],
    "lru_evicts_least_recent": [("acq", "a"), ("acq", "b"), ("rel", 0),
                                ("rel", 1), ("acq", "c"), ("acq", "b"),
                                ("rel", 4), ("acq", "a"), ("rel", 5),
                                ("rel", 7)],
    "all_pinned_then_retire": [("acq", "a"), ("acq", "b"), ("acq", "c"),
                               ("rel", 0), ("acq", "c"), ("rel", 1),
                               ("rel", 4)],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_adapter_cache_books_match_jax(cfgs, seq):
    jc, tc = cfgs
    jcache, tcache = _caches(jc, tc, ["a", "b", "c"])
    slots = []
    for op, arg in SEQUENCES[seq]:
        if op == "acq":
            got = []
            for cache in (jcache, tcache):
                try:
                    got.append(cache.acquire(arg))
                except (jl.AdapterSlotsPinned, tl.AdapterSlotsPinned) as e:
                    got.append(type(e).__name__)
            assert got[0] == got[1], (op, arg, got)
            slots.append(got[0])
        else:
            jcache.release(slots[arg])
            tcache.release(slots[arg])
            slots.append(None)
        _same_books(jcache, tcache)
    if seq == "all_pinned_then_retire":
        assert "AdapterSlotsPinned" in slots
    if seq == "lru_evicts_least_recent":
        assert tcache.stats["evictions"] == 2


def test_adapter_cache_rejects_rank_and_fault_keeps_books(cfgs):
    jc, tc = cfgs
    _, tcache = _caches(jc, tc, ["a", "b"])
    fat = tl.LoraAdapter.random("fat", tc, rank=8, seed=1)
    tcache.registry.register(fat)
    with pytest.raises(ValueError, match="rank"):
        tcache.acquire("fat")
    sa = tcache.acquire("a")
    before = (list(tcache._free), dict(tcache._table),
              tcache._refcount.copy())
    chaos.arm("lora-load")
    try:
        with pytest.raises(chaos.ChaosFault):
            tcache.acquire("b")
    finally:
        chaos.disarm()
    assert (list(tcache._free), dict(tcache._table)) == before[:2]
    assert (tcache._refcount == before[2]).all()
    assert tcache.stats["load_faults"] == 1
    tcache.audit()
    assert tcache.acquire("b") not in (0, sa)
    tcache.audit()


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_round_trip_across_packages(cfgs, tmp_path, quantize, writer):
    jc, tc = cfgs
    jad = jl.LoraAdapter.random("t0", jc, rank=RANK, seed=3)
    tad = adapter_from_jax(jad)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jad.save(jdir, quantize=quantize)
    tad.save(tdir, quantize=quantize)
    with np.load(f"{jdir}/t0.npz") as zj, np.load(f"{tdir}/t0.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k])
    src = jdir if writer == "jax" else tdir
    jback = jl.LoraAdapter.load(src, "t0")
    tback = tl.LoraAdapter.load(src, "t0")
    assert tback.rank == jback.rank == RANK
    for t in tl.LORA_TARGETS:
        for side in ("a", "b"):
            want = np.asarray(getattr(jback, side)[t])
            got = getattr(tback, side)[t]
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    if not quantize:
        np.testing.assert_array_equal(tback.b["fc1_kernel"],
                                      np.asarray(jad.b["fc1_kernel"]))
    assert tl.AdapterRegistry(src).ids() == ["t0"]


def test_target_dims_and_bytes_match_jax(cfgs):
    jc, tc = cfgs
    assert tl.lora_target_dims(tc) == jl.lora_target_dims(jc)
    assert tl.adapter_nbytes(tc, 8) == jl.adapter_nbytes(jc, 8)
    ad = tl.LoraAdapter.random("x", tc, rank=RANK, seed=5)
    jad = jl.LoraAdapter.random("x", jc, rank=RANK, seed=5)
    assert ad.nbytes == jad.nbytes == tl.adapter_nbytes(tc, RANK)
    for t in tl.LORA_TARGETS:
        np.testing.assert_array_equal(ad.a[t], np.asarray(jad.a[t]))


ID_MIXES = {
    "all_null": [0] * 8,
    "one_adapter": [1] * 8,
    "mixed_with_null": [1, 1, 2, 3, 4, 2, 0, 1],
    "random": None,
}


@pytest.mark.parametrize("row", [[2, 2, 0, 1, 2, 1, 0, 3], [0] * 5,
                                 [4, 3, 2, 1], [7]])
def test_segment_info_matches_jax(row):
    want = [np.asarray(a) for a in kg.lora_segment_info(
        jnp.asarray(row, jnp.int32))]
    got = tlo.lora_segment_info(np.asarray(row))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == int(want[2])
    segs = tlo.LoraRows(row, "cpu")
    order, off = segs.order.tolist(), segs.seg_off.tolist()
    assert sorted(order) == list(range(len(row))) and off[-1] == len(row)
    for s, slot in enumerate(segs.seg_slot.tolist()):
        assert all(row[r] == slot for r in order[off[s]:off[s + 1]])
    assert segs.seg_slot.tolist() == [int(a) for a in want[0][:got[2]]]
    np.testing.assert_array_equal(
        tlo.LoraRows(row, "cpu", repeat=3).ids.numpy(), np.repeat(row, 3))


@pytest.mark.parametrize("rank", [1, 4, 8])
@pytest.mark.parametrize("din,dout", [(64, 64), (64, 32), (64, 256)])
def test_lora_delta_plain_matches_jax(rank, din, dout):
    rng = np.random.default_rng(rank * 1000 + dout)
    slots, rows = 5, 8
    x = rng.standard_normal((rows, din)).astype(np.float32)
    a = (rng.standard_normal((slots, din, rank)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((slots, rank, dout)) * 0.1).astype(np.float32)
    assert kg.lora_kernel_ineligible_reason(din, dout, rank, rows) is None
    for name, row in ID_MIXES.items():
        row = list(rng.integers(0, slots, rows)) if row is None else row
        ra = jnp.asarray(row, jnp.int32)
        ref = kg.lora_delta_reference(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(b), ra)
        seg = kg.lora_segmented_delta(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(b), ra)
        tx, ta, tb = map(torch.from_numpy, (x, a, b))
        got = tlo.lora_delta_plain(tx, ta, tb, torch.tensor(row))
        assert got.dtype == torch.float32
        for want in (ref, seg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        # The dispatcher on CPU tensors is the plain version, rows grouped
        # on the host.
        assert torch.equal(tlo.lora_delta(tx, ta, tb, np.asarray(row)), got)


def _lora_pair(tc, seed, rows=5, slots=4, rank=RANK, ids=(1, 0, 2, 1, 3)):
    """The same adapter banks as the port's lora dict (banks, LoraRows)
    and JAX's gathered per-row factor tuples (qkv, out, mlp)."""
    rng = np.random.default_rng(seed)
    banks = {}
    for t, (din, dout) in tl.lora_target_dims(tc).items():
        banks[t] = ((rng.standard_normal((slots, din, rank))
                     / np.sqrt(din)).astype(np.float32),
                    (rng.standard_normal((slots, rank, dout)) * 0.5
                     ).astype(np.float32))
        banks[t][0][0] = banks[t][1][0] = 0.0          # the NULL slot
    ids = np.asarray(ids[:rows], np.int32)
    port = {"row_adapter": tlo.LoraRows(ids, "cpu"),
            "banks": {t: tuple(torch.from_numpy(x) for x in v)
                      for t, v in banks.items()}}
    g = {t: tuple(jnp.asarray(x[ids]) for x in v) for t, v in banks.items()}
    jax_lora = ((*g["q_kernel"], *g["kv_kernel"]), g["out_kernel"],
                (*g["fc1_kernel"], *g["fc2_kernel"]))
    return port, jax_lora


def _run_lora_function(fn, bf16):
    jc, tc, jp, tp = _weights("llama", init_std=0.02)
    if bf16:
        jc, tc = _bf16(jc, tc)
    adt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                             None)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(5, tc.hidden_size)).astype(np.float32)
    attn = rng.normal(size=(5, tc.num_attention_heads * tc.head_dim)
                      ).astype(np.float32)
    cos = rng.normal(size=(5, tc.head_dim // 2)).astype(np.float32)
    sin = rng.normal(size=(5, tc.head_dim // 2)).astype(np.float32)
    p0, t0 = _layer0(jp), tp["layers"][0]
    port, (jq, jo, jm) = _lora_pair(tc, 11)
    xt = torch.from_numpy(x) if tdt is None else torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x, adt)
    if fn == "qkv":
        want = kg._fused_qkv(xj, _jattn(p0), jc, jnp.asarray(cos),
                             jnp.asarray(sin), lora=jq)
        got = fd.fused_qkv(xt, t0, tc, torch.from_numpy(cos),
                           torch.from_numpy(sin), port)
        base = fd.fused_qkv(xt, t0, tc, torch.from_numpy(cos),
                            torch.from_numpy(sin))
        return list(zip(got, want)), list(zip(got, base))
    if fn == "out_proj":
        at = torch.from_numpy(attn)
        at = at if tdt is None else at.to(tdt)
        want = kg._fused_out_proj(jnp.asarray(attn, adt), _jattn(p0), jc, xj,
                                  lora=jo)
        got = fd.fused_out_proj(at, t0, tc, xt, port)
        return [(got, want)], [(got, fd.fused_out_proj(at, t0, tc, xt))]
    got = fd.fused_mlp(xt, t0, tc, port)
    assert torch.equal(got, fd.fused_mlp_plain(xt, t0, tc, port))
    return ([(got, kg._fused_mlp(xj, p0, jc, lora=jm))],
            [(got, fd.fused_mlp(xt, t0, tc))])


@pytest.mark.parametrize("fn", ["qkv", "out_proj", "mlp"])
def test_fused_plain_versions_with_lora_match_jax_fp32(fn):
    pairs, base = _run_lora_function(fn, bf16=False)
    for got, want in pairs:
        _close(got, want)
    # The adapters move the outputs (rows 0, 2, 3, 4 carry one).
    for got, b in base:
        assert not torch.equal(got, b)


@pytest.mark.parametrize("fn", ["qkv", "out_proj", "mlp"])
def test_fused_plain_versions_with_lora_match_jax_bf16(fn, monkeypatch):
    from megatronapp_tpu.ops import activations as jact
    monkeypatch.setattr(jact, "apply_activation", _port_rounding_activation)
    pairs, _ = _run_lora_function(fn, bf16=True)
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        _within_bf16_ulps(got, want, 4 if fn == "mlp" else 0)


def test_null_rows_leave_fused_outputs_unchanged():
    """A row on the NULL slot gets an exact +0.0 from every epilogue: its
    outputs equal the no-adapter function's bits."""
    _, tc, _, tp = _weights("llama", init_std=0.02)
    t0 = tp["layers"][0]
    port, _ = _lora_pair(tc, 12, ids=(0, 2, 0, 1, 0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(5, tc.hidden_size)).astype(np.float32))
    null = torch.tensor([True, False, True, False, True])
    with_lora = fd.fused_mlp(x, t0, tc, port)
    without = fd.fused_mlp(x, t0, tc)
    assert torch.equal(with_lora[null], without[null])
    assert not torch.equal(with_lora[~null], without[~null])


def test_ineligible_reasons_are_named(cfgs):
    assert "rank" in tlo.lora_kernel_ineligible_reason(16, 16, 32, 4)
    assert kg.lora_kernel_ineligible_reason(16, 16, 32, 4) is not None
    assert "1..32" in tlo.lora_kernel_ineligible_reason(4096, 4096, 33, 8)
    assert "bank dtype" in tlo.lora_kernel_ineligible_reason(
        64, 64, 8, 8, bank_dtype=torch.bfloat16)
    assert "bf16" in tlo.lora_kernel_ineligible_reason(
        64, 64, 8, 8, x_dtype=torch.float32)
    assert tlo.lora_kernel_ineligible_reason(4096, 28672, 16, 32) is None
    from megatronapp_tpu_torch.models.presets import llama3_8b
    cfg = llama3_8b(num_layers=1, params_dtype=torch.bfloat16)
    assert fd.megakernel_ineligible_reason(cfg, batch=8, device="cuda",
                                           lora_rank=8) is None
    why = fd.megakernel_ineligible_reason(cfg, batch=8, device="cuda",
                                          lora_rank=64)
    assert "LoRA epilogue" in why and "1..32" in why
    mla = llama3_8b(num_layers=1, multi_latent_attention=True)
    why = fd.megakernel_ineligible_reason(mla, batch=8, lora_rank=8)
    assert "MLA megakernel has no q_kernel/kv_kernel" in why
    with pytest.raises(ValueError, match="latent"):
        tl.lora_target_dims(mla)


def test_lora_tensors_off_the_cpu_never_reach_the_plain_versions(
        monkeypatch):
    """A meta tensor goes to the kernel path, which raises, instead of the
    plain version; device-resident row ids are refused (grouping them
    would wait on the card)."""
    def no_plain(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(tlo, "lora_delta_plain", no_plain)
    monkeypatch.setattr(cuda_fd, "fused_out_proj_plain", no_plain)
    x = torch.empty(4, 64, dtype=torch.bfloat16, device="meta")
    bank = torch.empty(3, 64, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlo.lora_delta(x, bank, bank, np.zeros(4, np.int32))
    with pytest.raises(TypeError, match="host"):
        tlo.as_lora_rows(torch.zeros(4, dtype=torch.int32, device="meta"),
                         "meta")
    _, tc, _, tp = _weights("llama", init_std=0.02)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fd.fused_out_proj(x, tp["layers"][0], tc, x,
                               {"row_adapter": None, "banks": {}})


def test_adapter_from_jax_keeps_the_factors(cfgs):
    jc, _ = cfgs
    jad = jl.LoraAdapter.random("z", jc, rank=2, seed=4, zero_b=True)
    tad = adapter_from_jax(jad)
    assert (tad.adapter_id, tad.rank) == ("z", 2)
    for t in tl.LORA_TARGETS:
        np.testing.assert_array_equal(tad.a[t], np.asarray(jad.a[t]))
        assert not tad.b[t].any()
