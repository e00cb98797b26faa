"""Resident int8 weights of the port against the JAX package.

- Startup PTQ: the port's ``quantize_params(resident_only=True)`` and
  ``residentize_params`` on converted weights give the same int8 bytes and
  bitwise the same fp32 scales as the JAX functions on the JAX tree (both
  compute absmax / 127, w / scale and round-half-even in fp32).
- ``resolve_param`` matches JAX's (int8 → fp32 × scale, then the cast);
  ``params_from_jax`` carries a resident JAX tree across, dtypes kept;
  ``ParamTree.to`` moves resident leaves; the fallback counter counts the
  bytes of leaves dequantized eagerly.
- The fused plain versions with resident weights against
  ``kernel_gen._fused_qkv``, ``_fused_out_proj``, ``_fused_mlp_fc1`` and
  ``_fused_mlp_fc2`` at one tile (interpret mode), with the tolerances of
  tests/test_torch_fused_decode.py: fp32 rtol 1e-5 / atol 1e-6, bf16 one
  ulp with the activation at the port's rounding points. The bf16
  dequantized weight, bf16(float(q) × scale), is no source of difference:
  JAX's fc1 on resident weights gives the same bits as on the weights
  dequantized to bf16 beforehand. What interpret mode does change is where
  the fc1 sums round: XLA keeps excess precision there, so a gate or value
  sum rounds one ulp the other way, and swiglu carries a gate's ulp on as
  up to three ulps of a small product. fc1 is therefore held within one
  ulp of each element plus eight ulps of its row's RMS (measured: eight
  for one element of the llama case, two with QK-layernorm; tests/
  test_torch_fused_decode.py allows four for the unquantized weights).
  fc2 is held on JAX's y, within one ulp.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_decode import (
    _bf16, _inputs, _jattn, _port_rounding_activation, _rope, _t,
    _within_bf16_ulps,
)
from test_torch_fused_decode import _weights as fused_weights

from megatronapp_tpu.inference import quantization as jq
from megatronapp_tpu.ops.pallas import kernel_gen as kg
from megatronapp_tpu_torch.inference import quantization as tq
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.ops import fused_decode as fd
from megatronapp_tpu_torch.utils import metrics as telemetry
from megatronapp_tpu_torch.utils.params import ParamTree

RTOL, ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _resident_pair(name, init_std=0.02):
    """(jax cfg, port cfg, JAX resident tree, port resident tree) from the
    same perturbed weights: JAX quantizes its tree, the port its
    converted copy."""
    jc, tc, jp, tp = fused_weights(name, init_std=init_std)
    jres = jq.residentize_params(jq.quantize_params(
        jax.tree.map(np.asarray, jp), resident_only=True)[0])
    return jc, tc, jres, tq.quantize_for_serving(tp)[0]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_ptq_matches_jax_bytes_and_scales(name):
    jc, tc, jres, tres = _resident_pair(name)
    for i, layer in enumerate(tres["layers"]):
        for sub, kernel in (("attention", "q_kernel"),
                            ("attention", "kv_kernel"),
                            ("attention", "out_kernel"),
                            ("mlp", "fc1_kernel"), ("mlp", "fc2_kernel")):
            got, want = layer[sub][kernel], jres["block"][sub][kernel]
            assert tq.is_resident_leaf(got) and jq.is_resident_leaf(want)
            assert got["qint8"].dtype == torch.int8
            assert got["qscale"].dtype == torch.float32
            np.testing.assert_array_equal(_np(got["qint8"]),
                                          np.asarray(want["qint8"])[i])
            np.testing.assert_array_equal(_np(got["qscale"]),
                                          np.asarray(want["qscale"])[i])
        # Norm scales and biases stay in the params dtype.
        assert isinstance(layer["ln1_scale"], torch.Tensor)
    # Embedding and head are not resident kernels: untouched.
    assert isinstance(tres["output"] if "output" in tres
                      else tres["embedding"]["word"], torch.Tensor)


def test_quantize_params_report_and_resident_only():
    _, tc, _, tp = fused_weights("llama")
    full, report = tq.quantize_params(tp)
    res, res_report = tq.quantize_params(tp, resident_only=True)
    assert set(res_report) == {f"layers/{i}/{s}/{k}"
                               for i in range(tc.num_layers)
                               for s, k in (("attention", "q_kernel"),
                                            ("attention", "kv_kernel"),
                                            ("attention", "out_kernel"),
                                            ("mlp", "fc1_kernel"),
                                            ("mlp", "fc2_kernel"))}
    assert set(res_report) <= set(report)
    # The error of one per-column quantum: at most half a scale.
    for path, err in res_report.items():
        assert 0 < err < 0.05, (path, err)
    leaf = res["layers"][0]["attention"]["q_kernel"]
    assert isinstance(leaf, tq.QuantizedLeaf)
    assert leaf.orig_dtype == torch.float32


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_resolve_param_matches_jax(dtype):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(2, 24, 40)).astype(np.float32)
    jleaf = jq.residentize_params(jq.quantize_params(
        {"x": {"fc1_kernel": w}}, resident_only=True)[0])["x"]["fc1_kernel"]
    tleaf = ParamTree({"qint8": torch.from_numpy(np.array(jleaf["qint8"])),
                       "qscale": torch.from_numpy(
                           np.array(jleaf["qscale"]))})
    jdt = None if dtype is None else jnp.bfloat16
    want = np.asarray(jnp.asarray(jq.resolve_param(jleaf, jdt), jnp.float32))
    got = tq.resolve_param(tleaf, dtype)
    assert got.dtype == (dtype or torch.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    plain = torch.from_numpy(w)
    assert tq.resolve_param(plain) is plain
    assert tq.resolve_param(plain, torch.bfloat16).dtype == torch.bfloat16


def test_params_from_jax_carries_a_resident_tree():
    """A residentized JAX tree converts leaf for leaf: int8 and fp32 slices
    per layer, never cast to params_dtype (bf16 here)."""
    import dataclasses
    _, tc, jres, tres = _resident_pair("llama")
    cfg = dataclasses.replace(tc, params_dtype=torch.bfloat16)
    conv = params_from_jax(jax.tree.map(np.asarray, jres), cfg)
    for got, want in zip(conv["layers"], tres["layers"]):
        for sub in ("attention", "mlp"):
            for k in ("q_kernel", "kv_kernel", "out_kernel", "fc1_kernel",
                      "fc2_kernel"):
                if k not in want[sub]:
                    continue
                g, w = got[sub][k], want[sub][k]
                assert tq.is_resident_leaf(g)
                assert g["qint8"].dtype == torch.int8
                assert g["qscale"].dtype == torch.float32
                assert torch.equal(g["qint8"], w["qint8"])
                assert torch.equal(g["qscale"], w["qscale"])
        assert got["ln1_scale"].dtype == torch.bfloat16
    assert tq.resident_nbytes(conv) < tq.resident_nbytes(tres)


def test_param_tree_to_moves_resident_leaves():
    import copy
    _, _, _, tres = _resident_pair("gpt2")
    moved = copy.deepcopy(tres).to("meta")          # .to moves in place
    leaf = moved["layers"][1]["mlp"]["fc2_kernel"]
    assert leaf["qint8"].device.type == "meta"
    assert leaf["qint8"].dtype == torch.int8
    assert leaf["qscale"].dtype == torch.float32
    assert not leaf["qint8"].requires_grad
    assert tq.resident_nbytes(moved) == tq.resident_nbytes(tres)


def test_fallback_counter_counts_eagerly_dequantized_bytes():
    """A quantized leaf without a resolve-aware consumer (here an lm_head)
    is dequantized eagerly; its bytes are counted and logged, as the JAX
    package's residentize_params does."""
    rng = np.random.default_rng(2)
    tree = ParamTree({"lm_head": torch.from_numpy(
        rng.normal(size=(16, 24)).astype(np.float32))},
        mlp=ParamTree({"fc1_kernel": torch.from_numpy(
            rng.normal(size=(16, 32)).astype(np.float32))}))
    telemetry.enable()
    try:
        out = tq.residentize_params(tq.quantize_params(tree)[0])
        assert telemetry.counter_value(
            "quantized_weights_dequantized_bytes") == 16 * 24 * 4
    finally:
        telemetry.disable()
    assert isinstance(out["lm_head"], torch.Tensor)
    assert tq.is_resident_leaf(out["mlp"]["fc1_kernel"])
    np.testing.assert_array_equal(
        out["lm_head"].numpy(),
        jq.dequantize_leaf(jq.quantize_leaf(tree["lm_head"].numpy())))


# ---------------------------------------------------------------------------
# the fused plain versions with resident weights against kernel_gen
# ---------------------------------------------------------------------------


def _layer0(jres):
    return jax.tree.map(lambda a: jnp.asarray(a)[0], jres["block"])


def _run_resident(fn, name, bf16):
    jc, tc, jres, tres = _resident_pair(name)
    if bf16:
        jc, tc = _bf16(jc, tc)
    adt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                             None)
    inp = _inputs(tc)
    p0, t0 = _layer0(jres), tres["layers"][0]
    x_j, x_t = jnp.asarray(inp["x"], adt), _t(inp["x"], tdt)
    cos, sin = _rope(name, inp)
    jcos = None if cos is None else jnp.asarray(inp["cos"])
    jsin = None if sin is None else jnp.asarray(inp["sin"])
    if fn == "qkv":
        want = kg._fused_qkv(x_j, _jattn(p0), jc, jcos, jsin, tiles=1)
        return list(zip(fd.fused_qkv(x_t, t0, tc, cos, sin), want))
    if fn == "out_proj":
        a_j, a_t = jnp.asarray(inp["attn"], adt), _t(inp["attn"], tdt)
        want = kg._fused_out_proj(a_j, _jattn(p0), jc, x_j, tiles=1)
        return [(fd.fused_out_proj(a_t, t0, tc, x_t), want)]
    y_j = kg._fused_mlp_fc1(x_j, p0, jc, 1)
    out_j = kg._fused_mlp_fc2(y_j, x_j, p0, jc, 1)
    y_t = fd.fused_mlp_fc1(x_t, t0, tc)
    out_t = fd.fused_mlp_fc2(_t(jnp.asarray(y_j, jnp.float32), tdt), x_t,
                             t0, tc)
    return [(y_t, y_j), (out_t, out_j)]


FNS = ["qkv", "out_proj", "mlp_fc1_fc2"]


@pytest.mark.parametrize("name", ["llama", "gpt2", "qk_layernorm"])
@pytest.mark.parametrize("fn", FNS)
def test_resident_fused_plain_versions_match_jax_fp32(fn, name):
    for got, want in _run_resident(fn, name, bf16=False):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["llama", "gpt2", "qk_layernorm"])
@pytest.mark.parametrize("fn", FNS)
def test_resident_fused_plain_versions_match_jax_bf16(fn, name,
                                                      monkeypatch):
    from megatronapp_tpu.ops import activations as jact
    monkeypatch.setattr(jact, "apply_activation", _port_rounding_activation)
    for i, (got, want) in enumerate(_run_resident(fn, name, bf16=True)):
        assert got.dtype == torch.bfloat16
        _within_bf16_ulps(got, want, 8 if fn == "mlp_fc1_fc2" and i == 0
                          else 0)


def test_resident_fused_mlp_is_the_unfused_resident_mlp():
    """With resident weights too, the fused MLP's plain versions give the
    unfused layer's bits on the CPU."""
    from megatronapp_tpu_torch.ops.normalization import apply_norm
    from megatronapp_tpu_torch.transformer.mlp import mlp_forward
    _, tc, _, tres = _resident_pair("llama")
    t0 = tres["layers"][0]
    x = _t(_inputs(tc)["x"])
    h = apply_norm(tc.normalization, x, t0["ln2_scale"], None,
                   tc.layernorm_epsilon)
    want = x + mlp_forward(t0["mlp"], h, tc).to(x.dtype)
    assert torch.equal(fd.fused_mlp(x, t0, tc), want)


def test_resident_weights_are_eligible_and_mixed_qkv_is_named():
    """On the card the fused kernels take resident int8 weights beside the
    params dtype's vectors; a q_kernel and kv_kernel of different kinds is
    named as the reason."""
    import dataclasses
    from megatronapp_tpu_torch.ops.cuda import fused_decode as cuda_fd
    _, tc, _, tres = _resident_pair("llama")
    cfg = dataclasses.replace(tc, compute_dtype=torch.bfloat16,
                              hidden_size=128, ffn_hidden_size=128,
                              num_attention_heads=2, num_query_groups=1,
                              kv_channels=128)
    layer = tres["layers"][0]
    assert cuda_fd.kernel_limits(cfg, layer) is None
    mixed = ParamTree({"ln1_scale": layer["ln1_scale"]},
                      attention=ParamTree(
                          {"kv_kernel": layer["attention"]["kv_kernel"][
                              "qint8"].float(),
                           "out_kernel": layer["attention"]["out_kernel"][
                               "qint8"].float()},
                          q_kernel=layer["attention"]["q_kernel"]),
                      mlp=layer["mlp"])
    assert "mixed QKV" in cuda_fd.kernel_limits(cfg, mixed)
    assert cuda_fd.weight_kind(layer["mlp"]["fc1_kernel"]) == torch.int8
