"""The port's fused (megakernel) decode step against the JAX package's.

The same weights (the JAX init with every leaf perturbed, carried across
by ``convert.params_from_jax``) and the same numpy inputs go through both
sides. The JAX fused functions run in Pallas interpret mode on the CPU, as
the JAX package's own tests run them; the port's wrappers run their plain
versions for CPU tensors.

Tolerances:
- fp32 compute: rtol 1e-5 / atol 1e-6 (matmul summation order only; the
  function tests draw their weights at init std 0.02 plus the 0.1
  perturbation, so that inputs and outputs are of order 1 at widths 64-128);
- bf16 compute: every element within one bf16 ulp of the JAX element (the
  same rounding points; a sum that lands near a rounding boundary may round
  the other way). The activation is the one op whose rounding points the
  two frameworks do not share: torch evaluates silu/gelu in fp32 and rounds
  the result, then rounds the gated product, while XLA evaluates the bf16
  chain at its own intermediate precision (on the same bf16 inputs the two
  differ by up to 2 ulp for swiglu and, where gelu's 1 + tanh cancels, by
  hundreds of ulp of tiny outputs). The bf16 MLP comparisons therefore run
  the JAX bodies with the activation at the port's rounding points
  (``_port_rounding_activation``, patched in for the test only); the fp32
  comparisons hold the activations themselves. XLA (interpret mode
  compiles a kernel body as one computation) also keeps excess precision
  where the body rounds to bf16, so about a third of fc1's gate and value
  sums round the other way, and the activation carries those one-ulp
  differences of its inputs on: fc1 and the composed MLP are held within
  one ulp of each element plus four ulps of the row's RMS (2^-5 of it;
  measured: at most two). fc2 is held on JAX's y;
- the layer bodies (attention over the pools included): 1e-4, the
  tolerance of tests/test_torch_layers.py's paged layer;
- engines: greedy streams token-exact, against the JAX fused engine and the
  port's unfused engine, across a preemption and a prefix-cache hit.

The port is held to JAX's no-grid ``_fused_mlp`` and to the
``_fused_mlp_fc1`` → ``_fused_mlp_fc2`` pair at an explicit tile count,
not bitwise to JAX's tiled MLP (whose own bitwise test against its no-grid
body is red on the JAX side).
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import ENGINE, MAX_NEW, _prompts, _synchronous
from test_torch_layers import GPT2_SMALL, LLAMA_SMALL, cfg_pair

from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu.models.gpt import init_gpt_params as j_init
from megatronapp_tpu.ops.pallas import kernel_gen as kg
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference.engine import SamplingParams
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.models.presets import llama3_8b
from megatronapp_tpu_torch.ops import fused_decode as fd
from megatronapp_tpu_torch.ops.cuda import fused_decode as cuda_fd
from megatronapp_tpu_torch.ops.paged_attention import paged_write_index

RTOL, ATOL = 1e-5, 1e-6
LAYER_TOL = 1e-4
ROWS = 5
CONFIGS = {
    "llama": LLAMA_SMALL,                        # RMSnorm, swiglu, rope, GQA
    "gpt2": GPT2_SMALL,                          # LayerNorm, gelu, biases, MHA
    "qk_layernorm": dict(LLAMA_SMALL, qk_layernorm=True),
}


@functools.lru_cache(maxsize=None)
def _weights(name, seed=0, init_std=0.4):
    """(jax cfg, port cfg, jax params, port params) with every leaf
    perturbed, so that unit scales and zero biases test nothing by
    accident. The engine and layer tests keep the configs' init std 0.4
    (a tiny init collapses greedy streams into attractors that hide KV
    faults)."""
    jc, tc = cfg_pair(**dict(CONFIGS[name], init_method_std=init_std))
    params, _ = j_init(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)
                   ).astype(np.float32), params)
    return (jc, tc, jax.tree.map(jnp.asarray, np_params),
            params_from_jax(np_params, tc, "cpu"))


def _bf16(jc, tc):
    return (dataclasses.replace(jc, compute_dtype=jnp.bfloat16),
            dataclasses.replace(tc, compute_dtype=torch.bfloat16))


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["block"])


def _jattn(p0):
    """The JAX fused QKV/out-proj parameter dict: the attention leaves
    with the layer's input norm merged in, as fused_layer_decode builds
    it."""
    return {**p0["attention"], "ln1_scale": p0["ln1_scale"],
            **({"ln1_bias": p0["ln1_bias"]} if "ln1_bias" in p0 else {})}


def _inputs(tc, dtype=np.float32, seed=3):
    rng = np.random.default_rng(seed)
    half = tc.head_dim // 2
    return {"x": rng.normal(size=(ROWS, tc.hidden_size)).astype(dtype),
            "cos": rng.normal(size=(ROWS, half)).astype(np.float32),
            "sin": rng.normal(size=(ROWS, half)).astype(np.float32),
            "attn": rng.normal(size=(ROWS, tc.num_attention_heads
                                     * tc.head_dim)).astype(dtype),
            }


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _ulp(a):
    """One bf16 ulp at |a|: 2^-7 of its binade."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _within_bf16_ulps(got, want, row_ulps=0):
    """Every element of the bf16 result `got` within one bf16 ulp (at the
    larger magnitude) of the JAX bf16 element, plus `row_ulps` ulps at the
    RMS of the element's row."""
    g = got.float().numpy().reshape(got.shape[0], -1)
    w = np.asarray(jnp.asarray(want, jnp.float32)).reshape(g.shape)
    ulp = _ulp(np.maximum(np.abs(g), np.abs(w)))
    rms = np.sqrt(np.mean(w * w, axis=1, keepdims=True))
    bad = np.abs(g - w) > ulp + row_ulps * _ulp(rms)
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} elements differ by more than one "
        f"bf16 ulp + {row_ulps} of the row RMS; worst "
        f"{float(np.max(np.abs(g - w) / ulp))} ulp")


def _port_rounding_activation(kind, x, gate=None):
    """The JAX activation at torch's rounding points: the activation in
    fp32 rounded once to bf16, then (gated) the product rounded once.
    reduce_precision keeps XLA from eliding the roundings."""
    def rnd(t):
        return jax.lax.reduce_precision(t, exponent_bits=8, mantissa_bits=7)

    def gelu(t):
        return jax.nn.gelu(t, approximate=True)

    fns = {"swiglu": jax.nn.silu, "geglu": gelu, "gelu": gelu,
           "relu": jax.nn.relu,
           "squared_relu": lambda t: jnp.square(jax.nn.relu(t))}
    fn, f32 = fns[kind.value], jnp.float32
    if gate is None:
        return rnd(fn(x.astype(f32))).astype(x.dtype)
    return rnd(rnd(fn(gate.astype(f32))) * x.astype(f32)).astype(x.dtype)


def _rope(name, inp):
    if name == "gpt2":           # learned absolute positions: no rope
        return None, None
    return _t(inp["cos"]), _t(inp["sin"])


# ---------------------------------------------------------------------------
# each fused function against the JAX function
# ---------------------------------------------------------------------------


def _run_function(fn, name, bf16):
    jc, tc, jp, tp = _weights(name, init_std=0.02)
    if bf16:
        jc, tc = _bf16(jc, tc)
    adt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                             None)
    inp = _inputs(tc)
    p0, t0 = _layer0(jp), tp["layers"][0]
    x_j, x_t = jnp.asarray(inp["x"], adt), _t(inp["x"], tdt)
    cos, sin = _rope(name, inp)
    jcos = None if cos is None else jnp.asarray(inp["cos"])
    jsin = None if sin is None else jnp.asarray(inp["sin"])
    if fn == "qkv":
        want = kg._fused_qkv(x_j, _jattn(p0), jc, jcos, jsin)
        got = fd.fused_qkv(x_t, t0, tc, cos, sin)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        return list(zip(got, want))
    if fn == "out_proj":
        a_j, a_t = jnp.asarray(inp["attn"], adt), _t(inp["attn"], tdt)
        want = kg._fused_out_proj(a_j, _jattn(p0), jc, x_j)
        return [(fd.fused_out_proj(a_t, t0, tc, x_t), want)]
    if fn == "mlp":
        return [(fd.fused_mlp(x_t, t0, tc), kg._fused_mlp(x_j, p0, jc))]
    # The fc1 → fc2 pair at an explicit tile count (2 ffn-column tiles,
    # 2 H-column tiles), the split the port's kernels realise; fc2 on
    # JAX's y, so that each function sees the same inputs.
    y_j = kg._fused_mlp_fc1(x_j, p0, jc, 2)
    y_t = fd.fused_mlp_fc1(x_t, t0, tc)
    out_j = kg._fused_mlp_fc2(y_j, x_j, p0, jc, 2)
    y_same = _t(jnp.asarray(y_j, jnp.float32), tdt)
    out_t = fd.fused_mlp_fc2(y_same, x_t, t0, tc)
    return [(y_t, y_j), (out_t, out_j)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("fn", ["qkv", "out_proj", "mlp", "mlp_fc1_fc2"])
def test_plain_fused_functions_match_jax_fp32(fn, name):
    for got, want in _run_function(fn, name, bf16=False):
        _close(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("fn", ["qkv", "out_proj", "mlp", "mlp_fc1_fc2"])
def test_plain_fused_functions_match_jax_bf16(fn, name, monkeypatch):
    from megatronapp_tpu.ops import activations as jact
    monkeypatch.setattr(jact, "apply_activation", _port_rounding_activation)
    pairs = _run_function(fn, name, bf16=True)
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == torch.bfloat16
        through_act = fn == "mlp" or (fn == "mlp_fc1_fc2" and i == 0)
        _within_bf16_ulps(got, want, 4 if through_act else 0)


def test_fused_mlp_is_the_fc1_fc2_pair_of_the_unfused_mlp():
    """The fused MLP and the unfused layer's MLP tail give the same bits
    on the CPU: the fused step can only change a greedy stream through
    the kernels on the card."""
    from megatronapp_tpu_torch.ops.normalization import apply_norm
    from megatronapp_tpu_torch.transformer.mlp import mlp_forward
    _, tc, _, tp = _weights("llama")
    t0 = tp["layers"][0]
    x = _t(_inputs(tc)["x"])
    h = apply_norm(tc.normalization, x, t0["ln2_scale"], None,
                   tc.layernorm_epsilon)
    want = x + mlp_forward(t0["mlp"], h, tc).to(x.dtype)
    assert torch.equal(fd.fused_mlp_plain(x, t0, tc), want)
    assert torch.equal(fd.fused_mlp(x, t0, tc), want)


# ---------------------------------------------------------------------------
# the layer bodies against JAX's, on the same pools and page tables
# ---------------------------------------------------------------------------


def _pools(tc, nb, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (nb, bs, tc.num_query_groups, tc.head_dim)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_fused_layer_decode_matches_jax(name):
    jc, tc, jp, tp = _weights(name)
    b, bs, mb = 3, 4, 6
    kp, vp = _pools(tc, b * mb + 1, bs, 1)
    rng = np.random.default_rng(2)
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    lengths = np.asarray([4, 13, 22], np.int32)
    active = np.asarray([True, False, True])
    x = rng.normal(size=(b, 1, tc.hidden_size)).astype(np.float32)
    cos = rng.normal(size=(b, 1, tc.head_dim // 2)).astype(np.float32)
    sin = rng.normal(size=(b, 1, tc.head_dim // 2)).astype(np.float32)
    rope = name != "gpt2"
    (j_out, j_cache), _ = kg.fused_layer_decode(
        _layer0(jp), jnp.asarray(x), jc,
        jnp.asarray(cos) if rope else None,
        jnp.asarray(sin) if rope else None,
        (jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(lengths),
        jnp.asarray(table), jnp.asarray(active))
    cache = (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    index = paged_write_index(
        torch.from_numpy(table), torch.from_numpy(lengths),
        torch.ones(b, dtype=torch.int32), torch.from_numpy(active), bs, 1)
    (t_out, _), _ = fd.fused_layer_decode(
        tp["layers"][0], torch.from_numpy(x), tc,
        _t(cos) if rope else None, _t(sin) if rope else None, cache,
        torch.from_numpy(lengths), torch.from_numpy(table), index)
    np.testing.assert_allclose(t_out.numpy()[active],
                               np.asarray(j_out)[active],
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    for got, want in zip(cache, j_cache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_fused_layer_multiquery_matches_jax(name):
    jc, tc, jp, tp = _weights(name)
    b, s, bs, mb = 3, 6, 4, 6
    kp, vp = _pools(tc, b * mb + 1, bs, 3)
    rng = np.random.default_rng(4)
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    starts = np.asarray([0, 7, 15], np.int32)
    counts = np.asarray([6, 2, 5], np.int32)
    active = np.ones(b, bool)
    x = rng.normal(size=(b, s, tc.hidden_size)).astype(np.float32)
    cos = rng.normal(size=(b, s, tc.head_dim // 2)).astype(np.float32)
    sin = rng.normal(size=(b, s, tc.head_dim // 2)).astype(np.float32)
    rope = name != "gpt2"
    (j_out, j_cache), _ = kg.fused_layer_multiquery(
        _layer0(jp), jnp.asarray(x), jc,
        jnp.asarray(cos) if rope else None,
        jnp.asarray(sin) if rope else None,
        (jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(starts),
        jnp.asarray(counts), jnp.asarray(table), jnp.asarray(active))
    cache = (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    index = paged_write_index(
        torch.from_numpy(table), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(active), bs, s)
    (t_out, _), _ = fd.fused_layer_multiquery(
        tp["layers"][0], torch.from_numpy(x), tc,
        _t(cos) if rope else None, _t(sin) if rope else None, cache,
        torch.from_numpy(starts), torch.from_numpy(counts),
        torch.from_numpy(table), index)
    real = np.arange(s)[None, :] < counts[:, None]
    np.testing.assert_allclose(t_out.numpy()[real], np.asarray(j_out)[real],
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    for got, want in zip(cache, j_cache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LAYER_TOL, rtol=LAYER_TOL)


def test_layer_forward_dispatches_the_fused_bodies():
    """layer_forward(fused_decode=True) takes the multiquery body with
    chunk_counts, the decode body at S == 1, and refuses S > 1 without
    chunk_counts."""
    from megatronapp_tpu_torch.transformer.block import layer_forward
    _, tc, _, tp = _weights("llama")
    b, s, bs, mb = 2, 3, 4, 4
    table = torch.arange(b * mb, dtype=torch.int32).reshape(b, mb)
    starts = torch.tensor([0, 5], dtype=torch.int32)
    counts = torch.tensor([3, 2], dtype=torch.int32)
    x = torch.randn(b, s, tc.hidden_size,
                    generator=torch.Generator().manual_seed(0))
    shape = (b * mb, bs, tc.num_query_groups, tc.head_dim)
    cos, sin = (torch.randn(b, s, tc.head_dim // 2,
                            generator=torch.Generator().manual_seed(i))
                for i in (1, 2))

    def run(fused, xx, cc, ss, cnt):
        cache = (torch.zeros(shape), torch.zeros(shape))
        idx = paged_write_index(table, starts, cnt if cnt is not None
                                else torch.ones(b, dtype=torch.int32),
                                torch.ones(b, dtype=torch.bool), bs,
                                xx.shape[1])
        (out, _), _ = layer_forward(
            tp["layers"][0], xx, tc, cc, ss, kv_cache=cache,
            cache_positions=starts, page_table=table, chunk_counts=cnt,
            write_index=idx, fused_decode=fused)
        return out, cache

    for args in ((x, cos, sin, counts), (x[:, :1], cos[:, :1], sin[:, :1],
                                         None)):
        (out_f, cache_f), (out_u, cache_u) = run(True, *args), run(False,
                                                                  *args)
        assert torch.equal(out_f, out_u)
        assert all(torch.equal(a, c) for a, c in zip(cache_f, cache_u))
    with pytest.raises(ValueError, match="s == 1 decode"):
        run(True, x, cos, sin, None)


# ---------------------------------------------------------------------------
# whole engines: greedy streams token-exact
# ---------------------------------------------------------------------------


def _run_jax_fused(jc, jp):
    eng = jde.DynamicInferenceEngine(jp, jc, paged=True, fused_decode=True,
                                     **ENGINE)
    assert eng.megakernel
    # Steps run to completion before the engine bumps its numpy lengths
    # (tests/test_torch_engine.py:_run_jax says why).
    eng._decode = _synchronous(eng._decode)
    eng._mq_step = _synchronous(eng._mq_step)
    ids = [eng.add_request(p, MAX_NEW, JSampling(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats)


def _run_port(tc, tp, fused):
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     fused_decode=fused, **ENGINE)
    assert eng.megakernel is fused
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    eng.pool.audit()
    assert eng.stats_snapshot()["megakernel"] is fused
    return [res[r].tolist() for r in ids], dict(eng.pool.stats)


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def engine_runs(request):
    jc, tc, jp, tp = _weights(request.param)
    return (_run_jax_fused(jc, jp), _run_port(tc, tp, True),
            _run_port(tc, tp, False))


def test_fused_engine_streams_token_exact_with_jax(engine_runs):
    (j_streams, _), (t_streams, _), _ = engine_runs
    assert t_streams == j_streams


def test_fused_engine_streams_token_exact_with_unfused(engine_runs):
    _, (fused, _), (unfused, _) = engine_runs
    assert fused == unfused


def test_fused_engine_pool_stats_match(engine_runs):
    """The undersized pool preempts and the shared prefix hits, the same
    number of times in the JAX fused, port fused and port unfused
    engines."""
    (_, j_stats), (_, f_stats), (_, u_stats) = engine_runs
    for key in ("preemptions", "prefix_hit_tokens", "prefill_tokens",
                "cow_copies", "evictions"):
        assert f_stats[key] == j_stats[key] == u_stats[key], key
    assert f_stats["preemptions"] > 0 and f_stats["prefix_hit_tokens"] > 0


def test_ineligible_engine_warns_and_keeps_the_unfused_step(monkeypatch,
                                                            caplog):
    _, tc, _, tp = _weights("llama")
    monkeypatch.setattr(tde, "megakernel_ineligible_reason",
                        lambda *a, **k: "a named predicate")
    with caplog.at_level(logging.WARNING):
        eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                         fused_decode=True, **ENGINE)
    assert eng.megakernel is False
    assert "a named predicate" in caplog.text
    assert eng.stats_snapshot()["megakernel"] is False


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_eligible_configs(name):
    _, tc, _, tp = _weights(name)
    assert fd.megakernel_ineligible_reason(tc, batch=3) is None
    assert fd.megakernel_ineligible_reason(tc, batch=3, params=tp,
                                           mq_rows=8) is None


@pytest.mark.parametrize("change,kw,match", [
    (dict(num_moe_experts=4), {}, "MoE"),
    (dict(multi_latent_attention=True), dict(lora_rank=8),
     "MLA megakernel has no q_kernel/kv_kernel"),
    ({}, dict(tp_paged=True), "tp head-sharded"),
    ({}, dict(paged=False), "non-paged"),
])
def test_ineligible_configs_name_the_predicate(change, kw, match):
    _, tc = cfg_pair(**LLAMA_SMALL)
    cfg = dataclasses.replace(tc, **change)
    assert match in fd.megakernel_ineligible_reason(cfg, batch=8, **kw)


@pytest.mark.parametrize("change,match", [
    ({}, None),
    (dict(params_dtype=torch.bfloat16), None),
    (dict(compute_dtype=torch.float32), "compute dtype"),
    (dict(params_dtype=torch.float16), "weight dtype"),
    (dict(kv_channels=96), "head_dim"),
    (dict(hidden_size=4160, kv_channels=128), "alignment: hidden_size"),
    (dict(ffn_hidden_size=14344), "alignment: ffn_hidden_size"),
])
def test_cuda_kernel_limits_hold_on_the_card_only(change, match):
    """The CUDA kernels' own limits apply where the step runs on the card;
    on the CPU the plain versions take any shape."""
    cfg = llama3_8b(**change)
    got = fd.megakernel_ineligible_reason(cfg, batch=8, mq_rows=32,
                                          device="cuda")
    assert got is None if match is None else match in got
    assert fd.megakernel_ineligible_reason(cfg, batch=8, device="cpu") \
        is None


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    """The wrappers take the plain versions only for CPU tensors: a meta
    tensor goes to the kernel path, which raises instead of falling
    back."""
    def no_plain(*a, **k):
        raise AssertionError("plain version reached")

    for name in ("fused_qkv_plain", "fused_out_proj_plain",
                 "fused_mlp_fc1_plain", "fused_mlp_fc2_plain"):
        monkeypatch.setattr(cuda_fd, name, no_plain)
    _, tc, _, tp = _weights("llama")
    t0 = tp["layers"][0]
    x = torch.empty(4, tc.hidden_size, device="meta")
    calls = [lambda: cuda_fd.fused_qkv(x, t0, tc),
             lambda: cuda_fd.fused_out_proj(x, t0, tc, x),
             lambda: cuda_fd.fused_mlp_fc1(x, t0, tc),
             lambda: cuda_fd.fused_mlp_fc2(x, x, t0, tc)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
