"""MegaScope in the port against the JAX package, on the CPU.

- ``_compress`` (on the tensor's device) and ``Compressor`` within 1e-6 of
  JAX's; capture_payload, the TensorTracer's flags, report_result (top-20)
  and pca_mlp2 equal.
- The static engine with every capture site on, fp32 models from the same
  weights: the payloads of each forward call match JAX's site for site,
  layer for layer and shape for shape, each within 1e-4 of its own max.
  JAX's jax.debug.callback captures are unordered within a step (qkv_v may
  land before qkv_q), so the comparison is per forward call and layer; the
  port's order is program order, pinned as such.
- Capture is identity: streams and logits with capture on are the same
  bits as with it off.
- Disturbance: scale 0 is the identity, `layers` gates, draws repeat per
  seed and differ across seeds, sites and layers, each kind has its law's
  mean and spread, and unknown sites or kinds raise JAX's messages. A
  'system' disturbance moves a stream; scale 0 does not.
- The fused decode step is refused with JAX's reasons while hooks or
  disturbances are active, and the dynamic engine then keeps the unfused
  step.
- TrainingScopeSession's frames in the wire format, and the training
  server's routes (/, /frontend, /ws) through aiohttp's test server with
  ScopeClient; the text server's static path: REST, visualization frames
  over /ws (captures, candidates, done) and a malformed config's error
  frame.
"""

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.inference import engine as je
from megatronapp_tpu.scope import disturbance as j_dist
from megatronapp_tpu.scope import hooks as j_hooks
from megatronapp_tpu.scope import tensor_tracer as j_tt
from megatronapp_tpu_torch.inference import engine as te
from megatronapp_tpu_torch.scope import disturbance as t_dist
from megatronapp_tpu_torch.scope import hooks as t_hooks
from megatronapp_tpu_torch.scope import tensor_tracer as t_tt
from test_torch_engine import _weights

ALL_SITES = {s: True for s in t_hooks._SITE_TO_FLAG}
LAYER_ORDER = ["qkv_q", "qkv_k", "qkv_v", "attention_probs", "context",
               "mlp1", "mlp2"]


@pytest.fixture(autouse=True)
def _clean_scope():
    yield
    t_hooks.configure(False)
    j_hooks.configure(False)
    t_dist.get_disturbance().clear()
    t_tt.get_tensor_tracer().deactivate()


@pytest.mark.parametrize("shape,pixels", [
    ((2, 5, 64), 16), ((3, 4, 7, 50), 16), ((2, 40), 64), ((4, 33), 0),
    ((2, 3, 128), 7)])
def test_compress_matches_jax(shape, pixels):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = t_hooks._compress(torch.from_numpy(x), pixels).numpy()
    want = np.asarray(j_hooks._compress(jnp.asarray(x), pixels))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    got = t_hooks._compress(bf, pixels).numpy()
    want = np.asarray(j_hooks._compress(jnp.asarray(x, jnp.bfloat16),
                                        pixels))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["mean", "max", "min", "norm", "first"])
def test_compressor_matches_jax(method):
    x = np.random.default_rng(2).normal(size=(3, 4, 70)).astype(np.float32)
    np.testing.assert_allclose(t_tt.Compressor(16, method)(x),
                               j_tt.Compressor(16, method)(x), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError) as je_:
        j_tt.Compressor(16, "median")
    with pytest.raises(ValueError) as te_:
        t_tt.Compressor(16, "median")
    assert str(te_.value) == str(je_.value)


def test_payload_flags_report_and_pca_match_jax():
    arr = np.random.default_rng(3).normal(size=(2, 3)).astype(np.float32)
    for site, lid in (("qkv_q", 0), ("result", -1), ("between_layers", 2)):
        assert (t_hooks.capture_payload(site, lid, arr)
                == j_hooks.capture_payload(site, lid, arr))
    assert [int(f) for f in t_hooks.FlagType] == [int(f) for f in
                                                  j_hooks.FlagType]
    cfg = {"QKV_mat_mul": [0, 1], "MLP2": [1], "Result": [0]}
    jt, tt = j_tt.TensorTracer(), t_tt.TensorTracer()
    jt.set_flags_from_config(cfg)
    tt.set_flags_from_config(cfg)
    for site in list(t_hooks._SITE_TO_FLAG) + ["between_layers"]:
        for lid in (-1, 0, 1, 2):
            assert tt._site_enabled(site, lid) == jt._site_enabled(site,
                                                                   lid)
    from megatronapp_tpu.data.tokenizers import NullTokenizer as JNull
    from megatronapp_tpu_torch.data.tokenizers import NullTokenizer
    logits = np.random.default_rng(4).normal(size=64)
    assert (tt.report_result(logits, 5, NullTokenizer(64))
            == jt.report_result(logits, 5, JNull(64)))
    recs = np.random.default_rng(5).normal(size=(3, 6, 8))
    for r in recs:
        jt.mlp2_records.append(r)
        tt.mlp2_records.append(r)
    np.testing.assert_allclose(tt.pca_mlp2(), jt.pca_mlp2(), atol=1e-6)


# ---------------------------------------------------------------------------
# the static engine with every site on
# ---------------------------------------------------------------------------


def _calls(caps):
    """Split a capture stream into forward calls (each ends at 'result')
    of {(site, layer): array}."""
    calls, cur = [], []
    for site, lid, arr in caps:
        cur.append((site, lid, np.asarray(arr)))
        if site == "result":
            calls.append(cur)
            cur = []
    assert not cur
    return calls


def _run(engine, mod_hooks, prompts, n, sampling, sites=ALL_SITES,
         pixels=16):
    caps = []
    mod_hooks.configure(True, sites, lambda s, l, a: caps.append((s, l, a)),
                        pixels)
    try:
        out = engine.generate(prompts, n, sampling)
        if mod_hooks is j_hooks:
            jax.effects_barrier()
    finally:
        mod_hooks.configure(False)
    return out, caps


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_static_engine_captures_match_jax(arch):
    jc, tc, jp, tp = _weights(arch)
    prompts = np.random.default_rng(6).integers(0, 127, (2, 5)).astype(
        np.int32)
    j_out, j_caps = _run(je.StaticInferenceEngine(jp, jc, max_seq_len=24),
                         j_hooks, prompts, 4, je.SamplingParams(greedy=True))
    t_out, t_caps = _run(
        te.StaticInferenceEngine(tp, tc, max_seq_len=24, device="cpu"),
        t_hooks, prompts, 4, te.SamplingParams(greedy=True))
    np.testing.assert_array_equal(t_out, np.asarray(j_out))
    j_calls, t_calls = _calls(j_caps), _calls(t_caps)
    assert len(t_calls) == len(j_calls) == 4      # prefill + 3 decodes
    for jc_, tc_ in zip(j_calls, t_calls):
        assert [(s, l) for s, l, _ in tc_] == [
            (s, l) for l in range(2) for s in LAYER_ORDER] + [("result",
                                                               -1)]
        want = {(s, l): a for s, l, a in jc_}
        assert len(want) == len(tc_)
        for s, l, a in tc_:
            w = want[(s, l)]
            assert a.shape == w.shape, (s, l)
            np.testing.assert_allclose(a, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())


def test_tracer_flags_filter_before_the_copy(monkeypatch):
    """TensorTracer.activate: the port's hooks compress and copy only the
    flagged (site, layer) pairs, and report the same pairs as JAX's
    tracer, which filters them in its sink."""
    jc, tc, jp, tp = _weights("llama")
    prompts = np.random.default_rng(8).integers(0, 127, (1, 5)).astype(
        np.int32)
    cfg = {"MLP2": [1], "QKV_mat_mul": [0], "Result": [0]}
    reports = {"j": [], "t": []}
    copies = []
    compress = t_hooks._compress
    monkeypatch.setattr(t_hooks, "_compress",
                        lambda x, p: copies.append(1) or compress(x, p))
    for tag, tt_mod, eng in (
            ("j", j_tt, je.StaticInferenceEngine(jp, jc, max_seq_len=24)),
            ("t", t_tt, te.StaticInferenceEngine(tp, tc, max_seq_len=24,
                                                 device="cpu"))):
        tracer = tt_mod.TensorTracer()
        tracer.set_flags_from_config(cfg)
        tracer.activate(lambda s, l, a, tag=tag: reports[tag].append(
            (s, int(l))), pixels=16)
        try:
            eng.generate(prompts, 3, (je if tag == "j" else te)
                         .SamplingParams(greedy=True))
            if tag == "j":
                jax.effects_barrier()
        finally:
            tracer.deactivate()
    # 3 forward calls x (q, k, v on layer 0, mlp2 on layer 1, result).
    assert len(reports["t"]) == 3 * 5
    assert sorted(reports["t"]) == sorted(reports["j"])
    assert len(copies) == len(reports["t"])


def test_capture_is_identity():
    _, tc, _, tp = _weights("llama")
    eng = te.StaticInferenceEngine(tp, tc, max_seq_len=24, device="cpu")
    prompts = np.random.default_rng(7).integers(0, 127, (2, 5)).astype(
        np.int32)
    logits = {"on": [], "off": []}

    def run(tag, on):
        cb = (lambda s, t, lg: logits[tag].append(lg))
        if on:
            t_hooks.configure(True, ALL_SITES | {"between_layers": True},
                              lambda *a: None, 16)
        try:
            return eng.generate(prompts, 6, te.SamplingParams(greedy=True),
                                token_callback=cb)
        finally:
            t_hooks.configure(False)

    np.testing.assert_array_equal(run("on", True), run("off", False))
    for a, b in zip(logits["on"], logits["off"]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# disturbance
# ---------------------------------------------------------------------------


def _dist(config, seed=0):
    d = t_dist.Disturbance()
    d.configure(config, seed=seed)
    return d


def test_disturbance_scale_zero_and_unconfigured_are_identity():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    for site in t_dist.SITES:
        d = _dist({site: {"kind": "noise1", "scale": 0.0}})
        assert d.apply(site, x, 0) is x and not d.active(site)
        assert _dist({}).apply(site, x, 1) is x


def test_disturbance_layer_gating_and_seeds():
    x = torch.zeros(64, 64)
    d = _dist({"system": {"kind": "noise1", "scale": 0.5,
                          "layers": [1, 3]}}, seed=4)
    assert d.apply("system", x, 0) is x and d.apply("system", x, 2) is x
    a1, a3 = d.apply("system", x, 1), d.apply("system", x, 3)
    assert not torch.equal(a1, x) and not torch.equal(a1, a3)
    assert torch.equal(a1, d.apply("system", x, 1))        # repeats
    same = _dist({"system": {"kind": "noise1", "scale": 0.5,
                             "layers": [1, 3]}}, seed=4)
    assert torch.equal(same.apply("system", x, 1), a1)
    other = _dist({"system": {"kind": "noise1", "scale": 0.5}}, seed=5)
    assert not torch.equal(other.apply("system", x, 1), a1)
    both = _dist({"system": {"kind": "noise1", "scale": 0.5},
                  "calculation": {"kind": "noise1", "scale": 0.5}}, seed=4)
    assert not torch.equal(both.apply("system", x, 1),
                           both.apply("calculation", x, 1))
    # Without a layer id the noise applies whatever `layers` says (JAX).
    assert not torch.equal(d.apply("system", x), x)


@pytest.mark.parametrize("kind", ["noise1", "noise2"])
def test_disturbance_laws(kind):
    scale = 0.3
    x = torch.ones(400, 500)
    y = _dist({"weight": {"kind": kind, "scale": scale}}, seed=1).apply(
        "weight", x, 0)
    if kind == "noise1":     # x + N(0, scale^2)
        noise = y - x
        assert abs(float(noise.mean())) < 5e-3
        assert abs(float(noise.std()) - scale) < 5e-3
    else:                    # x * U[1 - scale, 1 + scale]
        assert float(y.min()) >= 1 - scale and float(y.max()) <= 1 + scale
        assert abs(float(y.mean()) - 1.0) < 5e-3
        assert abs(float(y.std()) - scale / 3 ** 0.5) < 5e-3
    assert y.dtype == x.dtype


@pytest.mark.parametrize("config", [
    {"bogus": {"kind": "noise1", "scale": 1.0}},
    {"system": {"kind": "noise3", "scale": 1.0}}])
def test_disturbance_errors_are_jax_messages(config):
    with pytest.raises(ValueError) as jerr:
        j_dist.Disturbance().configure(config)
    with pytest.raises(ValueError) as terr:
        t_dist.Disturbance().configure(config)
    assert str(terr.value) == str(jerr.value)


def test_system_disturbance_moves_the_stream():
    _, tc, _, tp = _weights("llama")
    eng = te.StaticInferenceEngine(tp, tc, max_seq_len=24, device="cpu")
    prompts = np.random.default_rng(8).integers(0, 127, (2, 5)).astype(
        np.int32)
    greedy = te.SamplingParams(greedy=True)
    plain = eng.generate(prompts, 8, greedy)
    d = t_dist.get_disturbance()
    d.configure({"system": {"kind": "noise1", "scale": 0.0}})
    assert np.array_equal(eng.generate(prompts, 8, greedy), plain)
    d.configure({"system": {"kind": "noise1", "scale": 5.0}}, seed=3)
    moved = eng.generate(prompts, 8, greedy)
    assert not np.array_equal(moved, plain)
    assert np.array_equal(eng.generate(prompts, 8, greedy), moved)
    d.clear()
    assert np.array_equal(eng.generate(prompts, 8, greedy), plain)


# ---------------------------------------------------------------------------
# the fused decode step's MegaScope predicates
# ---------------------------------------------------------------------------


def test_fused_decode_refused_with_jax_reasons():
    from megatronapp_tpu.ops.pallas import kernel_gen
    from megatronapp_tpu_torch.ops import fused_decode as fd
    jc, tc, jp, _ = _weights("llama")
    assert fd.megakernel_ineligible_reason(tc, batch=3) is None
    sink = lambda *a: None      # noqa: E731
    j_hooks.configure(True, {"mlp1": True}, sink)
    t_hooks.configure(True, {"mlp1": True}, sink)
    want = kernel_gen.megakernel_ineligible_reason(jc, batch=3, params=jp)
    assert fd.megakernel_ineligible_reason(tc, batch=3) == want
    assert "capture hooks" in want
    j_hooks.configure(False)
    t_hooks.configure(False)
    cfg = {"calculation": {"kind": "noise2", "scale": 0.1}}
    j_dist.get_disturbance().configure(cfg)
    t_dist.get_disturbance().configure(cfg)
    try:
        want = kernel_gen.megakernel_ineligible_reason(jc, batch=3,
                                                       params=jp)
    finally:
        j_dist.get_disturbance().clear()
    assert fd.megakernel_ineligible_reason(tc, batch=3) == want
    assert "disturbance" in want


def test_dynamic_engine_keeps_the_unfused_step_under_capture(caplog):
    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    _, tc, _, tp = _weights("llama")
    t_hooks.configure(True, {"context": True}, lambda *a: None)
    eng = DynamicInferenceEngine(tp, tc, max_batch=2, max_seq_len=32,
                                 block_size=4, device="cpu",
                                 fused_decode=True)
    assert eng.megakernel is False
    assert "MegaScope capture hooks active" in caplog.text
    t_hooks.configure(False)
    assert DynamicInferenceEngine(tp, tc, max_batch=2, max_seq_len=32,
                                  block_size=4, device="cpu",
                                  fused_decode=True).megakernel is True


# ---------------------------------------------------------------------------
# the training scope session and server
# ---------------------------------------------------------------------------

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)
VIZ = {"QKV_mat_mul": [0], "RawAttentionScore": [1], "ContextLayer": [0],
       "MLP1": [1], "Result": [0]}


def _session():
    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.config.transformer_config import (
        TransformerConfig,
    )
    from megatronapp_tpu_torch.scope.ws_server import TrainingScopeSession
    return TrainingScopeSession(
        TransformerConfig(compute_dtype=torch.float32, **TINY),
        TrainingConfig(micro_batch_size=2, global_batch_size=2,
                       seq_length=32, train_iters=20),
        OptimizerConfig(lr=1e-3), device="cpu")


def test_training_session_frames_in_the_wire_format():
    from megatronapp_tpu_torch.scope.client import validate_payloads
    s = _session()
    frames = s.run_step(VIZ, {"system": {"kind": "noise1", "scale": 0.05,
                                         "layers": [0]}},
                        {"pixels": 8, "method": "mean"})
    validate_payloads(frames, VIZ)
    caps, done = frames[:-1], frames[-1]
    assert [(c["site"], c["layer_id"]) for c in caps] == [
        ("qkv_q", 0), ("qkv_k", 0), ("qkv_v", 0), ("context", 0),
        ("attention_probs", 1), ("mlp1", 1), ("result", -1)]
    for c in caps:
        assert c["update_type"] == int(t_hooks._SITE_TO_FLAG[c["site"]])
        assert np.asarray(c["result"]).shape[-1] == 8
    assert done["type"] == "step_done" and done["iteration"] == 1
    assert np.isfinite(done["loss"]) and np.isfinite(done["grad_norm"])
    assert not t_hooks.is_enabled("qkv_q")           # hooks cleared
    assert not t_dist.get_disturbance().active("system")
    plain = s.run_step()
    assert plain == [plain[-1]] and plain[-1]["iteration"] == 2
    with_mlp2 = s.run_step({"MLP2": [0, 1]})
    assert with_mlp2[-2]["type"] == "pca"
    validate_payloads(with_mlp2, {"MLP2": [0, 1]})


def test_training_session_raises_without_a_card(monkeypatch):
    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.config.transformer_config import (
        TransformerConfig,
    )
    from megatronapp_tpu_torch.scope.ws_server import TrainingScopeSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainingScopeSession(TransformerConfig(**TINY), TrainingConfig(),
                             OptimizerConfig())


def test_training_scope_server_wire_contract():
    from aiohttp.test_utils import TestClient, TestServer

    from megatronapp_tpu_torch.scope.client import (
        ScopeClient, validate_payloads,
    )
    from megatronapp_tpu_torch.scope.ws_server import TrainingScopeServer
    srv = TrainingScopeServer(_session())

    async def run():
        client = TestClient(TestServer(srv.build_app()))
        await client.start_server()
        try:
            index = await client.get("/")
            assert index.status == 200 and "<html" in (await index.text())
            app_js = await client.get("/frontend/app.js")
            assert app_js.status == 200
            comp = await client.get("/frontend/components/PCAPlot.js")
            assert comp.status == 200
            ws = await client.ws_connect("/ws")
            await ws.send_json({"type": "bogus"})
            err = await ws.receive_json(timeout=60)
            assert err == {"type": "error", "message": "unknown message type"}
            await ws.send_json({"type": "run_training_step",
                                "visualization": {"Bogus": [0]}})
            err = await ws.receive_json(timeout=60)
            assert err["type"] == "error"
            await ws.close()
            url = str(client.make_url("/ws")).replace("http", "ws", 1)
            frames = await ScopeClient(url, timeout=60)._run_step_async(
                {"ContextLayer": [1]}, None, {"pixels": 4},
                session=client.session)
            validate_payloads(frames, {"ContextLayer": [1]})
            assert [f.get("site") for f in frames[:-1]] == ["context"]
        finally:
            await client.close()

    asyncio.run(run())


# ---------------------------------------------------------------------------
# the text server's static path
# ---------------------------------------------------------------------------


def _static_server():
    from megatronapp_tpu_torch.data.tokenizers import NullTokenizer
    from megatronapp_tpu_torch.inference.server import TextGenerationServer
    _, tc, _, tp = _weights("llama")
    eng = te.StaticInferenceEngine(tp, tc, tokenizer=NullTokenizer(128),
                                   max_seq_len=32, device="cpu")
    return TextGenerationServer(eng)


def test_generate_streaming_in_process():
    srv = _static_server()
    req = {"prompt": "1 2 3", "tokens_to_generate": 3, "greedy": True}
    plain = []
    text = srv.generate_streaming(req, plain.append)
    assert [p["type"] for p in plain] == ["token"] * 3
    assert text[0] == " ".join(str(p["token"]) for p in plain)
    frames = []
    viz = dict(req, visualization={"ContextLayer": [0, 1], "Result": [0]},
               compressor={"pixels": 8})
    assert srv.generate_streaming(viz, frames.append) == text
    caps = [f for f in frames if "update_type" in f]
    toks = [f for f in frames if f.get("type") == "token"]
    assert [t["token"] for t in toks] == [p["token"] for p in plain]
    assert all(len(t["candidates"]) == 20 for t in toks)
    assert toks[0]["candidates"][0]["token"] == toks[0]["token"]
    # 3 forward calls (prefill + 2 decodes) x (2 context + 1 result).
    assert len(caps) == 9
    moved = []
    noisy = dict(viz, disturbance={"system": {"kind": "noise1",
                                              "scale": 5.0}},
                 random_seed=2)
    assert srv.generate_streaming(noisy, moved.append) != text
    assert srv.generate_streaming(req, lambda p: None) == text  # cleared
    assert not t_hooks.is_enabled("context")
    cancel = threading.Event()
    cancel.set()
    from megatronapp_tpu_torch.inference.server import _ClientGone
    with pytest.raises(_ClientGone):
        srv.generate_streaming(req, lambda p: None, cancel)


def test_static_server_rest_and_ws_visualization():
    from aiohttp.test_utils import TestClient, TestServer
    srv = _static_server()

    async def run():
        client = TestClient(TestServer(srv.build_app()))
        await client.start_server()
        try:
            r = await client.put("/api", json={"prompts": ["1 2", "3 4 5"],
                                               "tokens_to_generate": 2,
                                               "greedy": True})
            body = await r.json()
            assert r.status == 200 and len(body["segments"]) == 2
            assert (await (await client.get("/stats")).json()) == {
                "engine": "static"}
            health = await (await client.get("/healthz")).json()
            assert health == {"status": "ok", "engine": "static"}
            ws = await client.ws_connect("/ws")
            await ws.send_json({"prompt": "1 2 3", "tokens_to_generate": 2,
                                "greedy": True,
                                "visualization": {"MLP2": [1]},
                                "compressor": {"pixels": 4}})
            frames = []
            while True:
                msg = await ws.receive_json(timeout=60)
                frames.append(msg)
                if msg.get("type") in ("done", "error"):
                    break
            assert frames[-1]["type"] == "done"
            caps = [f for f in frames if "update_type" in f]
            assert [(c["site"], c["layer_id"]) for c in caps] == [
                ("mlp2", 1)] * 2
            assert all("candidates" in f for f in frames
                       if f.get("type") == "token")
            await ws.send_json({"prompt": "1", "tokens_to_generate": 1,
                                "visualization": {"NoSuchFlag": [0]}})
            msg = await ws.receive_json(timeout=60)
            assert msg["type"] == "error" and "NoSuchFlag" in msg["message"]
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())
