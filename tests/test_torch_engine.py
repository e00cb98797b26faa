"""The port's paged serving engine against the JAX package's.

The same weights (the JAX init, every leaf perturbed, carried across by
``convert.params_from_jax``) go through both: the one-token and ragged
steps (logits and updated pools, fp32, tolerance 1e-4 — different matmul
summation orders through two layers, logits of order 10), and whole
engine runs whose greedy streams must be token-exact, across a
preemption and a prefix-cache hit. Sampled streams cannot follow JAX's
key chains; they are held to the port's own invariants. The last group
is the block-pool allocator cases of tests/test_paged_kv.py."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import GPT2_SMALL, LLAMA_SMALL, cfg_pair

from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu.models.gpt import init_gpt_params as j_init
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference.engine import SamplingParams
from megatronapp_tpu_torch.inference.paged_cache import PagedKVCache, cdiv
from megatronapp_tpu_torch.inference.server import DynamicBatchingDriver
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.models.gpt import gpt_rope_tables
from megatronapp_tpu_torch.ops.paged_attention import paged_write_index
from megatronapp_tpu_torch.trace.request_trace import get_request_tracer
from megatronapp_tpu_torch.utils import chaos
from megatronapp_tpu_torch.utils import metrics as telemetry

TOL = 1e-4
ARCHS = {"llama": LLAMA_SMALL, "gpt2": GPT2_SMALL}


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=0):
    """(jax cfg, port cfg, jax params, port params) with every leaf
    perturbed so zero biases and unit scales test nothing by accident.
    Cached: the JAX init dominates a test's time, and no test changes the
    weights it is given."""
    jc, tc = cfg_pair(**ARCHS[arch])
    params, _ = j_init(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)
                   ).astype(np.float32), params)
    return (jc, tc, jax.tree.map(jnp.asarray, np_params),
            params_from_jax(np_params, tc, "cpu"))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def weights(request):
    return (request.param,) + _weights(request.param)


def _pools(tc, nb, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (tc.num_layers, nb, bs, tc.num_query_groups, tc.head_dim)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


def test_decode_step_matches_jax(weights):
    _, jc, tc, jp, tp = weights
    b, bs, mb, msl = 3, 4, 6, 64
    kp, vp = _pools(tc, b * mb + 1, bs, 1)
    rng = np.random.default_rng(2)
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    lengths = np.asarray([4, 13, 22], np.int32)
    active = np.asarray([True, False, True])
    tokens = rng.integers(0, 128, (b, 1)).astype(np.int32)
    j_logits, j_pages = jde._paged_decode_step(
        jp, jnp.asarray(tokens), (jnp.asarray(kp), jnp.asarray(vp)),
        jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(active), jc,
        msl)
    pages = (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    index = paged_write_index(
        torch.from_numpy(table), torch.from_numpy(lengths),
        torch.ones(b, dtype=torch.int32), torch.from_numpy(active), bs, 1)
    t_logits, _ = tde._paged_decode_step(
        tp, torch.from_numpy(tokens), pages, torch.from_numpy(table),
        torch.from_numpy(lengths), tc, index, gpt_rope_tables(tc, msl))
    np.testing.assert_allclose(t_logits.numpy()[active],
                               np.asarray(j_logits)[active],
                               atol=TOL, rtol=TOL)
    for got, want in zip(pages, j_pages):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_multiquery_step_matches_jax(weights):
    _, jc, tc, jp, tp = weights
    b, s, bs, mb, msl = 3, 6, 4, 6, 64
    kp, vp = _pools(tc, b * mb + 1, bs, 3)
    rng = np.random.default_rng(4)
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    starts = np.asarray([0, 7, 15], np.int32)
    q_lens = np.asarray([6, 2, 5], np.int32)
    active = np.ones(b, bool)
    tokens = rng.integers(0, 128, (b, s)).astype(np.int32)
    j_logits, j_hidden, j_pages = jde._paged_multiquery_step(
        jp, jnp.asarray(tokens), (jnp.asarray(kp), jnp.asarray(vp)),
        jnp.asarray(table), jnp.asarray(starts), jnp.asarray(q_lens),
        jnp.asarray(active), jc, msl)
    pages = (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    index = paged_write_index(
        torch.from_numpy(table), torch.from_numpy(starts),
        torch.from_numpy(q_lens), torch.from_numpy(active), bs, s)
    t_logits, t_hidden, _ = tde._paged_multiquery_step(
        tp, torch.from_numpy(tokens), pages, torch.from_numpy(table),
        torch.from_numpy(starts), torch.from_numpy(q_lens), tc, msl, index,
        gpt_rope_tables(tc, msl))
    real = np.arange(s)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(t_logits.numpy()[real],
                               np.asarray(j_logits)[real],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t_hidden.numpy()[real],
                               np.asarray(j_hidden)[real],
                               atol=TOL, rtol=TOL)
    for got, want in zip(pages, j_pages):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# whole engines: greedy streams token-exact across preemption + prefix hit
# ---------------------------------------------------------------------------

ENGINE = dict(max_batch=3, max_seq_len=64, block_size=4, num_blocks=12,
              prefill_chunk=8)
MAX_NEW = 10


def _prompts():
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 127, 12)
    out = []
    for i in range(5):
        tail = rng.integers(0, 127, 3 + 2 * i)
        out.append((np.concatenate([shared, tail]) if i % 2
                    else tail).astype(np.int32))
    return out


def _synchronous(fn):
    def call(*args):
        return jax.block_until_ready(fn(*args))
    return call


def _run_jax(jc, jp):
    eng = jde.DynamicInferenceEngine(jp, jc, paged=True, **ENGINE)
    # On the CPU, jnp.asarray aliases the engine's numpy `lengths`, and
    # the JAX engine bumps `lengths` in place right after dispatching the
    # decode step: under load the step can read the bumped lengths. Each
    # step is run to completion before the engine goes on, so the
    # reference stream is the one its code describes.
    eng._decode = _synchronous(eng._decode)
    eng._mq_step = _synchronous(eng._mq_step)
    ids = [eng.add_request(p, MAX_NEW, JSampling(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats)


def _run_port(tc, tp, sampling=None, prompts=None):
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", **ENGINE)
    prompts = _prompts() if prompts is None else prompts
    ids = [eng.add_request(p, MAX_NEW, sampling or SamplingParams(
        greedy=True)) for p in prompts]
    res = eng.run_to_completion()
    eng.pool.audit()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats)


@pytest.fixture(scope="module")
def runs(weights):
    arch, jc, tc, jp, tp = weights
    return arch, _run_jax(jc, jp), _run_port(tc, tp)


def test_greedy_streams_token_exact(runs):
    _, (j_streams, _), (t_streams, _) = runs
    assert t_streams == j_streams


def test_preemption_and_prefix_hits_match(runs):
    """The undersized pool preempts and the shared 12-token prefix hits,
    on both engines, the same number of times."""
    _, (_, j_stats), (_, t_stats) = runs
    for key in ("preemptions", "prefix_hit_tokens", "prefill_tokens",
                "cow_copies", "evictions"):
        assert t_stats[key] == j_stats[key], key
    assert t_stats["preemptions"] > 0
    assert t_stats["prefix_hit_tokens"] > 0


SAMPLED = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=5)


def test_sampled_streams_reproducible():
    _, tc, _, tp = _weights("llama", 1)
    a, _ = _run_port(tc, tp, SAMPLED)
    b, _ = _run_port(tc, tp, SAMPLED)
    g, _ = _run_port(tc, tp)
    assert a == b
    assert a != g                      # the sampler is not the argmax


def test_sampled_stream_independent_of_batch():
    """A request's sampled stream depends on (seed, request id, step),
    not on which other requests share its decode steps."""
    _, tc, _, tp = _weights("llama", 1)
    prompts = _prompts()
    alone, _ = _run_port(tc, tp, SAMPLED, prompts[:1])
    crowd, _ = _run_port(tc, tp, SAMPLED, prompts)
    assert crowd[0] == alone[0]


def test_warp_logits_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(4, 50)).astype(np.float32) * 3
    temps = np.asarray([1.0, 0.5, 2.0, 1.0], np.float32)
    ks = np.asarray([0, 5, 10, 50], np.int32)
    ps = np.asarray([0.0, 0.8, 0.0, 0.5], np.float32)
    want = np.asarray(jde._warp_logits(*map(jnp.asarray,
                                            (logits, temps, ks, ps))))
    got = tde._warp_logits(*map(torch.from_numpy,
                                (logits, temps, ks, ps))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_row_seeds_are_distinct():
    seeds = {tde._row_seed(s, r, t) for s in range(3) for r in range(20)
             for t in range(20)}
    assert len(seeds) == 3 * 20 * 20
    assert all(0 <= x < 2 ** 63 for x in seeds)


def test_driver_concurrent_submits_match_engine():
    """Requests submitted from concurrent threads through the stepper
    thread all finish, with the streams a plain engine run gives."""
    _, tc, _, tp = _weights("llama", 2)
    prompts = _prompts()
    want, _ = _run_port(tc, tp)
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", **ENGINE)
    driver = DynamicBatchingDriver(eng)
    out = [None] * len(prompts)
    errors = []

    def submit(i):
        try:
            rid, done = driver.submit(prompts[i], MAX_NEW,
                                      SamplingParams(greedy=True))
            assert done.wait(timeout=60)
            out[i] = driver.result_tokens(rid).tolist()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert out == want
    assert driver.stats()["restarts"] == 0
    eng.pool.audit()
    assert eng.pool.blocks_in_use() == 0


def test_deadline_and_abort():
    _, tc, _, tp = _weights("llama", 2)
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", **ENGINE)
    with pytest.raises(tde.DeadlineExceeded):
        eng.add_request(np.arange(5), 4, deadline_s=0.0)
    r1 = eng.add_request(np.arange(5), 4, deadline_s=1e18)
    r2 = eng.add_request(np.arange(6), 4)
    assert eng.abort_request(r2) == "waiting"
    ev = eng.step()
    assert ev["admitted"] == [r1]
    assert eng.expire_overdue(now=2e18) == [r1]
    ev = eng.step()
    assert r1 in ev["finished"]
    eng.pool.audit()


def test_unported_engine_options_raise():
    _, tc, _, tp = _weights("llama", 2)
    # Speculative decoding is ported (tests/test_torch_speculative.py).
    for kw in (dict(paged=False), dict(spill_host_mb=8)):
        with pytest.raises(NotImplementedError, match="not ported"):
            tde.DynamicInferenceEngine(tp, tc, device="cpu", **kw)
    # Batched LoRA is ported (tests/test_torch_lora_engine.py); per-tenant
    # accounting is not, and raises at submit. Tensor-parallel serving is
    # ported (tests/test_torch_tp_engine.py); LoRA under it is not.
    from megatronapp_tpu_torch.inference.lora import (
        AdapterCache, AdapterRegistry,
    )
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.parallel.mesh import MeshContext
    cache = AdapterCache(tc, AdapterRegistry(), rank=2, device="cpu")
    ctx = MeshContext(group=None, parallel=ParallelConfig(tensor_parallel=2),
                      rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(NotImplementedError, match="not ported"):
        tde.DynamicInferenceEngine(tp, tc, device="cpu", ctx=ctx,
                                   adapter_cache=cache, **ENGINE)
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     adapter_cache=cache, **ENGINE)
    assert eng.adapters is cache
    with pytest.raises(NotImplementedError, match="not ported"):
        eng.add_request(np.arange(5), 2, tenant="acme")
    # Quantized pools are ported: an int8 engine builds and says so.
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     kv_cache_dtype="int8", **ENGINE)
    pool = eng.stats_snapshot()["pool"]
    assert pool["kv_cache_dtype"] == "int8"
    assert eng.pool.pages[0].dtype == torch.int8
    assert pool["pool_bytes_total"] == eng.pool.bytes_total
    with pytest.raises(ValueError, match="kv_cache_dtype must be one of"):
        tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                   kv_cache_dtype="int4")


def test_stats_snapshot():
    _, tc, _, tp = _weights("llama", 2)
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", **ENGINE)
    eng.add_request(np.arange(9), 3)
    eng.run_to_completion()
    snap = eng.stats_snapshot()
    assert snap["engine"] == "dynamic" and snap["device"] == "cpu"
    assert snap["decode_steps"] == 2 and snap["prefill_chunks"] == 2
    assert snap["pool"]["num_blocks"] == 12
    assert snap["pool"]["prefill_tokens"] == 9


# ---------------------------------------------------------------------------
# block pool (the allocator cases of tests/test_paged_kv.py)
# ---------------------------------------------------------------------------


def _pool(num_blocks=8, block_size=4, max_batch=2):
    _, tc = cfg_pair(**LLAMA_SMALL)
    return PagedKVCache(tc, max_batch, 32, num_blocks=num_blocks,
                        block_size=block_size)


def test_pool_admit_release_roundtrip():
    pool = _pool()
    toks = np.arange(10, dtype=np.int32)
    plan = pool.admit(0, toks)
    assert len(plan.blocks) == cdiv(10, 4) == 3
    assert pool.blocks_in_use() == 3
    assert all(pool.refcount(b) == 1 for b in plan.blocks)
    pool.release(0, toks, 10)
    assert pool.blocks_in_use() == 0
    assert pool.available_blocks() == 8
    pool.audit()


def test_pool_prefix_sharing_refcounts_and_cow():
    pool = _pool()
    toks = np.arange(12, dtype=np.int32)
    a = pool.admit(0, toks)
    pool.pages[0][:, a.blocks[2]] = 7.0     # the shared block's rows
    pool.register_prefix(0, toks, 12)
    b = pool.admit(1, toks)                 # full hit -> CoW last
    assert b.cached_tokens == 11 and b.cow
    assert b.blocks[:2] == a.blocks[:2]
    assert b.blocks[2] != a.blocks[2]
    assert pool.refcount(a.blocks[0]) == 2
    assert pool.refcount(a.blocks[2]) == 1
    assert pool.stats["cow_copies"] == 1
    # The copy-on-write block carries the shared block's rows.
    assert bool((pool.pages[0][:, b.blocks[2]] == 7.0).all())
    pool.audit()


def test_pool_partial_prefix_hit():
    pool = _pool(num_blocks=12)
    toks = np.arange(12, dtype=np.int32)
    pool.admit(0, toks)
    pool.register_prefix(0, toks, 12)
    other = np.concatenate([toks[:8], np.asarray([99, 98], np.int32)])
    plan = pool.admit(1, other)
    assert plan.cached_tokens == 8 and not plan.cow
    assert pool.refcount(plan.blocks[0]) == 2


def test_pool_lru_eviction_order():
    pool = _pool(num_blocks=4, block_size=4, max_batch=4)
    freed = []
    for slot, base in enumerate((0, 100, 200)):
        toks = np.arange(base, base + 4, dtype=np.int32)
        plan = pool.admit(slot, toks)
        pool.release(slot, toks, 4)
        freed.append(plan.blocks[0])
    plan = pool.admit(0, np.arange(300, 308, dtype=np.int32))
    assert freed[0] in plan.blocks
    assert freed[1] not in plan.blocks and freed[2] not in plan.blocks
    assert pool.stats["evictions"] == 1
    pool.release(0, np.arange(300, 308, dtype=np.int32), 8)
    miss = pool.admit(1, np.arange(0, 4, dtype=np.int32))
    assert miss.cached_tokens == 0


def test_pool_admit_rolls_back_on_exhaustion():
    pool = _pool(num_blocks=3, block_size=4, max_batch=2)
    toks = np.arange(8, dtype=np.int32)
    assert pool.admit(0, toks) is not None
    before = pool.available_blocks()
    assert pool.admit(1, np.arange(50, 58, dtype=np.int32)) is None
    assert pool.available_blocks() == before
    assert pool.ensure_capacity(0, 8)
    assert not pool.ensure_capacity(0, 12)
    pool.audit()


# ---------------------------------------------------------------------------
# faults injected at the chaos sites, and the telemetry of a run
# ---------------------------------------------------------------------------


@pytest.fixture
def armed():
    """chaos.arm, with every site disarmed again after the test."""
    try:
        yield chaos.arm
    finally:
        chaos.disarm()


def test_evict_fault_rolls_back_admission(armed):
    pool = _pool(num_blocks=4, block_size=4, max_batch=2)
    for slot, base in enumerate((0, 100)):
        toks = np.arange(base, base + 8, dtype=np.int32)
        pool.admit(slot, toks)
        pool.release(slot, toks, 8)         # 4 evictable cached blocks
    armed("paged-evict")
    with pytest.raises(chaos.ChaosFault):
        pool.admit(0, np.arange(300, 306, dtype=np.int32))
    pool.audit()
    assert pool.evictable_blocks() == 4 and pool.stats["evictions"] == 0
    plan = pool.admit(0, np.arange(300, 306, dtype=np.int32))
    assert len(plan.blocks) == 2 and pool.stats["evictions"] == 2
    pool.audit()


def test_cow_fault_rolls_back_admission(armed):
    pool = _pool()
    toks = np.arange(8, dtype=np.int32)
    a = pool.admit(0, toks)
    pool.register_prefix(0, toks, 8)
    armed("paged-cow")
    with pytest.raises(chaos.ChaosFault):
        pool.admit(1, toks)                 # full hit: CoW of the last
    pool.audit()
    assert [pool.refcount(b) for b in a.blocks] == [1, 1]
    plan = pool.admit(1, toks)
    assert plan.cow and plan.cached_tokens == 7
    pool.audit()


def test_stepper_fault_reaches_waiters_and_the_driver_recovers(armed):
    _, tc, _, tp = _weights("llama", 2)
    prompt = _prompts()[1]
    want, _ = _run_port(tc, tp, prompts=[prompt])
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", **ENGINE)
    driver = DynamicBatchingDriver(eng, crash_backoff_base=0.01)
    armed("stepper-step")
    rid, done = driver.submit(prompt, MAX_NEW, SamplingParams(greedy=True))
    assert done.wait(timeout=60)
    with pytest.raises(chaos.ChaosFault):
        driver.result_tokens(rid)
    assert driver.stats()["restarts"] == 1
    with driver._cv:        # the stepper drops all work under this lock
        assert not eng.has_work
        eng.pool.audit()
        assert eng.pool.blocks_in_use() == 0
    rid, done = driver.submit(prompt, MAX_NEW, SamplingParams(greedy=True))
    assert done.wait(timeout=60)
    assert driver.result_tokens(rid).tolist() == want[0]


def test_run_records_metrics_and_a_paired_request_trace():
    _, tc, _, tp = _weights("llama", 2)
    tracer = get_request_tracer()
    telemetry.enable()
    tracer.reset()
    tracer.configure(enabled=True)
    try:
        _, stats = _run_port(tc, tp)
        n = len(_prompts())
        assert telemetry.counter_value("serving_requests_admitted") == n
        assert telemetry.counter_value("serving_requests_retired") == n
        assert (telemetry.counter_value("paged_preemptions")
                == stats["preemptions"] > 0)
        snap = telemetry.snapshot()
        assert snap["histograms"]["serving_ttft_ms"]["count"] == n
        text = telemetry.render_prometheus()
        assert "# TYPE serving_ttft_ms histogram" in text
        assert 'serving_ttft_ms_bucket{le="+Inf"} ' + str(n) in text
        events = tracer.chrome_trace()["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X"]
        requests = {e["tid"] for e in spans if e["name"] == "request"}
        assert requests == set(range(1, n + 1))
        # Every opened span closed: as many X events as B records.
        opened = [r for r in tracer.dump() if r["ph"] == "B"]
        assert len(spans) == len(opened) + 1     # + the trace window
    finally:
        tracer.configure(enabled=False)
        tracer.reset()
        telemetry.disable()


# ---------------------------------------------------------------------------
# the REST / WebSocket server over the port's engine
# ---------------------------------------------------------------------------


def _server():
    from megatronapp_tpu_torch.data.tokenizers import NullTokenizer
    from megatronapp_tpu_torch.inference.server import TextGenerationServer
    _, tc, _, tp = _weights("llama", 2)
    eng = tde.DynamicInferenceEngine(tp, tc, tokenizer=NullTokenizer(128),
                                     device="cpu", **ENGINE)
    return TextGenerationServer(eng)


def test_server_rest_stats_healthz():
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    srv = _server()

    async def run():
        client = TestClient(TestServer(srv.build_app()))
        await client.start_server()
        try:
            resp = await client.put("/api", json={
                "prompts": ["1 2 3", "4 5 6 7"], "tokens_to_generate": 4,
                "greedy": True})
            assert resp.status == 200
            data = await resp.json()
            assert [t.startswith(p) for t, p in
                    zip(data["text"], ("1 2 3", "4 5 6 7"))] == [True, True]
            assert all(len(s.split()) == 4 for s in data["segments"])
            resp = await client.put("/api", json={"nope": 1})
            assert resp.status == 400
            stats = await (await client.get("/stats")).json()
            assert stats["engine"] == "dynamic"
            assert stats["pool"]["prefill_tokens"] == 7
            health = await client.get("/healthz")
            assert health.status == 200
            assert (await health.json())["status"] == "ok"
            assert (await client.get("/metrics")).status == 200
        finally:
            await client.close()

    asyncio.run(run())


def test_server_ws_streams_tokens():
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    srv = _server()

    async def run():
        client = TestClient(TestServer(srv.build_app()))
        await client.start_server()
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_json({"prompt": "1 2 3", "tokens_to_generate": 3,
                                "greedy": True})
            tokens, done = [], None
            while done is None:
                msg = await ws.receive_json(timeout=60)
                if msg["type"] == "token":
                    tokens.append(msg["token"])
                elif msg["type"] == "done":
                    done = msg
            assert len(tokens) == 3
            assert done["text"] == " ".join(map(str, tokens))
            await ws.send_json({"prompt": "1 2", "tokens_to_generate": 2,
                                "visualization": {"qkv": [0]}})
            msg = await ws.receive_json(timeout=60)
            assert msg["type"] == "error" and msg["message"] == (
                "visualization requires --engine static (the "
                "continuous-batching backend shares one step loop across "
                "connections)")
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())
