"""The port's batched-LoRA serving engine against the JAX package's.

The same weights (the JAX init with init_method_std 0.4, every leaf
perturbed, carried across by ``convert.params_from_jax``; resident int8 on
both sides for the quantized base) and the same adapters (JAX's
``LoraAdapter.random`` at scale 2.0, so that an adapter changes a greedy
stream, carried across by ``convert.adapter_from_jax``) serve the same five
prompts greedily, four of them on four distinct adapters, through JAX's
``DynamicInferenceEngine`` and the port's with an ``AdapterCache`` each:
unfused and fused, bf16 and resident-int8 base. Two of the prompts (on
adapter t1 and on none) share a 12-token prefix: the port salts its
prefix keys with the adapter, so neither reuses the other's KV, and the
JAX oracle runs with prefix caching off, which serves each request as if
alone (JAX's keys hold tokens only and would share that KV). Streams must
be token-exact, and the pool's and the cache's books equal. The
undersized pool preempts, so adapters are released and re-acquired on the
way. JAX's steps run to completion before its engine goes on
(``_run_jax`` in tests/test_torch_engine.py says why).

Then the port's own invariants: zero-B adapters leave streams bitwise
unchanged; a mixed batch of four adapters decodes in one step, token-exact
against serving each request alone, with the books audited after every
step; a cache smaller than the batch's adapters waits on pinned slots and
evicts; the ``lora-load`` drill leaves the books untouched and requeues
the request; the serving flags are refused with JAX's messages; the
driver forwards ``adapter_id`` and refuses ``tenant``.
"""

import argparse
import functools

import numpy as np
import pytest
from test_torch_engine import MAX_NEW, _prompts, _synchronous
from test_torch_quant_engine import _params

from megatronapp_tpu.config.arguments import validate_serving_args
from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference import lora as jl
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu_torch import serve
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference import lora as tl
from megatronapp_tpu_torch.inference.engine import SamplingParams
from megatronapp_tpu_torch.inference.server import DynamicBatchingDriver
from megatronapp_tpu_torch.models.convert import adapter_from_jax
from megatronapp_tpu_torch.utils import chaos

ENGINE = dict(max_batch=4, max_seq_len=64, block_size=4, num_blocks=16,
              prefill_chunk=8)
RANK = 4
IDS = ["t0", "t1", "t2", "t3"]
ROUTE = ["t0", "t1", "t2", None, "t3"]     # the five prompts' adapters
# The pool's books held against the JAX oracle. Evictions are not among
# them: the oracle's pool caches no prefix, so it never parks a block.
POOL_STATS = ("preemptions", "prefix_hit_tokens", "prefill_tokens")
CACHE_STATS = ("hits", "misses", "evictions", "resident", "pinned")


@functools.lru_cache(maxsize=None)
def _jax_adapters(zero_b=False):
    jc = _params("llama", "plain")[0]
    return tuple(jl.LoraAdapter.random(a, jc, rank=RANK, seed=40 + i,
                                       scale=2.0, zero_b=zero_b)
                 for i, a in enumerate(IDS))


def _jax_cache(jc, max_resident=4):
    reg = jl.AdapterRegistry()
    for ad in _jax_adapters():
        reg.register(ad)
    return jl.AdapterCache(jc, reg, max_resident=max_resident, rank=RANK)


def _port_cache(tc, max_resident=4, zero_b=False):
    reg = tl.AdapterRegistry()
    for ad in _jax_adapters(zero_b):
        reg.register(adapter_from_jax(ad))
    return tl.AdapterCache(tc, reg, max_resident=max_resident, rank=RANK,
                           device="cpu")


def _run_jax(jc, jp, fused, prefix_caching=False, prompts=None,
             route=None):
    """JAX's LoRA engine; prefix caching is off by default, which serves
    each request as if alone (the oracle of the port's salted keys)."""
    prompts = _prompts() if prompts is None else prompts
    route = ROUTE if route is None else route
    eng = jde.DynamicInferenceEngine(jp, jc, paged=True, fused_decode=fused,
                                     adapter_cache=_jax_cache(jc),
                                     enable_prefix_caching=prefix_caching,
                                     **ENGINE)
    assert eng.megakernel is fused
    eng._decode = _synchronous(eng._decode)
    eng._mq_step = _synchronous(eng._mq_step)
    ids = [eng.add_request(p, MAX_NEW, JSampling(greedy=True), adapter_id=a)
           for p, a in zip(prompts, route)]
    res = eng.run_to_completion()
    eng.adapters.audit()
    return ([res[r].tolist() for r in ids], dict(eng.pool.stats),
            eng.adapters.stats_snapshot())


def _port_engine(tc, tp, fused=False, cache="default", **kw):
    if cache == "default":
        cache = _port_cache(tc)
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     fused_decode=fused,
                                     adapter_cache=cache, **{**ENGINE, **kw})
    assert eng.megakernel is fused
    return eng


def _run_port(eng, prompts=None, route=None, audit_every_step=False):
    prompts = _prompts() if prompts is None else prompts
    route = ROUTE if route is None else route
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True),
                           adapter_id=a) for p, a in zip(prompts, route)]
    if audit_every_step:
        res = {}
        while eng.has_work:
            for rid in eng.step()["finished"]:
                res[rid] = eng.requests.pop(rid).tokens
            eng.pool.audit()
            if eng.adapters is not None:
                eng.adapters.audit()
    else:
        res = eng.run_to_completion()
    eng.pool.audit()
    return [res[r].tolist() for r in ids]


def _distinct_prompts(n=4, seed=2):
    """Prompts that share no prefix block: with one, the prefix cache
    would hand one tenant's KV to another (ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 127, int(rng.integers(6, 14))).astype(np.int32)
            for _ in range(n)]


CASES = [(w, s) for w in ("plain", "resident_int8")
         for s in ("unfused", "fused")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def runs(request):
    weights, step = request.param
    jc, tc, jp, tp = _params("llama", weights)
    fused = step == "fused"
    eng = _port_engine(tc, tp, fused)
    streams = _run_port(eng)
    return (request.param, _run_jax(jc, jp, fused),
            (streams, dict(eng.pool.stats), eng))


def test_lora_streams_token_exact_with_jax(runs):
    _, (j_streams, _, _), (t_streams, _, _) = runs
    assert t_streams == j_streams


def test_lora_books_match_jax(runs):
    """Pool and adapter-cache books equal on both engines; the undersized
    pool preempts (releasing and re-acquiring adapters), and nothing stays
    pinned."""
    _, (_, j_pool, j_lora), (_, t_pool, eng) = runs
    for key in POOL_STATS:
        assert t_pool[key] == j_pool[key], key
    assert t_pool["preemptions"] > 0
    t_lora = eng.adapters.stats_snapshot()
    for key in CACHE_STATS:
        assert t_lora[key] == j_lora[key], key
    assert t_lora["pinned"] == 0 and t_lora["misses"] == len(IDS)
    eng.adapters.audit()
    snap = eng.stats_snapshot()
    assert snap["lora"]["resident_ids"] == IDS
    assert snap["lora"]["bank_bytes"] == eng.adapters.bank_bytes()


def test_adapters_change_the_streams():
    """At least one adapter moves its request's greedy stream off the base
    model's (the parity tests above would pass vacuously otherwise), and
    the request without one keeps the base stream. The prefix cache is off
    here, so that both runs prefill every token."""
    _, tc, _, tp = _params("llama", "plain")
    base = _run_port(_port_engine(tc, tp, cache=None,
                                  enable_prefix_caching=False),
                     route=[None] * 5)
    adapted = _run_port(_port_engine(tc, tp, enable_prefix_caching=False))
    assert adapted[3] == base[3]                    # the no-adapter request
    assert any(a != b for a, b in zip(adapted, base))


def _shared_prefix_prompts(seed=3):
    """Three prompts whose first two blocks (8 tokens at block size 4)
    are the same, with tails of their own."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 127, 8)
    return [np.concatenate([shared, rng.integers(0, 127, n)]).astype(
        np.int32) for n in (3, 5, 6)]


@functools.lru_cache(maxsize=None)
def _jax_shared_prefix(order, prefix_caching=False):
    """(prompts, route, JAX streams, JAX pool books) of the shared-prefix
    requests in `order`."""
    jc, _, jp, _ = _params("llama", "plain")
    prompts = _shared_prefix_prompts()
    route = ["t0", "t1", "t0"]
    if order == "t1-first":
        prompts = [prompts[1], prompts[0], prompts[2]]
        route = ["t1", "t0", "t0"]
    streams, pool, _ = _run_jax(jc, jp, False, prefix_caching, prompts,
                                route)
    return prompts, route, streams, pool


@pytest.mark.parametrize("order", ["t0-first", "t1-first"])
def test_salted_prefix_keys_serve_each_adapter_alone(order):
    """Requests on adapters t0 and t1 share a 2-block prompt prefix; in
    either submission order each greedy stream equals JAX's with prefix
    caching off (each request served as if alone), so neither read KV
    computed under the other's deltas. A third request on t0 over the
    same prefix still hits t0's two blocks."""
    _, tc, _, tp = _params("llama", "plain")
    prompts, route, want, j_pool = _jax_shared_prefix(order)
    eng = _port_engine(tc, tp, num_blocks=40)
    assert _run_port(eng, prompts, route) == want
    assert j_pool["prefix_hit_tokens"] == 0
    assert eng.pool.stats["prefix_hit_tokens"] == 8
    assert eng.pool.stats["cow_copies"] == 0


def test_unsalted_keys_move_the_other_adapters_stream():
    """The test above is not vacuous: JAX's unsalted keys hand t1's
    request t0's two prefix blocks, and its stream moves off the one it
    has served alone."""
    alone = _jax_shared_prefix("t0-first")[2]
    _, _, shared, pool = _jax_shared_prefix("t0-first", True)
    assert pool["prefix_hit_tokens"] == 16
    assert shared[1] != alone[1]


def test_null_adapter_prefix_keys_are_unchanged():
    """Without an adapter the keys are JAX's, byte for byte; an adapter id
    salts every key of the chain, and two adapters never share one."""
    from megatronapp_tpu.inference import paged_cache as jpc
    from megatronapp_tpu_torch.inference import paged_cache as tpc
    toks = _shared_prefix_prompts()[2]
    base = tpc.prefix_block_keys(toks, 4, len(toks))
    assert base == jpc.prefix_block_keys(toks, 4, len(toks))
    assert base == tpc.prefix_block_keys(toks, 4, len(toks), None)
    t0 = tpc.prefix_block_keys(toks, 4, len(toks), "t0")
    t1 = tpc.prefix_block_keys(toks, 4, len(toks), "t1")
    assert len(t0) == len(base) == 3
    assert not set(t0) & set(base) and not set(t0) & set(t1)
    assert t0 == tpc.prefix_block_keys(toks, 4, len(toks), "t0")


@pytest.mark.parametrize("step", ["unfused", "fused"])
def test_zero_b_streams_bitwise_equal_the_no_adapter_engine(step):
    _, tc, _, tp = _params("llama", "plain")
    fused = step == "fused"
    base = _run_port(_port_engine(tc, tp, fused, cache=None),
                     route=[None] * 5)
    zero = _run_port(_port_engine(tc, tp, fused,
                                  cache=_port_cache(tc, zero_b=True)))
    assert zero == base


@pytest.mark.parametrize("weights", ["plain", "resident_int8"])
def test_mixed_batch_of_four_adapters_in_one_step_matches_serial(weights):
    """Four requests on four distinct adapters decode together (one step
    emits a token for each), token-exact against each request served
    alone; pool and cache audits pass after every step."""
    _, tc, _, tp = _params("llama", weights)
    prompts, route = _distinct_prompts(), IDS
    eng = _port_engine(tc, tp, num_blocks=40)
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True),
                           adapter_id=a) for p, a in zip(prompts, route)]
    streams = {r: [] for r in ids}
    together = False
    while eng.has_work:
        ev = eng.step()
        eng.pool.audit()
        eng.adapters.audit()
        emitted = {r for r, _ in ev["tokens"]}
        together |= set(ids) <= emitted and not ev["admitted"]
        for r, t in ev["tokens"]:
            streams[r].append(int(t))
    assert together
    for r, p, a in zip(ids, prompts, route):
        alone = _run_port(_port_engine(tc, tp, num_blocks=40), [p], [a])
        assert streams[r] == alone[0][len(p):]


def test_pinned_slots_wait_and_evict():
    """Two resident slots for four adapters: admission waits while both
    are pinned, retirements unpin, misses evict the least recently used;
    the streams are those of a cache that holds all four."""
    _, tc, _, tp = _params("llama", "plain")
    eng = _port_engine(tc, tp, cache=_port_cache(tc, max_resident=2),
                       num_blocks=40)
    prompts = _distinct_prompts()
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True),
                           adapter_id=a) for p, a in zip(prompts, IDS)]
    first = eng.step()
    assert sorted(first["admitted"]) == ids[:2]       # t2, t3 wait
    res = {}
    while eng.has_work:
        for rid in eng.step()["finished"]:
            res[rid] = eng.requests.pop(rid).tokens.tolist()
        eng.adapters.audit()
    st = eng.stats_snapshot()["lora"]
    assert st["evictions"] >= 2 and st["pinned"] == 0
    assert st["pinned_waits"] >= 1
    want = _run_port(_port_engine(tc, tp, num_blocks=40), prompts, IDS)
    assert [res[r] for r in ids] == want


def test_lora_load_drill_keeps_the_books_and_requeues():
    _, tc, _, tp = _params("llama", "plain")
    want = _run_port(_port_engine(tc, tp, num_blocks=40), _prompts()[:2],
                     IDS[:2])
    eng = _port_engine(tc, tp, num_blocks=40)
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True),
                           adapter_id=a)
           for p, a in zip(_prompts()[:2], IDS[:2])]
    chaos.arm("lora-load")
    try:
        with pytest.raises(chaos.ChaosFault):
            eng.step()
    finally:
        chaos.disarm()
    st = eng.adapters.stats_snapshot()
    assert st["load_faults"] == 1 and st["resident"] == 0
    assert [r.request_id for r in eng.waiting] == ids
    assert all(s is None for s in eng.slots)
    assert eng.pool.blocks_in_use() == 0
    eng.pool.audit()
    eng.adapters.audit()
    res = eng.run_to_completion()
    assert [res[r].tolist() for r in ids] == want


def _ns(**kw):
    base = dict(engine="dynamic", paged_kv_cache=True, lora_dir="d",
                lora_rank=8, max_resident_adapters=8)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw,mla", [
    (dict(paged_kv_cache=False), False),
    (dict(engine="static"), False),
    ({}, True),
    (dict(lora_rank=0), False),
    (dict(max_resident_adapters=0), False),
], ids=["no-paged-kv-cache", "static-engine", "mla", "rank-0",
        "no-resident-slots"])
def test_serve_lora_flags_refused_with_jax_messages(kw, mla, capsys):
    with pytest.raises(SystemExit) as j:
        validate_serving_args(_ns(**kw), multi_latent_attention=mla)
    with pytest.raises(SystemExit) as t:
        serve.validate_lora_args(_ns(**kw), multi_latent_attention=mla)
    assert str(t.value) == str(j.value)
    assert str(t.value).startswith(("--lora", "--max-resident-adapters"))
    serve.validate_lora_args(_ns())                 # the flags as given
    if not mla:
        argv = ["--engine", kw.get("engine", "dynamic"), "--lora-dir", "d",
                "--lora-rank", str(kw.get("lora_rank", 8)),
                "--max-resident-adapters",
                str(kw.get("max_resident_adapters", 8))]
        if kw.get("paged_kv_cache", True):
            argv.append("--paged-kv-cache")
        with pytest.raises(SystemExit):
            serve.parse_args(argv)
        assert str(t.value) in capsys.readouterr().err


def test_serve_builds_the_adapter_cache(tmp_path):
    from megatronapp_tpu_torch.models.presets import gpt2_125m
    cfg = gpt2_125m(num_layers=1)
    for i in range(3):
        tl.LoraAdapter.random(f"tenant-{i}", cfg, rank=2, seed=50 + i
                              ).save(str(tmp_path), quantize=i == 2)
    args = serve.parse_args([
        "--preset", "gpt2-125m", "--engine", "dynamic", "--paged-kv-cache",
        "--device", "cpu", "--num-layers", "1", "--max-seq-len", "32",
        "--max-batch", "2", "--lora-dir", str(tmp_path), "--lora-rank", "2",
        "--max-resident-adapters", "2"])
    eng = serve.build_engine(args)
    assert eng.adapters.registry.ids() == ["tenant-0", "tenant-1",
                                           "tenant-2"]
    assert (eng.adapters.rank, eng.adapters.max_resident) == (2, 2)
    rid = eng.add_request(np.arange(5), 2, SamplingParams(greedy=True),
                          adapter_id="tenant-2")
    assert len(eng.run_to_completion()[rid]) == 7
    assert eng.stats_snapshot()["lora"]["misses"] == 1


def test_driver_forwards_adapter_id_and_refuses_tenant():
    _, tc, _, tp = _params("llama", "plain")
    eng = _port_engine(tc, tp, num_blocks=40)
    driver = DynamicBatchingDriver(eng)
    prompt = _prompts()[1]
    rid, done = driver.submit(prompt, MAX_NEW, SamplingParams(greedy=True),
                              adapter_id="t1")
    assert done.wait(timeout=60)
    want = _run_port(_port_engine(tc, tp, num_blocks=40), [prompt], ["t1"])
    assert driver.result_tokens(rid).tolist() == want[0]
    with pytest.raises(KeyError, match="unknown adapter"):
        driver.submit(prompt, 2, SamplingParams(greedy=True),
                      adapter_id="nope")
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        driver.submit(prompt, 2, SamplingParams(greedy=True), tenant="acme")
    bare = _port_engine(tc, tp, cache=None)
    with pytest.raises(ValueError, match="adapter cache"):
        bare.add_request(prompt, 2, adapter_id="t1")
    assert "lora" not in bare.stats_snapshot()
    with pytest.raises(ValueError, match="device"):
        tde.DynamicInferenceEngine(
            tp, tc, device="cpu", adapter_cache=tl.AdapterCache(
                tc, tl.AdapterRegistry(), rank=RANK, device="meta"))
