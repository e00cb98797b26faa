"""The port's speculative decoding pieces against the JAX package's.

The exact rejection-sampling verifier on JAX's inputs (greedy rows'
accepted counts and tokens equal JAX's exactly, for a point-mass and a
full-q proposal, beside sampled rows; sampled rows' first emitted token
distributed as the warped target within a stated total-variation bound),
the n-gram lookup, the pool's speculative books (extend_capacity and
rewind against JAX's PagedKVCache over the same operations; rewind refuses
a shared block), the dense-cache steps the draft model runs (_decode_step
and _forward_with_cache logits against JAX's, fp32), the fall-backs and
refusals with JAX's messages, the ``spec-verify`` drill, sampled streams,
/stats and /metrics, and serve.py's speculation flags. Whole engines
against JAX's speculative engine: tests/test_torch_spec_engine.py.
"""

import argparse
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import ENGINE, MAX_NEW, _prompts, _weights

from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference import engine as jeng
from megatronapp_tpu.inference import speculative as jsp
from megatronapp_tpu.inference.paged_cache import PagedKVCache as JPool
from megatronapp_tpu_torch import serve
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference import engine as teng
from megatronapp_tpu_torch.inference import speculative as tsp
from megatronapp_tpu_torch.inference.engine import SamplingParams
from megatronapp_tpu_torch.inference.paged_cache import PagedKVCache as TPool
from megatronapp_tpu_torch.inference.server import TextGenerationServer
from megatronapp_tpu_torch.utils import chaos
from megatronapp_tpu_torch.utils import metrics as telemetry

# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------


def _rows(b, sampled, steps=None, temp=0.9, top_k=0, top_p=0.0):
    """Sampling rows for b slots: request id = row, seed 3; `sampled` rows
    sample, the others are greedy."""
    sampled = np.asarray(sampled, bool)
    return {"seeds": np.full(b, 3, np.int64),
            "rids": np.arange(b, dtype=np.int64),
            "steps": (np.zeros(b, np.int64) if steps is None
                      else np.asarray(steps, np.int64)),
            "temps": np.full(b, temp, np.float32),
            "top_ks": np.full(b, top_k, np.int32),
            "top_ps": np.full(b, top_p, np.float32),
            "sampled": sampled}


def _jax_verify(logits, drafts, q_lens, q_probs, rows, point_mass):
    fn = jsp.build_verify_sampler(point_mass=point_mass)
    a, out = fn(jnp.asarray(logits), jnp.asarray(drafts),
                jnp.asarray(q_lens), None if point_mass
                else jnp.asarray(q_probs),
                jnp.asarray(rows["seeds"], jnp.int32),
                jnp.asarray(rows["rids"], jnp.int32),
                jnp.asarray(rows["steps"], jnp.int32),
                jnp.asarray(rows["temps"]), jnp.asarray(rows["top_ks"]),
                jnp.asarray(rows["top_ps"]),
                jnp.asarray(~rows["sampled"]))
    return np.asarray(a), np.asarray(out)


@pytest.mark.parametrize("point_mass", [True, False])
def test_verifier_greedy_rows_equal_jax(point_mass):
    """Greedy rows of a batch that also holds sampled rows: accepted
    counts and output tokens equal JAX's _verify_and_sample exactly, with
    drafts that follow the argmax chain for 0..k positions and every
    draft count."""
    rng = np.random.default_rng(0)
    b, k, v = 12, 4, 16
    logits = rng.normal(size=(b, k + 1, v)).astype(np.float32) * 2
    am = logits.argmax(-1)
    drafts = rng.integers(0, v, (b, k)).astype(np.int32)
    follow = rng.integers(0, k + 1, b)
    for i in range(b):
        drafts[i, :follow[i]] = am[i, :follow[i]]
    q_lens = rng.integers(1, k + 2, b).astype(np.int32)
    q = rng.random((b, k, v)).astype(np.float32)
    q /= q.sum(-1, keepdims=True)
    sampled = np.arange(b) % 3 == 2
    rows = _rows(b, sampled)
    want_a, want_out = _jax_verify(logits, drafts, q_lens, q, rows,
                                   point_mass)
    got_a, got_out = tsp._verify_and_sample(
        torch.from_numpy(logits), drafts, q_lens,
        None if point_mass else torch.from_numpy(q), rows,
        point_mass=point_mass)
    g = ~sampled
    np.testing.assert_array_equal(got_a[g], want_a[g])
    np.testing.assert_array_equal(got_out[g], want_out[g])
    assert (got_a <= q_lens - 1).all()
    assert len(set(got_a[g].tolist())) > 2      # the cases differ


# Monte-Carlo bound: 8000 draws over 16 tokens put the total variation
# of an exact sampler near 0.017 (sum over tokens of sqrt(2 p (1 - p) /
# (pi n))); 0.05 is three times that.
TV_BOUND = 0.05
TV_DRAWS = 8000


@pytest.mark.parametrize("point_mass", [True, False])
def test_verifier_sampled_first_token_distribution(point_mass):
    """Rejection sampling is exact: the first emitted token of a round is
    distributed as the warped target p, whatever the proposal (every row
    is one trial on its own request id's streams)."""
    rng = np.random.default_rng(1)
    n, k, v = TV_DRAWS, 2, 16
    logits1 = rng.normal(size=(k + 1, v)).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(logits1, (n, k + 1, v)).copy())
    ql = rng.normal(size=(k, v))
    q1 = (np.exp(ql) / np.exp(ql).sum(-1, keepdims=True)).astype(np.float32)
    if point_mass:
        drafts = rng.integers(0, v, (n, k)).astype(np.int32)
        q_probs = None
    else:
        # The proposer's contract: drafts are drawn from q.
        u = rng.random((n, k))
        drafts = np.minimum((u[..., None] > np.cumsum(q1, -1)[None]).sum(-1),
                            v - 1).astype(np.int32)
        q_probs = torch.from_numpy(np.broadcast_to(q1, (n, k, v)).copy())
    rows = _rows(n, np.ones(n, bool))
    a, out = tsp._verify_and_sample(logits, drafts,
                                    np.full(n, k + 1, np.int32), q_probs,
                                    rows, point_mass=point_mass)
    first = np.where(a >= 1, drafts[:, 0], out)
    emp = np.bincount(first, minlength=v) / n
    p = np.exp(logits1[0] / 0.9 - (logits1[0] / 0.9).max())
    p /= p.sum()
    tv = 0.5 * np.abs(emp - p).sum()
    assert tv < TV_BOUND, (tv, emp, p)


def test_verifier_bonus_is_the_plain_sampler_draw():
    """A sampled row whose drafts are all accepted draws its bonus token as
    _sample_rows draws the plain step at that generated index."""
    rng = np.random.default_rng(2)
    v, k = 16, 3
    logits = np.zeros((1, k + 1, v), np.float32)
    logits[0, :k, 5] = 40.0       # every draft is certain to be accepted
    logits[0, k] = rng.normal(size=v)
    rows = _rows(1, [True], steps=[7])
    a, out = tsp._verify_and_sample(torch.from_numpy(logits),
                                    np.full((1, k), 5, np.int32),
                                    np.asarray([k + 1], np.int32), None,
                                    rows, point_mass=True)
    assert a[0] == k
    plain = tde._sample_rows(torch.from_numpy(logits[:, k]),
                             _rows(1, [True], steps=[7 + k]))
    assert out[0] == int(plain[0])


# ---------------------------------------------------------------------------
# n-gram lookup
# ---------------------------------------------------------------------------


def test_ngram_lookup_matches_jax():
    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, vocab, n).astype(np.int32)
              for vocab, n in ((4, 20), (8, 40), (128, 30), (3, 2), (5, 1))]
    arrays += [np.tile(rng.integers(0, 50, p), 4).astype(np.int32)
               for p in (1, 3, 7)]
    arrays.append(np.asarray([5, 6, 7, 8, 1, 2, 5, 6, 7], np.int32))
    for t in arrays:
        for k in (1, 2, 4):
            for max_n, min_n in ((3, 1), (2, 2), (4, 1)):
                want = jsp._ngram_lookup(t, k, max_n, min_n)
                got = tsp._ngram_lookup(t, k, max_n, min_n)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the pool's speculative books
# ---------------------------------------------------------------------------


def _books(pool):
    return (pool.page_table.tolist(), pool._refcount.tolist(),
            list(pool._free), list(pool._lru),
            [list(b) for b in pool._slot_blocks])


def test_extend_capacity_and_rewind_books_match_jax():
    """The same admissions, speculative extensions, rewinds, releases and
    a prefix hit give the same page tables, refcounts, free and LRU lists
    on both pools, and the same granted spans."""
    jc, tc, _, _ = _weights("llama")
    jpool = JPool(jc, 2, 40, num_blocks=9, block_size=4)
    tpool = TPool(tc, 2, 40, num_blocks=9, block_size=4)
    rng = np.random.default_rng(4)
    a = rng.integers(0, 128, 10).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, 128, 3)]).astype(np.int32)
    ops = [("admit", 0, a), ("extend", 0, 10, 4), ("rewind", 0, 12),
           ("extend", 0, 12, 9), ("rewind", 0, 11),
           ("register", 0, a, 10), ("admit", 1, b),
           ("extend", 1, 11, 30), ("extend", 0, 11, 3),
           ("rewind", 1, 11), ("release", 0, a, 10), ("extend", 1, 11, 12),
           ("rewind", 1, 13), ("release", 1, b, 11)]
    for op in ops:
        got = []
        for pool in (jpool, tpool):
            name, slot, *args = op
            if name == "admit":
                plan = pool.admit(slot, args[0])
                got.append((plan.blocks, plan.cached_tokens, plan.cow))
            elif name == "extend":
                got.append(pool.extend_capacity(slot, *args))
            elif name == "rewind":
                got.append(pool.rewind(slot, *args))
            elif name == "register":
                got.append(pool.register_prefix(slot, *args))
            else:
                got.append(pool.release(slot, *args))
            pool.audit()
        assert got[0] == got[1], op
        assert _books(tpool) == _books(jpool), op
    assert tpool.stats["prefix_hit_tokens"] == 8


def test_rewind_refuses_a_shared_block():
    _, tc, _, _ = _weights("llama")
    pool = TPool(tc, 2, 40, num_blocks=9, block_size=4)
    toks = np.arange(9, dtype=np.int32)
    pool.admit(0, toks)
    pool.register_prefix(0, toks, 9)
    pool.admit(1, toks)                          # hits blocks 0 and 1
    with pytest.raises(AssertionError, match="shared/hashed"):
        pool.rewind(1, 1)


# ---------------------------------------------------------------------------
# the dense-cache steps of the draft model
# ---------------------------------------------------------------------------

DENSE_TOL = 1e-5


def _close(got, want):
    """Within DENSE_TOL of the largest element (fp32 through two
    layers)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=DENSE_TOL * scale, rtol=0)


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_forward_with_cache_and_decode_step_match_jax(arch):
    """A static prefill at cache_index 0 and a second chunk at its offset
    (_forward_with_cache), then a per-row dense decode step (_decode_step)
    at different lengths a row: logits and caches against JAX's."""
    jc, tc, jp, tp = _weights(arch)
    b, smax = 3, 24
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 128, (b, 7)).astype(np.int32)
    jcache = jeng.init_kv_cache(jc, b, smax)
    tcache = teng.init_kv_cache(tc, b, smax)
    for start, stop in ((0, 5), (5, 7)):
        j_logits, jcache = jeng._forward_with_cache(
            jp, jnp.asarray(toks[:, start:stop]), jcache, start, jc)
        t_logits, tcache = teng._forward_with_cache(
            tp, torch.from_numpy(toks[:, start:stop]), tcache, start, tc)
        _close(t_logits.numpy(), j_logits)
    lengths = np.asarray([7, 4, 6], np.int32)
    nxt = rng.integers(0, 128, (b, 1)).astype(np.int32)
    j_logits, jcache = jde._decode_step(
        jp, jnp.asarray(nxt), jcache, jnp.asarray(lengths),
        jnp.ones(b, bool), jc)
    t_logits, tcache = tde._decode_step(
        tp, torch.from_numpy(nxt), tcache, torch.from_numpy(lengths), tc)
    _close(t_logits.numpy(), j_logits)
    for got, want in zip(tcache, jcache):
        _close(got.numpy(), want)


def test_dense_branch_needs_its_mask():
    """The per-row append refuses to run without its per-row mask (JAX's
    message)."""
    _, tc, _, tp = _weights("llama")
    from megatronapp_tpu_torch.transformer.attention import attention_forward
    cache = teng.init_kv_cache(tc, 2, 8)
    with pytest.raises(ValueError, match="explicit per-row attention_mask"):
        attention_forward(tp["layers"][0]["attention"],
                          torch.zeros(2, 1, tc.hidden_size), tc,
                          kv_cache=(cache[0][0], cache[1][0]),
                          cache_positions=torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# fall-backs and refusals (JAX's messages)
# ---------------------------------------------------------------------------


def test_fallbacks_and_refusals_use_jax_messages():
    _, tc, _, tp = _weights("llama")
    telemetry.enable()
    try:
        with pytest.warns(UserWarning, match="no MTP depth modules"):
            eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                             spec_method="mtp", **ENGINE)
        assert eng.spec_method is None and eng.proposer is None
        assert telemetry.counter_value("spec_proposer_fallbacks") == 1
        with pytest.warns(UserWarning, match="without draft_params"):
            eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                             spec_method="draft", **ENGINE)
        assert eng.spec_method is None
        assert telemetry.counter_value("spec_proposer_fallbacks") == 2
    finally:
        telemetry.disable()
    # The fallen-back engine decodes plainly.
    rid = eng.add_request(_prompts()[0], 3, SamplingParams(greedy=True))
    assert len(eng.run_to_completion()[rid]) == len(_prompts()[0]) + 3
    small = dataclasses.replace(tc, vocab_size=64)
    with pytest.raises(ValueError, match="must match the target vocab"):
        tde.DynamicInferenceEngine(tp, tc, device="cpu", spec_method="draft",
                                   draft_params=tp, draft_cfg=small,
                                   **ENGINE)
    with pytest.raises(ValueError, match="runs over the paged-KV engine"):
        tde.DynamicInferenceEngine(tp, tc, device="cpu", paged=False,
                                   spec_method="ngram")
    with pytest.raises(ValueError, match="unknown spec_method"):
        tde.DynamicInferenceEngine(tp, tc, device="cpu", spec_method="tree",
                                   **ENGINE)
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.parallel.mesh import MeshContext
    ctx = MeshContext(group=None, parallel=ParallelConfig(tensor_parallel=2),
                      rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        tde.DynamicInferenceEngine(tp, tc, device="cpu", ctx=ctx,
                                   spec_method="ngram", **ENGINE)
    # An MLA model cannot be a draft: its dense cache is not ported.
    from test_torch_mla import mla_pair
    _, mla = mla_pair()
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        teng.init_kv_cache(mla, 2, 8)


def test_speculative_engine_needs_a_card_unless_asked_for_the_cpu():
    _, tc, _, tp = _weights("llama")
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tde.DynamicInferenceEngine(tp, tc, spec_method="ngram", **ENGINE)


# ---------------------------------------------------------------------------
# the spec-verify drill, sampled streams, /stats and /metrics
# ---------------------------------------------------------------------------


def _repetitive_prompts():
    rng = np.random.default_rng(6)
    return [np.tile(rng.integers(0, 127, n), 3).astype(np.int32)
            for n in (3, 4)] + _prompts()[:2]


def _port(method="ngram", k=3, sampling=None, prompts=None, fault=False,
          **kw):
    """A port engine over `prompts`, stepped directly (audited after every
    step); with `fault`, the spec-verify site fires once, after one
    round. Returns (streams, faults, engine)."""
    _, tc, _, tp = _weights("llama")
    if method == "draft":
        kw.update(draft_params=tp, draft_cfg=tc)
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     spec_method=method, spec_k=k,
                                     **{**ENGINE, **kw})
    prompts = _repetitive_prompts() if prompts is None else prompts
    ids = [eng.add_request(p, MAX_NEW, sampling or SamplingParams(
        greedy=True)) for p in prompts]
    faults = 0
    if fault:
        chaos.arm("spec-verify", times=1, after=1)
    try:
        while eng.has_work:
            try:
                eng.step()
            except chaos.ChaosFault:
                faults += 1
            eng.pool.audit()
    finally:
        chaos.disarm()
    return [eng.requests[r].tokens.tolist() for r in ids], faults, eng


@pytest.mark.parametrize("method", ["ngram", "draft"])
def test_spec_verify_drill_keeps_stream_and_books(method):
    clean, _, eng = _port(method)
    faulted, faults, feng = _port(method, fault=True)
    assert faults == 1
    assert faulted == clean
    assert feng.pool.blocks_in_use() == 0
    assert eng.spec_stats["rounds"] > 0
    # The failed round counts nothing, and the retried round proposes and
    # accepts what the clean run's did: the draft's cache is rewound too.
    for key in ("rounds", "proposed", "accepted"):
        assert feng.spec_stats[key] == eng.spec_stats[key], key


SAMPLED = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=5)


@pytest.mark.parametrize("method", ["ngram", "draft"])
def test_sampled_streams_reproducible_and_batch_independent(method):
    a, _, eng = _port(method, sampling=SAMPLED)
    b, _, _ = _port(method, sampling=SAMPLED)
    alone, _, _ = _port(method, sampling=SAMPLED,
                        prompts=_repetitive_prompts()[:1])
    greedy, _, _ = _port(method)
    assert a == b
    assert a[0] == alone[0]
    assert a != greedy
    assert eng.spec_stats["proposed"] > 0


@pytest.mark.parametrize("method", ["ngram", "draft"])
def test_same_prompt_gives_distinct_sampled_streams(method):
    p = _repetitive_prompts()[0]
    streams, _, _ = _port(method, sampling=SAMPLED, prompts=[p, p])
    assert streams[0] != streams[1]


def test_stats_and_metrics_report_speculation():
    telemetry.enable()
    try:
        _, _, eng = _port("draft")
        snap = TextGenerationServer(eng, "localhost", 0).stats_snapshot()
        text = telemetry.render_prometheus()
    finally:
        telemetry.disable()
    spec = snap["speculative"]
    ss = eng.spec_stats
    assert spec["method"] == "draft" and spec["k"] == 3
    assert spec["rounds"] == ss["rounds"] > 0
    assert spec["acceptance_rate"] == round(ss["accepted"] / ss["proposed"],
                                            4)
    assert spec["tokens_per_step"] == round(
        ss["emitted_tokens"] / ss["model_steps"], 4)
    assert spec["tokens_per_step"] > 1.0       # the self-draft accepts
    for name in ("spec_proposed_tokens", "spec_accepted_tokens",
                 "serving_tokens_emitted", "spec_accepted_per_round"):
        assert name in text
    reqs = list(eng.requests.values())
    assert sum(r.spec_proposed for r in reqs) == ss["proposed"]
    assert sum(r.spec_accepted for r in reqs) == ss["accepted"]


def test_spec_rounds_trace_their_span():
    from megatronapp_tpu_torch.trace.request_trace import get_request_tracer
    rt = get_request_tracer()
    rt.reset()
    rt.configure(enabled=True)
    try:
        _port("ngram")
        names = {e["name"] for e in rt.chrome_trace()["traceEvents"]}
    finally:
        rt.configure(enabled=False)
        rt.reset()
    assert "spec-round" in names


# ---------------------------------------------------------------------------
# serve.py
# ---------------------------------------------------------------------------

BASE = ["--engine", "dynamic", "--paged-kv-cache"]


def test_serve_spec_flags_parse_with_jax_choices_and_defaults():
    args = serve.parse_args(BASE)
    assert (args.spec_method, args.spec_k, args.draft_model) == (
        "none", 4, None)
    args = serve.parse_args(BASE + ["--spec-method", "ngram", "--spec-k",
                                    "2"])
    assert (args.spec_method, args.spec_k) == ("ngram", 2)
    args = serve.parse_args(BASE + ["--spec-method", "draft",
                                    "--draft-model", "gpt2-125m"])
    assert args.draft_model == "gpt2-125m"
    for method in ("none", "draft", "mtp", "ngram"):
        serve.parse_args(BASE + ["--spec-method", method]
                         + (["--draft-model", "gpt2-125m"]
                            if method == "draft" else []))


@pytest.mark.parametrize("argv,message", [
    (["--spec-method", "tree"], "invalid choice"),
    (["--spec-method", "draft"], "--spec-method draft needs --draft-model"),
    (["--spec-method", "draft", "--draft-model", "gpt2-125m",
      "--load-quantized", "/x"], "int8 checkpoints"),
    (["--spec-method", "ngram", "--serve-tp", "2"], "Queue 1 item 1"),
])
def test_serve_spec_flags_refused(argv, message, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(BASE + argv)
    assert message in capsys.readouterr().err


def test_serve_builds_a_speculative_engine():
    args = serve.parse_args(BASE + [
        "--preset", "gpt2-125m", "--num-layers", "1", "--device", "cpu",
        "--params-dtype", "fp32", "--max-seq-len", "32", "--max-batch", "2",
        "--spec-method", "ngram", "--spec-k", "3"])
    eng = serve.build_engine(args)
    assert eng.spec_method == "ngram" and eng.spec_k == 3
    assert eng.mq_rows == max(2 * 4, 32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        args = argparse.Namespace(**{**vars(args), "spec_method": "mtp"})
        with pytest.raises(UserWarning, match="no MTP depth modules"):
            serve.build_engine(args)
