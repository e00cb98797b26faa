"""The port's speculative engines against JAX's speculative engine.

The same weights (the JAX init, every leaf perturbed, carried across by
``convert.params_from_jax``) serve the same prompts greedily through JAX's
``DynamicInferenceEngine(spec_method=...)`` and the port's: the n-gram
proposer and the draft model (the target as its own draft, which accepts
nearly everything, and a perturbed copy, which rejects nearly everything),
k 1 and 4, on bf16 (here fp32), int8 and fp8 pools, unfused and fused, the
llama- and gpt2-shaped models, MLA with n-gram, and LoRA (prefix caching
off on JAX's side, as tests/test_torch_lora_engine.py says why). The
undersized pool of tests/test_torch_engine.py preempts and the shared
12-token prefix hits. Streams must be token-exact with JAX's speculative
streams and with the port's plain streams; the speculation counts and the
pools' books must equal JAX's. JAX's steps, its draft model's included,
run to completion before its engine goes on: its draft proposer bumps
``lens`` right after dispatching a step on an aliased ``jnp.asarray`` of
it, the fault ``_run_jax`` in tests/test_torch_engine.py names for
``lengths``.
"""

import functools

import jax
import numpy as np
import pytest
from test_torch_engine import ENGINE, MAX_NEW, _prompts, _synchronous
from test_torch_lora_engine import (
    ENGINE as LORA_ENGINE, ROUTE, _jax_cache, _port_cache,
)
from test_torch_mla_engine import _weights as _mla_weights
from test_torch_quant_engine import _params

from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference.engine import SamplingParams
from megatronapp_tpu_torch.models.convert import params_from_jax

STATS = ("preemptions", "prefix_hit_tokens", "prefill_tokens", "cow_copies",
         "evictions")
SPEC = ("rounds", "proposed", "accepted", "emitted_tokens", "model_steps")


def _spec_prompts():
    """Four of the engine tests' prompts (two share a 12-token prefix) and
    a repeated pattern, so that the n-gram proposer drafts."""
    rng = np.random.default_rng(5)
    return _prompts()[:4] + [np.tile(rng.integers(0, 127, 4),
                                     3).astype(np.int32)]


@functools.lru_cache(maxsize=None)
def _model(arch, draft):
    """(jax cfg, port cfg, JAX params, port params, JAX draft, port draft)
    for draft "self" (the target's own params) or "other" (the target
    with every leaf perturbed by N(0, 0.05))."""
    if arch == "mla":
        jc, tc, jp, tp = _mla_weights("q_proj")
    else:
        jc, tc, jp, tp = _params(arch, "plain")
    if draft == "other":
        rng = np.random.default_rng(9)
        npd = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
            size=a.shape)).astype(np.float32), jp)
        return jc, tc, jp, tp, jax.tree.map(jax.numpy.asarray, npd), \
            params_from_jax(npd, tc, "cpu")
    return jc, tc, jp, tp, jp, tp


def _spec_kw(method, k, draft_p, draft_c):
    kw = dict(spec_method=method, spec_k=k)
    if method == "draft":
        kw.update(draft_params=draft_p, draft_cfg=draft_c)
    return kw


def _run_jax(jc, jp, engine, prompts, routes=None, **kw):
    eng = jde.DynamicInferenceEngine(jp, jc, paged=True, **engine, **kw)
    eng._decode = _synchronous(eng._decode)
    eng._mq_step = _synchronous(eng._mq_step)
    if getattr(eng.proposer, "_step", None) is not None:
        eng.proposer._step = _synchronous(eng.proposer._step)
    routes = routes or [None] * len(prompts)
    ids = [eng.add_request(p, MAX_NEW, JSampling(greedy=True), adapter_id=a)
           for p, a in zip(prompts, routes)]
    res = eng.run_to_completion()
    return ([res[r].tolist() for r in ids], dict(eng.pool.stats),
            dict(eng.spec_stats), eng.megakernel)


def _run_port(tc, tp, engine, prompts, routes=None, **kw):
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", **engine, **kw)
    routes = routes or [None] * len(prompts)
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True),
                           adapter_id=a) for p, a in zip(prompts, routes)]
    while eng.has_work:
        eng.step()
        eng.pool.audit()
    out = [eng.requests[r].tokens.tolist() for r in ids]
    assert eng.pool.blocks_in_use() == 0
    return out, dict(eng.pool.stats), dict(eng.spec_stats), eng


@functools.lru_cache(maxsize=None)
def _plain(arch, kind, fused):
    _, tc, _, tp, _, _ = _model(arch, "self")
    streams, _, _, _ = _run_port(tc, tp, ENGINE, _spec_prompts(),
                                 kv_cache_dtype=kind, fused_decode=fused)
    return streams


CASES = [("llama", "bf16", "unfused", "ngram", 1, "self"),
         ("llama", "bf16", "unfused", "ngram", 4, "self"),
         ("llama", "bf16", "unfused", "draft", 1, "self"),
         ("llama", "bf16", "unfused", "draft", 4, "self"),
         ("llama", "bf16", "unfused", "draft", 4, "other"),
         ("gpt2", "bf16", "unfused", "draft", 4, "self"),
         ("llama", "int8", "unfused", "ngram", 4, "self"),
         ("llama", "fp8", "unfused", "draft", 4, "self"),
         ("llama", "bf16", "fused", "ngram", 4, "self"),
         ("llama", "bf16", "fused", "draft", 1, "self"),
         ("llama", "int8", "fused", "draft", 4, "self"),
         ("llama", "fp8", "fused", "ngram", 1, "self"),
         ("mla", "bf16", "unfused", "ngram", 4, "self"),
         ("mla", "int8", "fused", "ngram", 1, "self")]


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_spec_streams_token_exact_with_jax_and_plain(case):
    arch, kind, step, method, k, draft = case
    jc, tc, jp, tp, jd, td = _model(arch, draft)
    fused = step == "fused"
    prompts = _spec_prompts()
    j_streams, j_stats, j_spec, j_mk = _run_jax(
        jc, jp, ENGINE, prompts, kv_cache_dtype=kind, fused_decode=fused,
        **_spec_kw(method, k, jd, jc))
    t_streams, t_stats, t_spec, eng = _run_port(
        tc, tp, ENGINE, prompts, kv_cache_dtype=kind, fused_decode=fused,
        **_spec_kw(method, k, td, tc))
    assert eng.megakernel is fused is j_mk
    assert eng.spec_method == method
    assert t_streams == j_streams
    assert t_streams == _plain(arch, kind, fused)
    for key in STATS:
        assert t_stats[key] == j_stats[key], key
    assert t_stats["preemptions"] > 0
    # The MLA bf16 streams preempt in an order that evicts the shared
    # prefix before its second use, on both engines (the books above).
    assert t_stats["prefix_hit_tokens"] > 0 or arch == "mla"
    assert {s: t_spec[s] for s in SPEC} == {s: j_spec[s] for s in SPEC}
    assert t_spec["rounds"] > 0 and t_spec["proposed"] > 0


def test_lora_spec_streams_token_exact_with_jax():
    """Adapters on four of five requests, n-gram at k 4, fused: JAX's
    engine without prefix caching (its keys are not salted with the
    adapter) against the port's."""
    jc, tc, jp, tp = _params("llama", "plain")
    prompts = _spec_prompts()
    kw = dict(spec_method="ngram", spec_k=4, fused_decode=True)
    j_streams, _, j_spec, _ = _run_jax(
        jc, jp, LORA_ENGINE, prompts, ROUTE, adapter_cache=_jax_cache(jc),
        enable_prefix_caching=False, **kw)
    t_streams, _, t_spec, eng = _run_port(
        tc, tp, LORA_ENGINE, prompts, ROUTE, adapter_cache=_port_cache(tc),
        **kw)
    assert eng.megakernel
    assert t_streams == j_streams
    assert {s: t_spec[s] for s in SPEC} == {s: j_spec[s] for s in SPEC}
    plain, _, _, _ = _run_port(tc, tp, LORA_ENGINE, prompts, ROUTE,
                               adapter_cache=_port_cache(tc),
                               fused_decode=True)
    assert t_streams == plain


def test_fused_mla_at_k4_plans_its_rows():
    """The verify step's rows join the fused step's row plan: max(max_batch,
    prefill_chunk, max_batch·(k+1)) — 15 rows here at k 4, beside 8 at k 1
    (max(3, 8, 6))."""
    _, tc, _, tp, _, _ = _model("mla", "self")
    for k, rows in ((4, 15), (1, 8)):
        eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                         spec_method="ngram", spec_k=k,
                                         fused_decode=True, **ENGINE)
        assert eng.mq_rows == rows and eng.megakernel
