"""Quantized serving engines of the port against the JAX package's.

The same weights (the JAX init, every leaf perturbed, carried across by
``convert.params_from_jax``) serve the same five prompts greedily through
JAX's ``DynamicInferenceEngine`` and the port's, on int8 and fp8 KV pools,
with the weights as they are or quantized to resident int8 on both sides
(JAX's quantize_params/residentize_params, the port's own copy: the same
bytes, tests/test_torch_quantization.py), through the unfused and the fused
step. The undersized pool of tests/test_torch_engine.py preempts and the
shared prefix hits in every case. Streams must be token-exact and the
pools' preemption, prefix-hit, prefill and eviction counts equal. JAX's
steps run to completion before its engine goes on (``_run_jax`` in
tests/test_torch_engine.py says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import (
    ENGINE, MAX_NEW, _prompts, _synchronous, _weights,
)

from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference import quantization as jq
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference import quantization as tq
from megatronapp_tpu_torch.inference.engine import SamplingParams

STATS = ("preemptions", "prefix_hit_tokens", "prefill_tokens", "cow_copies",
         "evictions")


@functools.lru_cache(maxsize=None)
def _params(arch, weights):
    """(jax cfg, port cfg, JAX params, port params), quantized to resident
    int8 on both sides when weights == "resident_int8"."""
    jc, tc, jp, tp = _weights(arch)
    if weights == "resident_int8":
        jp = jax.tree.map(jnp.asarray, jq.residentize_params(
            jq.quantize_params(jax.tree.map(np.asarray, jp),
                               resident_only=True)[0]))
        tp = tq.quantize_for_serving(tp)[0]
    return jc, tc, jp, tp


def _run_jax(jc, jp, kind, fused):
    eng = jde.DynamicInferenceEngine(jp, jc, paged=True, kv_cache_dtype=kind,
                                     fused_decode=fused, **ENGINE)
    assert eng.megakernel is fused
    eng._decode = _synchronous(eng._decode)
    eng._mq_step = _synchronous(eng._mq_step)
    ids = [eng.add_request(p, MAX_NEW, JSampling(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats)


def _run_port(tc, tp, kind, fused):
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     kv_cache_dtype=kind, fused_decode=fused,
                                     **ENGINE)
    assert eng.megakernel is fused
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    eng.pool.audit()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats), eng


CASES = [("llama", kind, weights, step)
         for kind in ("int8", "fp8")
         for weights in ("plain", "resident_int8")
         for step in ("unfused", "fused")]
CASES.append(("gpt2", "int8", "resident_int8", "fused"))


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def runs(request):
    arch, kind, weights, step = request.param
    jc, tc, jp, tp = _params(arch, weights)
    fused = step == "fused"
    return (request.param, _run_jax(jc, jp, kind, fused),
            _run_port(tc, tp, kind, fused))


def test_quantized_streams_token_exact_with_jax(runs):
    _, (j_streams, _), (t_streams, _, _) = runs
    assert t_streams == j_streams


def test_quantized_pool_stats_match_jax(runs):
    """Preemption, prefix hits, prefill tokens and evictions: the same on
    both engines, and the undersized pool preempts and hits."""
    _, (_, j_stats), (_, t_stats, _) = runs
    for key in STATS:
        assert t_stats[key] == j_stats[key], key
    assert t_stats["preemptions"] > 0 and t_stats["prefix_hit_tokens"] > 0


def test_quantized_engine_reports_its_storage(runs):
    (_, kind, weights, step), _, (_, _, eng) = runs
    snap = eng.stats_snapshot()
    assert snap["pool"]["kv_cache_dtype"] == kind
    assert snap["pool"]["pool_bytes_total"] == eng.pool.bytes_total
    assert snap["megakernel"] is (step == "fused")
    assert snap["param_bytes"] == tq.resident_nbytes(eng.params)
    assert eng.pool.pages[0].dtype == {"int8": torch.int8,
                                       "fp8": torch.float8_e4m3fn}[kind]
    q = eng.params["layers"][0]["attention"]["q_kernel"]
    assert tq.is_resident_leaf(q) is (weights == "resident_int8")


def test_fused_and_unfused_quantized_streams_agree_on_the_cpu():
    """On the CPU the fused step runs the plain versions of the fused
    kernels: with an int8 pool and resident weights it gives the unfused
    engine's streams."""
    _, tc, _, tp = _params("llama", "resident_int8")
    fused = _run_port(tc, tp, "int8", True)[0]
    assert fused == _run_port(tc, tp, "int8", False)[0]
