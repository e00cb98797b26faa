"""MoE serving on the port against the JAX package's engines, on the CPU.

A tiny llama-style MoE model (GQA, swiglu, rmsnorm, rope, untied; 4
experts, top-2, two layers) from JAX's init, every leaf perturbed and
carried across by ``convert.params_from_jax``, serves the five prompts of
tests/test_torch_engine.py greedily through JAX's paged
``DynamicInferenceEngine`` and the port's (the undersized pool preempts
and the shared prefix hits), and two prompts through both static
engines. Streams must be token-exact, and the pools' counts equal:

- weights in fp32, in bf16 (the router stays fp32 on both sides), and
  quantized to resident int8 on both sides (expert stacks included: the
  same bytes, tests/test_torch_moe.py); int8 and fp8 KV pools, which only
  attention reads;
- ``fused_decode=True`` on a MoE model: both engines warn with JAX's
  reason ("MoE layers: expert dispatch is not fused yet") and keep the
  unfused step, whose streams they serve; the layer's fused body raises;
- a MoE engine under a tp ctx and ``serve.py --serve-tp`` with the MoE
  preset are refused, naming the ROADMAP.md item.

JAX's steps run to completion before its engine goes on (``_run_jax`` in
tests/test_torch_engine.py says why).
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import (
    ENGINE, MAX_NEW, _prompts, _synchronous,
)
from test_torch_layers import LLAMA_SMALL, cfg_pair

from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference import engine as je
from megatronapp_tpu.inference import quantization as jq
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu.models.gpt import init_gpt_params as j_init
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference import engine as te
from megatronapp_tpu_torch.inference import quantization as tq
from megatronapp_tpu_torch.inference.engine import SamplingParams
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.ops.fused_decode import (
    megakernel_ineligible_reason,
)
from megatronapp_tpu_torch.parallel.mesh import MeshContext

MOE_SMALL = dict(LLAMA_SMALL, num_moe_experts=4, moe_router_topk=2,
                 moe_aux_loss_coeff=0.01)
FUSED_REASON = "MoE layers: expert dispatch is not fused yet"
STATS = ("preemptions", "prefix_hit_tokens", "prefill_tokens", "cow_copies",
         "evictions")


@functools.lru_cache(maxsize=None)
def _weights(kind):
    """(jax cfg, port cfg, JAX params, port params) of the MoE model:
    kind "fp32", "bf16" (params stored in bf16, the router fp32, compute
    fp32) or "int8" (fp32 weights quantized to resident int8)."""
    jc, tc = cfg_pair(**MOE_SMALL)
    params, _ = j_init(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)
                   ).astype(np.float32), params)
    if kind == "bf16":
        jc = dataclasses.replace(jc, params_dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, params_dtype=torch.bfloat16)
        router = np_params["block"]["moe"]["router_kernel"]
        np_params = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), np_params)
        np_params["block"]["moe"]["router_kernel"] = router
    tp = params_from_jax(np_params, tc, "cpu")
    jp = jax.tree.map(jnp.asarray, np_params)
    if kind == "int8":
        jp = jax.tree.map(jnp.asarray, jq.residentize_params(
            jq.quantize_params(np_params, resident_only=True)[0]))
        tp = tq.quantize_for_serving(tp)[0]
    return jc, tc, jp, tp


def _run_jax(jc, jp, fused=False, kv="bf16"):
    eng = jde.DynamicInferenceEngine(jp, jc, paged=True, fused_decode=fused,
                                     kv_cache_dtype=kv, **ENGINE)
    eng._decode = _synchronous(eng._decode)
    eng._mq_step = _synchronous(eng._mq_step)
    ids = [eng.add_request(p, MAX_NEW, JSampling(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats), eng


def _run_port(tc, tp, fused=False, kv="bf16"):
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     fused_decode=fused, kv_cache_dtype=kv,
                                     **ENGINE)
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    eng.pool.audit()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats), eng


@pytest.fixture(scope="module", params=["fp32", "bf16", "int8"])
def runs(request):
    jc, tc, jp, tp = _weights(request.param)
    return request.param, _run_jax(jc, jp), _run_port(tc, tp)


def test_moe_paged_streams_token_exact_with_jax(runs):
    _, (j_streams, _, _), (t_streams, _, _) = runs
    assert t_streams == j_streams


def test_moe_pool_stats_match_jax(runs):
    _, (_, j_stats, _), (_, t_stats, eng) = runs
    for key in STATS:
        assert t_stats[key] == j_stats[key], key
    assert t_stats["preemptions"] > 0 and t_stats["prefix_hit_tokens"] > 0
    assert "moe" in eng.params["layers"][0]


def test_moe_weights_are_what_the_case_says(runs):
    kind, _, (_, _, eng) = runs
    moe = eng.params["layers"][0]["moe"]
    assert moe["router_kernel"].dtype == torch.float32
    fc1 = moe["fc1_kernel"]
    if kind == "int8":
        assert tq.is_resident_leaf(fc1)
        assert fc1["qint8"].dtype == torch.int8
    else:
        assert fc1.dtype == {"fp32": torch.float32,
                             "bf16": torch.bfloat16}[kind]


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_moe_on_quantized_kv_pools_token_exact_with_jax(kv):
    jc, tc, jp, tp = _weights("fp32")
    j_streams, j_stats, _ = _run_jax(jc, jp, kv=kv)
    t_streams, t_stats, eng = _run_port(tc, tp, kv=kv)
    assert t_streams == j_streams
    for key in STATS:
        assert t_stats[key] == j_stats[key], key
    assert eng.pool.kv_cache_dtype == kv


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_moe_static_streams_token_exact_with_jax(kind):
    jc, tc, jp, tp = _weights(kind)
    prompts = np.random.default_rng(1).integers(0, 127, (2, 5)).astype(
        np.int32)
    want = je.StaticInferenceEngine(jp, jc, max_seq_len=24).generate(
        prompts, 8, je.SamplingParams(greedy=True))
    got = te.StaticInferenceEngine(tp, tc, max_seq_len=24,
                                   device="cpu").generate(
        prompts, 8, te.SamplingParams(greedy=True))
    np.testing.assert_array_equal(got, want)


def test_fused_request_on_moe_keeps_the_unfused_step(caplog):
    """Both engines name JAX's reason and serve the unfused streams."""
    jc, tc, jp, tp = _weights("fp32")
    assert megakernel_ineligible_reason(tc, batch=3) == FUSED_REASON
    j_streams, _, j_eng = _run_jax(jc, jp, fused=True)
    with caplog.at_level(logging.WARNING):
        t_streams, _, t_eng = _run_port(tc, tp, fused=True)
    assert j_eng.megakernel is False and t_eng.megakernel is False
    assert any(FUSED_REASON in r.getMessage() for r in caplog.records)
    assert t_streams == j_streams
    from megatronapp_tpu_torch.transformer.block import layer_forward
    with pytest.raises(ValueError, match="fused_decode covers the "
                       "dense-MLP paged decode/multiquery bodies only"):
        layer_forward(tp["layers"][0], torch.zeros(1, 1, tc.hidden_size),
                      tc, kv_cache=(torch.zeros(1), torch.zeros(1)),
                      page_table=torch.zeros(1, 1), fused_decode=True)


ITEM = r"Queue 1 item 4 \(MoE under pp, cp, FBD, DPP, MTP and serve-tp\)"


def test_moe_under_serving_tp_is_refused(capsys):
    _, tc, _, tp = _weights("fp32")
    ctx = MeshContext(group=None, parallel=ParallelConfig(tensor_parallel=2),
                      rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(NotImplementedError, match=ITEM):
        tde.DynamicInferenceEngine(tp, tc, device="cpu", ctx=ctx, **ENGINE)
    from megatronapp_tpu_torch import serve
    with pytest.raises(SystemExit):
        serve.parse_args(["--preset", "mixtral-8x7b", "--engine", "dynamic",
                          "--paged-kv-cache", "--serve-tp", "2"])
    assert "MoE under pp, cp, FBD, DPP, MTP and serve-tp" in \
        capsys.readouterr().err
    args = serve.parse_args(["--preset", "mixtral-8x7b", "--engine",
                             "dynamic", "--paged-kv-cache",
                             "--quantized-weights"])
    assert args.quantized_weights and args.serve_tp == 1
