"""The port's MLA serving engine against the JAX package's.

The same weights (the JAX init of a llama-shaped MLA config at JAX's MLA
test widths with init_method_std 0.4, every leaf perturbed, carried across
by ``convert.params_from_jax``) serve the same five prompts greedily
through JAX's ``DynamicInferenceEngine`` and the port's: bf16, int8 and
fp8 latent pools, the unfused and the fused step, the q_proj and the
q_lora_rank q paths, plain rope and YaRN, and resident-int8 weights (the
out-projection and the MLP). The undersized pool of
tests/test_torch_engine.py preempts, the prompts are prefilled in chunks
of 8, and the shared 12-token prefix hits. Streams must be token-exact and
the pools' books equal; JAX's steps run to completion before its engine
goes on (``_run_jax`` in tests/test_torch_engine.py says why). Then the
refusals: the fused step's eligibility for MLA, LoRA on MLA, an adapter
cache on an MLA engine.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import ENGINE, MAX_NEW, _prompts, _synchronous
from test_torch_mla import mla_pair

from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference import quantization as jq
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu.models.gpt import init_gpt_params as j_init
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference import lora as tl
from megatronapp_tpu_torch.inference import quantization as tq
from megatronapp_tpu_torch.inference.engine import SamplingParams
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.ops import fused_decode as fd

STATS = ("preemptions", "prefix_hit_tokens", "prefill_tokens", "cow_copies",
         "evictions")
VARIANTS = {
    "q_proj": {},
    "q_lora": dict(q_lora_rank=24),
    "yarn": dict(position_embedding="yarn", rope_scaling_factor=4.0,
                 yarn_original_max_position=32),
}


@functools.lru_cache(maxsize=None)
def _weights(variant, weights="plain"):
    """(jax cfg, port cfg, JAX params, port params), every leaf perturbed;
    quantized to resident int8 on both sides for weights ==
    "resident_int8"."""
    jc, tc = mla_pair(init_method_std=0.4, **VARIANTS[variant])
    params, _ = j_init(jax.random.PRNGKey(11), jc)
    rng = np.random.default_rng(11)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)
                   ).astype(np.float32), params)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, tc, "cpu")
    if weights == "resident_int8":
        jp = jax.tree.map(jnp.asarray, jq.residentize_params(
            jq.quantize_params(np_params, resident_only=True)[0]))
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


def _run_port(tc, tp, kind, fused, **kw):
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     kv_cache_dtype=kind, fused_decode=fused,
                                     **{**ENGINE, **kw})
    assert eng.megakernel is fused
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    eng.pool.audit()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats), eng


CASES = [("q_proj", "bf16", "plain", "unfused"),
         ("q_proj", "bf16", "plain", "fused"),
         ("q_proj", "int8", "plain", "fused"),
         ("q_proj", "fp8", "plain", "unfused"),
         ("q_lora", "bf16", "plain", "fused"),
         ("q_lora", "int8", "plain", "unfused"),
         ("yarn", "fp8", "plain", "fused"),
         ("q_proj", "int8", "resident_int8", "fused")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def runs(request):
    variant, kind, weights, step = request.param
    jc, tc, jp, tp = _weights(variant, weights)
    fused = step == "fused"
    return (request.param, _run_jax(jc, jp, kind, fused),
            _run_port(tc, tp, kind, fused))


def test_mla_streams_token_exact_with_jax(runs):
    _, (j_streams, _), (t_streams, _, _) = runs
    assert t_streams == j_streams


def test_mla_pool_books_match_jax(runs):
    """Preemption, prefix hits, prefill tokens and evictions: the same on
    both engines, and the undersized pool preempts and hits."""
    (_, kind, weights, step), (_, j_stats), (_, t_stats, eng) = runs
    for key in STATS:
        assert t_stats[key] == j_stats[key], key
    assert t_stats["preemptions"] > 0 and t_stats["prefix_hit_tokens"] > 0
    snap = eng.stats_snapshot()
    assert snap["megakernel"] is (step == "fused")
    assert snap["pool"]["kv_cache_dtype"] == kind
    assert snap["pool"]["pool_bytes_total"] == eng.pool.bytes_total
    assert snap["param_bytes"] == tq.resident_nbytes(eng.params)
    assert [tuple(p.shape[-1:]) for p in eng.pool.pages] == [(32,), (8,)]
    out = eng.params["layers"][0]["attention"]["out_kernel"]
    assert tq.is_resident_leaf(out) is (weights == "resident_int8")


def test_fused_and_unfused_mla_streams_agree_on_the_cpu():
    """The port's own fused and unfused MLA steps, q_lora path on an fp8
    pool: the same streams."""
    _, tc, _, tp = _weights("q_lora")
    assert _run_port(tc, tp, "fp8", True)[0] == \
        _run_port(tc, tp, "fp8", False)[0]


def test_megakernel_eligibility_for_mla():
    """MLA is eligible (JAX's blanket refusal is gone); LoRA on MLA is
    refused with JAX's wording; on the card the CUDA kernels' limits name
    themselves."""
    from megatronapp_tpu.ops.pallas import kernel_gen as jkg
    jc, tc = mla_pair()
    assert fd.megakernel_ineligible_reason(tc, batch=4) is None
    assert jkg.megakernel_ineligible_reason(jc, batch=4) is None
    want = jkg.megakernel_ineligible_reason(jc, batch=4, lora_rank=8)
    assert fd.megakernel_ineligible_reason(tc, batch=4, lora_rank=8) == want
    assert "no q_kernel/kv_kernel" in want
    bf = dataclasses.replace(tc, compute_dtype=torch.bfloat16,
                             hidden_size=128, ffn_hidden_size=256,
                             qk_pos_emb_head_dim=64, qk_head_dim=64,
                             kv_lora_rank=64, v_head_dim=64)
    assert fd.megakernel_ineligible_reason(bf, batch=8, mq_rows=32,
                                           device="cuda") is None
    for change, match in ((dict(qk_pos_emb_head_dim=32), "qk_pos_emb"),
                          (dict(kv_lora_rank=96), "kv_lora_rank"),
                          (dict(kv_lora_rank=704), "latent paged")):
        why = fd.megakernel_ineligible_reason(
            dataclasses.replace(bf, **change), batch=8, device="cuda")
        assert match in why
    assert "at most 32 rows" in fd.megakernel_ineligible_reason(
        bf, batch=8, mq_rows=64, device="cuda")
    assert fd.megakernel_ineligible_reason(bf, batch=8, mq_rows=64,
                                           device="cpu") is None


def test_adapter_cache_on_an_mla_engine_raises():
    _, tc, _, tp = _weights("q_proj")
    with pytest.raises(ValueError, match="multi-latent attention"):
        tl.AdapterCache(tc, tl.AdapterRegistry(), rank=4, device="cpu")


def test_streams_match_the_dense_greedy_oracle():
    """The fused MLA engine's greedy streams against the port's own dense
    no-cache forward (the whole sequence recomputed each token), as JAX's
    TestMLAFusedDecode holds its engine to its dense oracle: the latent
    pools, the absorption and the latent kernel's plain version change no
    token."""
    from megatronapp_tpu_torch.models.gpt import gpt_forward
    _, tc, _, tp = _weights("yarn")
    prompts = _prompts()[:3]
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", fused_decode=True,
                                     **ENGINE)
    ids = [eng.add_request(p, 6, SamplingParams(greedy=True))
           for p in prompts]
    res = eng.run_to_completion()
    for rid, p in zip(ids, prompts):
        seq = torch.as_tensor(p, dtype=torch.long)[None]
        with torch.no_grad():
            for _ in range(6):
                logits, _ = gpt_forward(tp, seq, tc)
                seq = torch.cat([seq, logits[:, -1].argmax(-1)[:, None]], 1)
        assert res[rid].tolist() == seq[0].tolist()
