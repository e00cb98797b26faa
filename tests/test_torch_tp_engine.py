"""The port's tensor-parallel serving engine against the JAX package's.

Two port ranks (spawned processes over a gloo group, FileStore under the
test's tmp dir, on the CPU) serve the same five prompts greedily from the
same weights as JAX's tp-2 engine (``ctx=build_mesh(ParallelConfig(
tensor_parallel=2), devices=jax.devices()[:2])``): dense GQA on bf16 and
int8 pools (JAX's pins: tests/test_disagg.py:165, tests/test_kv_quant.py:
319), MLA on bf16, int8 and fp8 latent pools, and a shared-prefix case
whose repeated prompt copies its last block on write, served with
fused_decode asked for (refused under tp). The undersized pool of
tests/test_torch_engine.py preempts, and the shared prefix hits. Streams
must be token-exact with JAX's, rank 1's must equal rank 0's, and the
pools' books must equal JAX's; each rank holds half the pool and runs one
all-gather (dense) or two all-reduces (MLA) a layer a step and chunk.
JAX's steps run to completion before its engine goes on (``_run_jax`` in
tests/test_torch_engine.py says why). One spawn serves every case.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch
import torch_tp_worker as W
from test_torch_engine import ENGINE, MAX_NEW, _prompts, _synchronous
from test_torch_engine import _weights as dense_weights
from test_torch_mla_engine import _weights as mla_weights

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference.paged_cache import PagedKVCache
from megatronapp_tpu_torch.parallel.mesh import MeshContext

STATS = ("preemptions", "prefix_hit_tokens", "prefill_tokens", "cow_copies",
         "evictions")


def _cow_prompts():
    """Two copies of a 12-token prompt (3 full blocks: the second fully
    hits and copies its last block on write) and one other."""
    p = _prompts()
    return [p[1][:12], p[1][:12].copy(), p[0]]


CASES = {
    "dense-bf16": ("dense", dict(kv_cache_dtype="bf16"), _prompts),
    "dense-int8": ("dense", dict(kv_cache_dtype="int8"), _prompts),
    "mla-bf16": ("mla", dict(kv_cache_dtype="bf16"), _prompts),
    "mla-int8": ("mla", dict(kv_cache_dtype="int8"), _prompts),
    "mla-fp8": ("mla", dict(kv_cache_dtype="fp8"), _prompts),
    "dense-cow-fused-asked": ("dense", dict(kv_cache_dtype="bf16",
                                            fused_decode=True), _cow_prompts),
}


def _weights(model):
    return dense_weights("llama") if model == "dense" else \
        mla_weights("q_proj")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' reports of every case, from one spawn."""
    cases = []
    for name, (model, kw, prompts) in CASES.items():
        _, tc, jp, _ = _weights(model)
        cases.append(dict(name=name, cfg=tc, params=W.np_tree(jp),
                          engine={**ENGINE, **kw}, prompts=prompts(),
                          max_new=MAX_NEW))
    store = tmp_path_factory.mktemp("tp_store") / "store"
    return W.spawn_ranks(2, str(store), cases)


def _run_jax(name):
    model, kw, prompts = CASES[name]
    jc, _, jp, _ = _weights(model)
    ctx = j_build_mesh(JPC(tensor_parallel=2), devices=jax.devices()[:2])
    eng = jde.DynamicInferenceEngine(jp, jc, paged=True, ctx=ctx,
                                     **{**ENGINE, **kw})
    assert eng.tp_paged and not eng.megakernel
    eng._decode = _synchronous(eng._decode)
    eng._mq_step = _synchronous(eng._mq_step)
    ids = [eng.add_request(p, MAX_NEW, JSampling(greedy=True))
           for p in prompts()]
    res = eng.run_to_completion()
    return [res[r].tolist() for r in ids], dict(eng.pool.stats)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_streams_and_books_match_jax_tp(ranks, name):
    streams, stats = _run_jax(name)
    rep = ranks[0][name]
    assert rep["streams"] == streams
    for key in STATS:
        assert rep["stats"][key] == stats[key], key
    if name.startswith("dense-cow"):
        assert stats["cow_copies"] > 0
    else:
        assert stats["preemptions"] > 0 and stats["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_follower_streams_equal_the_leads(ranks, name):
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r1["streams"] == r0["streams"]
    assert r1["stats"] == r0["stats"]
    assert (r1["decode_steps"], r1["prefill_chunks"]) == \
        (r0["decode_steps"], r0["prefill_chunks"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_pools_and_collectives(ranks, name):
    """Each rank holds half the pool (GQA: half the kv heads, with their
    scales; MLA: half the latent columns, the roped-key and scale pools
    whole) and runs one all-gather (dense) or two all-reduces (MLA) a
    layer a step and chunk; the fused step is refused under tp."""
    model, kw, _ = CASES[name]
    _, tc, _, _ = _weights(model)
    layers, units = tc.num_layers, None
    for rank in (0, 1):
        rep = ranks[rank][name]
        assert rep["tp_paged"] and not rep["megakernel"]
        assert rep["snapshot_tp"]["rank"] == rank
        assert rep["snapshot_tp"]["tp"] == 2
        units = rep["decode_steps"] + rep["prefill_chunks"]
        lead = (layers, ENGINE["num_blocks"], ENGINE["block_size"])
        whole = PagedKVCache(tc, ENGINE["max_batch"], ENGINE["max_seq_len"],
                             num_blocks=ENGINE["num_blocks"],
                             block_size=ENGINE["block_size"],
                             kv_cache_dtype=kw["kv_cache_dtype"])
        if model == "dense":
            assert rep["pool_shapes"] == [
                lead + (tc.num_query_groups // 2, tc.head_dim)] * 2
            assert rep["pool_bytes"] * 2 == whole.bytes_total
            assert rep["calls"]["all_gather"] == layers * units
            assert rep["calls"]["all_reduce"] == 0
        else:
            assert rep["pool_shapes"] == [lead + (tc.kv_lora_rank // 2,),
                                          lead + (tc.qk_pos_emb_head_dim,)]
            scales = 0 if whole.scales is None else sum(
                s.numel() * 4 for s in whole.scales)
            lat = whole.pages[0].numel() * whole.pages[0].element_size()
            assert rep["pool_bytes"] == whole.bytes_total - lat // 2
            assert rep["calls"]["all_reduce"] == 2 * layers * units
            assert rep["calls"]["all_gather"] == 0
            if kw["kv_cache_dtype"] != "bf16":
                assert rep["scale_shapes"] == [lead, lead] and scales
        assert rep["calls"]["broadcast"] >= rep["decode_steps"]


def _ctx(tp=2, rank=0):
    return MeshContext(group=None, parallel=ParallelConfig(tensor_parallel=tp),
                       rank=rank, device=torch.device("cpu"),
                       backend="gloo")


def test_fused_decode_under_tp_warns_with_jax_predicate(caplog):
    _, tc, _, tp = dense_weights("llama")
    with caplog.at_level(logging.WARNING):
        eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", ctx=_ctx(),
                                         fused_decode=True, **ENGINE)
    assert eng.tp_paged and not eng.megakernel
    assert ("megakernel decode requested but ineligible — keeping the "
            "unfused decode step: tp head-sharded serving mesh: fused "
            "prologue/epilogue kernels are single-device (the tp engine "
            "keeps the unfused body)") in caplog.text


@pytest.mark.parametrize("over,reason", [
    (dict(num_query_groups=1),
     "num_query_groups (1) % tp (2) != 0 (shards must own whole GQA "
     "groups)"),
    (dict(num_attention_heads=3, num_query_groups=3),
     "num_attention_heads (3) % tp (2) != 0")])
def test_ineligible_config_warns_and_keeps_whole_pools(caplog, over, reason):
    _, tc, _, tp = dense_weights("llama")
    cfg = dataclasses.replace(tc, **over)
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with caplog.at_level(logging.WARNING):
        eng = tde.DynamicInferenceEngine(params, cfg, device="cpu",
                                         ctx=_ctx(), **ENGINE)
    assert not eng.tp_paged and eng._step_ctx is None
    assert (f"paged kernels stay single-device on a tp=2 mesh: {reason}"
            in caplog.text)
    assert eng.pool.pages[0].shape[3] == cfg.num_query_groups


def test_lora_and_reload_under_tp_are_refused():
    _, tc, _, tp = dense_weights("llama")
    with pytest.raises(NotImplementedError, match="LoRA serving under "
                       "tensor parallelism"):
        tde.DynamicInferenceEngine(tp, tc, device="cpu", ctx=_ctx(),
                                   adapter_cache=object(), **ENGINE)
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", ctx=_ctx(),
                                     **ENGINE)
    with pytest.raises(NotImplementedError, match="rolling reload"):
        eng.set_params(tp)
    follower = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                          ctx=_ctx(rank=1), **ENGINE)
    with pytest.raises(RuntimeError, match="rank 0's broadcast"):
        follower.add_request(np.arange(4, dtype=np.int32), 2)


def test_lead_queues_requests_until_the_step():
    """Rank 0 takes requests, cancellations and aborts into its queue;
    nothing reaches the engine's books before the step broadcasts them."""
    _, tc, _, tp = dense_weights("llama")
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu", ctx=_ctx(),
                                     **ENGINE)
    rid = eng.add_request(np.arange(5, dtype=np.int32), 3)
    assert eng.has_work and not eng.waiting and rid not in eng.requests
    with pytest.raises(ValueError, match="already admitted"):
        eng.add_request(np.arange(5, dtype=np.int32), 3, request_id=rid)
    assert eng.abort_request(rid) == "running"
    assert eng.abort_request(rid + 100) is None
    assert [op for op, _ in eng._pending] == ["add", "abort"]
    eng.abort_all()
    assert [op for op, _ in eng._pending] == ["abort_all"]
    assert eng.keepalive_s == eng.ctx.timeout_s / 4


def test_serve_tp_spawns_a_follower_that_serves_in_lockstep(tmp_path):
    """serve.py's --serve-tp path without the HTTP server: rank 0 spawns
    rank 1 (follower_main), both build the seeded engine, rank 0's
    request runs to completion with the follower in step, and releasing
    the follower ends its process."""
    from megatronapp_tpu_torch import serve
    args = serve.parse_args(["--engine", "dynamic", "--paged-kv-cache",
                             "--preset", "gpt2-125m", "--num-layers", "1",
                             "--max-seq-len", "32", "--max-batch", "2",
                             "--device", "cpu", "--params-dtype", "fp32",
                             "--serve-tp", "2"])
    init = f"file://{tmp_path / 'store'}"     # no port to collide on
    followers = serve.spawn_followers(args, init)
    ctx = serve.join_tp(args, 0, init)
    try:
        engine = serve.build_engine(args, ctx)
        assert engine.tp_paged and engine.pool.pages[0].shape[3] == 6
        rid = engine.add_request(np.arange(5, dtype=np.int32), 3)
        out = engine.run_to_completion()
        engine.release_followers()
        assert len(out[rid]) == 8
    finally:
        for p in followers:
            p.join(timeout=60)
        ctx.close()
    assert all(not p.is_alive() and p.exitcode == 0 for p in followers)
