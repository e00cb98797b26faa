"""MegaDPP in the port (runtime/dpp.py, runtime/dpp_train.py, the
trainer's --use-dpp) against the JAX package, fp32 on the CPU.

The runtime runs in this process, its stage threads on the CPU (every
stage's device is "cpu", so there are no streams). Inputs come from
numpy seeds; params are JAX's, carried over by models/convert.py.

- ``send_priority`` and ``static_order`` equal JAX's over a grid of (pp,
  vpp, M, policy); an unknown policy raises.
- ``TransferPool`` bounds its slots and books the stall.
- The runner's outputs equal a sequential pass under dfc / bfc ×
  dynamic / static, every (chunk, mb) shipped once a stage; a slow stage
  reorders the dynamic sends and the static plan ships ready work late
  (JAX's jitters); one input a microbatch.
- The value and grad of the DPP step at (pp, vpp, dynamic) = (2, 1, T),
  (2, 2, T), (2, 2, F): the loss within 1e-5 of JAX's gpt_pipeline_loss
  on a pp-2 mesh, every grad within 2e-4 of jax.grad of it on a pp-1 mesh
  (this jax cannot take the grad of its pp > 1 region; JAX's own
  test_golden_parity_vs_spmd fails here for that reason).
- dp-2 replicas against JAX's make_dpp_gpt_value_and_grad on a [2][2]
  device grid, with a non-uniform mask and with a fully masked shard.
- The trainer under use_dpp against JAX's pretrain_gpt with use_dpp
  (losses within 2e-3), and through the entry point; a traced run's
  dpp-compute / dpp-send records on pids 5000 + 100 r + stage.
- On a rank grid at tp 2, use_dpp runs the pipeline executor and logs
  JAX's "falling back to static bfc" line; at tp 1 it refuses (the
  runtime is one process). MTP and packed segments raise JAX's messages.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_layers import cfg_pair
from test_torch_training import jax_named

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu.parallel.pipeline import reshape_params_for_pipeline
from megatronapp_tpu.runtime import dpp as jdpp
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.runtime.dpp import (
    DppPipelineRunner, TransferPool, send_priority, static_order,
)
from megatronapp_tpu_torch.runtime.dpp_train import (
    make_dpp_gpt_value_and_grad,
)

TINY = dict(num_layers=4, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)
LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 2e-4, 2e-3


# ---- priority order -----------------------------------------------------------

@pytest.mark.parametrize("policy", ["dfc", "bfc"])
@pytest.mark.parametrize("m", [4, 6])
@pytest.mark.parametrize("vpp", [1, 2, 3])
@pytest.mark.parametrize("pp", [2, 4])
def test_priority_and_static_order_are_jaxs(pp, vpp, m, policy):
    assert static_order(pp, vpp, m, policy) == jdpp.static_order(
        pp, vpp, m, policy)
    for c in range(vpp):
        for mb in range(m):
            assert send_priority(c, mb, pp, vpp, policy) == \
                jdpp.send_priority(c, mb, pp, vpp, policy)


def test_reference_traversals():
    assert static_order(2, 2, 4, "dfc") == [(0, 0), (0, 1), (1, 0), (1, 1),
                                            (0, 2), (0, 3), (1, 2), (1, 3)]
    assert static_order(2, 2, 3, "bfc") == [(0, 0), (0, 1), (0, 2), (1, 0),
                                            (1, 1), (1, 2)]
    with pytest.raises(ValueError, match="unknown DPP order policy"):
        send_priority(0, 0, 2, 2, "zigzag")


def test_transfer_pool_bounds_and_stalls():
    pool = TransferPool(n_buffers=1)
    pool.acquire()
    t0 = time.perf_counter()
    threading.Timer(0.1, pool.release).start()
    pool.acquire()   # must wait for the release
    assert time.perf_counter() - t0 >= 0.09
    assert pool.stall_s >= 0.09
    assert pool.acquisitions == 2
    pool.release()


# ---- the runner -----------------------------------------------------------------

def _make_runner(pp=2, vpp=2, m=4, slow=None, **kw):
    """Chunk = h * 1.01 + (stage + chunk); `slow` maps (stage, chunk) ->
    seconds of injected compute jitter."""
    slow = slow or {}

    def chunk_fn(stage, chunk, h, mb):
        if (stage, chunk) in slow:
            time.sleep(slow[(stage, chunk)])
        return h * 1.01 + (stage + chunk)

    return DppPipelineRunner(chunk_fn, ["cpu"] * pp, pp=pp, vpp=vpp,
                             num_microbatches=m, **kw)


def _expected(h, pp, vpp):
    for c in range(vpp):
        for s in range(pp):
            h = h * 1.01 + (s + c)
    return h


@pytest.mark.parametrize("dynamic", [True, False])
@pytest.mark.parametrize("policy", ["dfc", "bfc"])
def test_outputs_match_sequential(dynamic, policy):
    pp, vpp, m = 2, 2, 4
    runner = _make_runner(pp, vpp, m, dynamic=dynamic, policy=policy)
    ins = [torch.full((8, 8), float(i)) for i in range(m)]
    outs = runner.run(ins)
    for i, o in zip(ins, outs):
        np.testing.assert_allclose(o.numpy(), _expected(i, pp, vpp).numpy(),
                                   rtol=1e-6)
    for log in runner.transfer_order:
        assert sorted(log) == sorted((c, i) for c in range(vpp)
                                     for i in range(m))


def test_slow_stage_changes_transfer_order():
    """With stage 1 late, the dynamic stage-0 sender ships the finished
    chunk-0 microbatches before the (1, 0) round trip the static DFC
    plan blocks on."""
    pp, vpp, m = 2, 2, 4
    slow = {(1, 0): 0.15}
    ins = [torch.full((4, 4), float(i)) for i in range(m)]
    dyn = _make_runner(pp, vpp, m, slow=slow, dynamic=True)
    dyn_out = dyn.run(ins)
    sta = _make_runner(pp, vpp, m, slow=slow, dynamic=False)
    sta_out = sta.run(ins)
    for a, b in zip(dyn_out, sta_out):
        assert torch.equal(a, b)
    plan = static_order(pp, vpp, m, "dfc")
    assert sta.transfer_order[0] == plan
    d0 = dyn.transfer_order[0]
    assert d0 != plan
    assert d0.index((0, 2)) < d0.index((1, 0))
    assert d0.index((0, 3)) < d0.index((1, 0))


def test_dynamic_ships_ready_work_earlier():
    """The static plan cannot ship the finished (0, 2) before (1, 0) has
    cleared the slow stage (one jitter period); the dynamic one does."""
    pp, vpp, m = 2, 2, 6
    jitter = 0.5
    slow = {(1, 0): jitter}
    ins = [torch.full((4, 4), float(i)) for i in range(m)]
    dyn = _make_runner(pp, vpp, m, slow=slow, dynamic=True)
    dyn.run(ins)
    sta = _make_runner(pp, vpp, m, slow=slow, dynamic=False)
    sta.run(ins)
    t_dyn = dyn.ship_time_s[0][(0, 2)]
    t_sta = sta.ship_time_s[0][(0, 2)]
    assert t_sta >= jitter
    assert t_dyn < t_sta


def test_input_count_validation():
    runner = _make_runner(2, 1, 3)
    with pytest.raises(ValueError, match="one input per microbatch"):
        runner.run([torch.zeros(2, 2)])


# ---- the value and grad -------------------------------------------------------

def _tiny():
    return cfg_pair(**TINY)


_REF = {}


def _ref_params():
    if "p" not in _REF:
        jc, _ = _tiny()
        _REF["p"] = jax.tree.map(np.asarray, jgpt.init_gpt_params(
            jax.random.PRNGKey(0), jc)[0])
    return _REF["p"]


def _batch(seed, m, mb, s, mask=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, (m, mb, s + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
            "loss_mask": (np.ones((m, mb, s), np.float32) if mask is None
                          else mask)}


def _jax_pipeline(batch, pp, vpp):
    """JAX's gpt_pipeline_loss of the batch: its value on a pp-`pp` mesh,
    or (pp 1) its value and jax.grad as {port name: array}."""
    jc, _ = _tiny()
    jp = _ref_params()
    ctx = j_build_mesh(JPC(pipeline_parallel=pp,
                           virtual_pipeline_parallel=vpp),
                       devices=jax.devices()[:pp])
    jp = dict(jp, block=reshape_params_for_pipeline(jp["block"], pp, vpp))
    args = [jnp.asarray(batch[k]) for k in ("tokens", "labels",
                                            "loss_mask")]

    def loss(q):
        return jgpt.gpt_pipeline_loss(q, *args, jc, ctx, vpp=vpp)[0]

    with ctx.mesh:
        if pp > 1:
            return float(jax.jit(loss)(jp)), None
        val, grad = jax.jit(jax.value_and_grad(loss))(jp)
    grad = jax.tree.map(np.asarray, grad)
    grad["block"] = jax.tree.map(lambda x: x.reshape(-1, *x.shape[3:]),
                                 grad["block"])
    return float(val), jax_named(grad)


def _port_vg(batch, grid, vpp, dynamic=True):
    _, tc = _tiny()
    params = params_from_jax(_ref_params(), tc)
    params.requires_grad_(True)
    vg = make_dpp_gpt_value_and_grad(tc, grid, vpp=vpp, dynamic=dynamic)
    loss, grads, metrics, runners = vg(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), {n: g.numpy() for n, g in grads.items()}, runners


def _check_grads(got, want):
    assert got.keys() == want.keys()
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, rtol=0, atol=GRAD_TOL,
                                   err_msg=n)


@pytest.mark.parametrize("pp,vpp,dynamic", [(2, 1, True), (2, 2, True),
                                            (2, 2, False)])
def test_value_and_grad_parity(pp, vpp, dynamic):
    m = 4
    batch = _batch(1, m, 1, 8)
    if "pp1" not in _REF:
        _REF["pp1"] = _jax_pipeline(batch, 1, 1)
    ref_loss, ref_grads = _REF["pp1"]
    pp_loss, _ = _jax_pipeline(batch, pp, vpp)
    loss, grads, runners = _port_vg(batch, ["cpu"] * pp, vpp, dynamic)
    assert abs(loss - pp_loss) < LOSS_TOL, (loss, pp_loss)
    assert abs(loss - ref_loss) < LOSS_TOL, (loss, ref_loss)
    _check_grads(grads, ref_grads)
    # Both sweeps shipped every (chunk, mb) on every stage.
    for phase in (runners[0].fwd_metrics, runners[0].bwd_metrics):
        assert all(len(o) == vpp * m for o in phase["transfer_order"])


@pytest.mark.parametrize("masked", ["half-rows", "whole-shard"])
def test_dp_replicas_match_jax_runtime(masked):
    """pp 2 × dp 2: each replica's pipeline on its rows, mask-token
    weights on the seeds; a fully masked shard adds no CE gradient."""
    from megatronapp_tpu.runtime.dpp_train import (
        make_dpp_gpt_value_and_grad as j_vg,
    )
    pp, dp, m, mb, s = 2, 2, 4, 2, 8
    mask = np.ones((m, mb, s), np.float32)
    if masked == "half-rows":
        mask[:, 1, : s // 2] = 0.0
    else:
        mask[:, 1] = 0.0
    batch = _batch(2, m, mb, s, mask)
    jc, _ = _tiny()
    jp = _ref_params()
    jp = dict(jp, block=reshape_params_for_pipeline(jp["block"], pp, 1))
    devs = jax.devices()
    vg = j_vg(jc, [[devs[0], devs[1]], [devs[2], devs[3]]], vpp=1)
    ref_loss, ref_grads, _, _ = vg(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    ref_grads = jax.tree.map(np.asarray, ref_grads)
    ref_grads["block"] = jax.tree.map(lambda x: x.reshape(-1, *x.shape[3:]),
                                      ref_grads["block"])
    loss, grads, runners = _port_vg(batch, [["cpu"] * dp] * pp, 1)
    assert len(runners) == dp
    assert abs(loss - float(ref_loss)) < LOSS_TOL
    _check_grads(grads, jax_named(ref_grads))


def test_mtp_and_packed_raise_jaxs_messages():
    _, tc = cfg_pair(**TINY, mtp_num_layers=1)
    with pytest.raises(NotImplementedError, match="multi-token prediction"):
        make_dpp_gpt_value_and_grad(tc, ["cpu", "cpu"])
    _, tc = _tiny()
    vg = make_dpp_gpt_value_and_grad(tc, ["cpu", "cpu"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(3, 2, 1, 8).items()}
    batch["segment_ids"] = torch.zeros(2, 1, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="packed segments"):
        vg(params_from_jax(_ref_params(), tc).requires_grad_(True), batch)


# ---- the trainer ------------------------------------------------------------------

E2E_TRAIN = dict(micro_batch_size=2, global_batch_size=8, seq_length=32,
                 train_iters=5, log_interval=1, eval_interval=0, seed=1234)
E2E_OPT = dict(lr=1e-3, lr_warmup_iters=2)
DPP_PAR = dict(pipeline_parallel=2, virtual_pipeline_parallel=2,
               use_dpp=True, pipeline_order_policy="bfc")


def test_pretrain_gpt_use_dpp_matches_jax():
    """The trainer's --use-dpp path (the one-device loop stepping through
    make_dpp_train_step) against JAX's pretrain_gpt with use_dpp on a
    2-device mesh, on JAX's learnable batches and init."""
    from test_training import learnable_batches

    from megatronapp_tpu.config.training_config import (
        OptimizerConfig as JOpt, TrainingConfig as JTrain,
    )
    from megatronapp_tpu.training.train import pretrain_gpt as j_pretrain
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    jc, tc = _tiny()
    jpar = JPC(**DPP_PAR)
    ctx = j_build_mesh(jpar, devices=jax.devices()[:2])
    ref = j_pretrain(jc, jpar, JTrain(**E2E_TRAIN), JOpt(**E2E_OPT),
                     ctx=ctx, batch_iter=learnable_batches(32, 128, 8),
                     log_fn=lambda s: None)
    init = jax.tree.map(np.asarray, jgpt.init_gpt_params(
        jax.random.PRNGKey(E2E_TRAIN["seed"]), jc)[0])
    lines = []
    res = pretrain_gpt(tc, TrainingConfig(**E2E_TRAIN),
                       OptimizerConfig(**E2E_OPT), device="cpu",
                       params=params_from_jax(init, tc),
                       batch_iter=learnable_batches(32, 128, 8),
                       log_fn=lines.append,
                       parallel=ParallelConfig(**DPP_PAR))
    assert lines[0] == ("dpp: dynamic runtime active (pp=2, dp=1, vpp=2, "
                        "policy=bfc)")
    losses = [m["loss"] for m in res.log]
    np.testing.assert_allclose(losses, ref.losses, rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert losses[-1] < losses[0] - 0.1
    assert {"dpp_fwd_compute_wait_s", "dpp_bwd_compute_wait_s", "skipped",
            "lr"} <= set(res.log[0])


def test_dpp_evaluation_runs_the_runner():
    """Evaluation under use_dpp (the runner's forward over every stage,
    the token mean over the batch) reads one device's eval losses on the
    same weights and streams, and so does the training."""
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    _, tc = _tiny()
    train = TrainingConfig(micro_batch_size=1, global_batch_size=4,
                           seq_length=16, train_iters=4, log_interval=1,
                           eval_interval=2, eval_iters=2, seed=1234)
    runs = [pretrain_gpt(tc, train, OptimizerConfig(lr=1e-3), device="cpu",
                         params=params_from_jax(_ref_params(), tc),
                         log_fn=lambda s: None, parallel=par)
            for par in (None, ParallelConfig(**DPP_PAR))]
    one, dpp = runs
    assert [i for i, _ in dpp.eval_losses] == [2, 4]
    np.testing.assert_allclose([v for _, v in dpp.eval_losses],
                               [v for _, v in one.eval_losses], rtol=1e-5)
    np.testing.assert_allclose([m["loss"] for m in dpp.log],
                               [m["loss"] for m in one.log], rtol=1e-5)


def test_entry_point_use_dpp(tmp_path):
    """pretrain_gpt.py --use-dpp: one process, the 'bfc' order,
    --data-parallel-size 2; resolved_args.json records both flags."""
    from megatronapp_tpu_torch import pretrain_gpt as entry
    argv = ["--device", "cpu", "--fp32", "--num-layers", "4",
            "--hidden-size", "64", "--num-attention-heads", "4",
            "--vocab-size", "128", "--max-position-embeddings", "64",
            "--seq-length", "16", "--micro-batch-size", "1",
            "--global-batch-size", "8", "--train-iters", "2",
            "--log-interval", "1", "--pipeline-model-parallel-size", "2",
            "--num-layers-per-virtual-pipeline-stage", "1", "--use-dpp",
            "--data-parallel-size", "2", "--save", str(tmp_path)]
    par = entry.parallel_from_args(entry.parse_args(argv))
    assert (par.use_dpp, par.pipeline_order_policy, par.data_parallel,
            par.virtual_pipeline_parallel) == (True, "bfc", 2, 2)
    res = entry.main(argv)
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    with open(tmp_path / "resolved_args.json") as f:
        saved = json.load(f)
    assert saved["use_dpp"] and not saved["forward_backward_disaggregating"]
    assert saved["layout"]["dpp"] == {"pp": 2, "vpp": 2, "dp": 2}


def test_traced_run_emits_transport_spans(tmp_path):
    """MegaScan over a --use-dpp run at dp 2: dpp-compute / dpp-send X
    spans for both directions on pids 5000 + 100 r + stage."""
    from megatronapp_tpu_torch.trace.aggregate import aggregate_dir
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    _, tc = _tiny()
    trace_dir = str(tmp_path / "trace")
    train = TrainingConfig(micro_batch_size=1, global_batch_size=4,
                           seq_length=16, train_iters=2, log_interval=1,
                           trace=True, trace_dir=trace_dir,
                           trace_interval=2, continuous_trace_iterations=1)
    pretrain_gpt(tc, train, OptimizerConfig(lr=1e-3), device="cpu",
                 log_fn=lambda s: None,
                 parallel=ParallelConfig(**dict(DPP_PAR, data_parallel=2)))
    trace = aggregate_dir(trace_dir, os.path.join(trace_dir, "agg.json"))
    ev = [e for e in trace["traceEvents"]
          if e.get("name") in ("dpp-compute", "dpp-send")]
    assert ev, "no dpp transport spans in the trace"
    assert {e["args"]["dir"] for e in ev} == {"forward", "backward"}
    assert {e["pid"] for e in ev} == {5000, 5001, 5100, 5101}
    assert {e["args"]["stage"] for e in ev} == {0, 1}
    sends = [e for e in ev if e["name"] == "dpp-send"]
    assert all({"chunk", "mb"} <= set(e["args"]) for e in sends)
    assert all(e["dur"] >= 0 for e in ev)
    assert any(e.get("name") == "train-step" for e in trace["traceEvents"])


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    """use_dpp on rank grids: pp 2 × tp 2 (the executor under 'bfc', with
    JAX's log line) beside the same run without use_dpp, and pp 2 at tp 1
    (refused)."""
    tmp = tmp_path_factory.mktemp("dpp_grid")
    _, tc = cfg_pair(**TINY)
    base = dict(kind="train", world=4, tp=2, cfg=tc, keep_log=True,
                train=TrainingConfig(micro_batch_size=1, global_batch_size=4,
                                     seq_length=16, train_iters=3,
                                     log_interval=1, seed=1234),
                opt=OptimizerConfig(lr=1e-3))
    bfc = dict(pipeline_parallel=2, pipeline_order_policy="bfc")
    cases = [dict(base, name="tp2-dpp", par=dict(bfc, use_dpp=True)),
             dict(base, name="tp2-bfc", par=bfc),
             dict(base, name="tp1-dpp", world=2, tp=1, expect_error=True,
                  par=dict(bfc, use_dpp=True))]
    return W.spawn_ranks(4, str(tmp / "store"), cases)


def test_use_dpp_at_tp2_runs_the_bfc_executor(grid_ranks):
    rep = grid_ranks[0]["tp2-dpp"]
    assert any("falling back to static bfc SPMD ordering" in x
               for x in rep["log"])
    assert rep["losses"] == grid_ranks[0]["tp2-bfc"]["losses"]
    assert not any("falling back" in x
                   for x in grid_ranks[0]["tp2-bfc"]["log"])


def test_use_dpp_on_a_tp1_grid_is_refused(grid_ranks):
    for r in (0, 1):
        assert "runs in one process" in grid_ranks[r]["tp1-dpp"]["raised"]
