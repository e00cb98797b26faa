"""MegaFBD in the port (parallel/fbd.py, training/train.py
_pretrain_gpt_fbd) against the JAX package, fp32 on the CPU.

One spawn of eight gloo ranks (tests/torch_parallel_worker.py, FileStores
under the test's tmp dir) runs every case; the JAX references run in the
test process on the 8 virtual CPU devices meanwhile.

- The split: eight ranks at tp 2 form a forward half (ranks 0-3) and a
  backward half (4-7), dp 4 halved to 2 on each, twins at the same (pp,
  dp, tp) index (JAX test_mesh_split_accounting); an odd dp raises
  before any group is joined (test_odd_dp_rejected).
- The golden gpt_tiny_fbd curve (tp 2 × dp 4 on 8 ranks) at rtol 2e-3.
- Ten steps at pp 1 against JAX's pretrain_gpt with
  forward_backward_disaggregating on the 8-device mesh, within 2e-3; at
  pp 2 against JAX's train step on a dp-2 mesh (this jax cannot take the
  grad of JAX's pp > 1 region, so its FBD run at pp 2 fails, as its own
  test_fbd_composes_with_pp_cp[pp] does here; the port's pipeline tests
  use the same yardstick) within 2e-3, and against the port's own pp 2 ×
  dp 2 run within 5e-5 (JAX test_fbd_composes_with_pp_cp). fwd_loss
  equals loss within 1e-5 on every step.
- Forward ranks build no autograd graph; backward ranks run exactly one
  forward a (microbatch, stage) (the recompute of design point 1).
- The twin hops ("send/fbd", "recv/fbd") and the param stream
  ("send/fbd-params", "recv/fbd-params") counted exactly.
- pp 2 × vpp 2 under FBD, 'dfc' and 'bfc', against the port's own pp 2 ×
  vpp 2 run within 5e-5.
- Rampup (8 → 16) against the port's dp-2 grid run, which is what the
  backward half runs.
- Save at 4, resume to 6 ("resumed from checkpoint at step 4"), steps
  5-6 bitwise a straight run's; the JSONL rows.
- The compose refusals (pp_schedule, the planner, bf16 moments).
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_layers import cfg_pair
from test_torch_parallel_train import _jax_run
from test_torch_pipeline import LLAMA, OPT, _init_params, _refs, _train_cfg
from test_torch_training import GOLDEN, GOLDEN_MODEL, _golden_init

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.config.training_config import OptimizerConfig as JOpt
from megatronapp_tpu.config.training_config import TrainingConfig as JTrain
from megatronapp_tpu.config.transformer_config import (
    TransformerConfig as JConfig,
)
from megatronapp_tpu.training.train import pretrain_gpt as j_pretrain
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)

FBD = dict(forward_backward_disaggregating=True)
PP2 = dict(pipeline_parallel=2)
STEP_TOL = 2e-3
SAME_TOL = 5e-5
FWD_TOL = 1e-5
STEPS = 10
# pp 1: eight ranks, dp 8 → 4 a half; batch 8 of 1, so 2 microbatches.
PP1_TRAIN = dict(micro_batch_size=1, global_batch_size=8, seq_length=16,
                 train_iters=STEPS, log_interval=1, seed=1234)


def _golden_cfgs():
    return (JConfig(compute_dtype=jnp.float32, **GOLDEN_MODEL),
            TransformerConfig(compute_dtype=torch.float32, **GOLDEN_MODEL))


def _rampup_train(**kw):
    return TrainingConfig(**{**dict(
        micro_batch_size=2, global_batch_size=16, seq_length=32,
        train_iters=8, log_interval=1, seed=1234,
        rampup_batch_size=(8, 8, 24)), **kw})


def _cases(tmp):
    jc_g, tc_g = _golden_cfgs()
    _, tc, _ = _refs()["llama"]
    init = _init_params()
    opt = OptimizerConfig(**OPT)
    cases = [
        dict(name="split", kind="split", world=8, tp=2, par=FBD),
        dict(name="golden", kind="train", world=8, tp=2, par=FBD,
             cfg=tc_g, params=_golden_init(jc_g),
             train=TrainingConfig(micro_batch_size=1, global_batch_size=4,
                                  seq_length=32, train_iters=10,
                                  log_interval=2, seed=1234),
             opt=OptimizerConfig(lr=1e-3, lr_warmup_iters=2,
                                 lr_decay_iters=10)),
        dict(name="pp1", kind="fbd", world=8, tp=1, par=FBD, cfg=tc,
             params=init, train=TrainingConfig(**PP1_TRAIN), opt=opt),
        dict(name="pp2", kind="fbd", world=8, tp=1, par=dict(FBD, **PP2),
             cfg=tc, params=init, train=_train_cfg(), opt=opt),
        dict(name="pp2-base", kind="train", world=4, tp=1, par=PP2,
             cfg=tc, params=init, train=_train_cfg(), opt=opt),
    ]
    ramp = dict(tp=1, cfg=tc_g, params=_golden_init(jc_g),
                train=_rampup_train(),
                opt=OptimizerConfig(lr=1e-3, lr_decay_iters=8,
                                    clip_grad=0.0))
    cases.append(dict(ramp, name="rampup", kind="train", world=4, par=FBD))
    cases.append(dict(ramp, name="rampup-base", kind="train", world=2))
    ck = dict(kind="train", world=4, tp=1, par=dict(FBD, **PP2), cfg=tc,
              params=init, opt=opt)
    cases.append(dict(ck, name="ckpt-save", train=_train_cfg(
        train_iters=4, save_dir=str(tmp / "fbd"), save_interval=2,
        metrics_jsonl=str(tmp / "m.jsonl"))))
    cases.append(dict(ck, name="ckpt-resume", keep_log=True,
                      train=_train_cfg(train_iters=6,
                                       save_dir=str(tmp / "fbd"),
                                       save_interval=100)))
    cases.append(dict(ck, name="straight", train=_train_cfg(train_iters=6)))
    # Interleaved chunks under both orders: two FBD halves of pp 2 × vpp
    # 2 against one pp 2 × vpp 2 grid.
    for policy in ("dfc", "bfc"):
        par = dict(PP2, virtual_pipeline_parallel=2,
                   pipeline_order_policy=policy)
        vpp = dict(kind="train", tp=1, cfg=tc, params=init, opt=opt,
                   train=_train_cfg(train_iters=3))
        cases.append(dict(vpp, name=f"vpp-{policy}", world=4,
                          par=dict(FBD, **par)))
        cases.append(dict(vpp, name=f"vpp-{policy}-base", world=2,
                          par=par))
    return cases


_JAX = {}


def _jax_references():
    """JAX's FBD run at pp 1 on the 8-device mesh and its train step on
    a dp-2 mesh (the pp 2 yardstick)."""
    jc = _refs()["llama"][0]
    res = j_pretrain(jc, JPC(**FBD), JTrain(**PP1_TRAIN), JOpt(**OPT),
                     log_fn=lambda s: None)
    _JAX["pp1"] = res.losses
    _JAX["dp2"] = _jax_run(jc, "dp2", OPT)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's reports of every case, from one spawn of 8 ranks."""
    tmp = tmp_path_factory.mktemp("fbd")
    started = W.start_ranks(8, str(tmp / "store"), _cases(tmp))
    _jax_references()
    return W.collect(started, timeout=600), tmp


def test_split_accounting(ranks):
    """tp 2 over 8 ranks: dp 4 halved to 2 on each half; the halves are
    disjoint, each rank's groups lie in its half, twins mirror."""
    reps = [ranks[0][r]["split"] for r in range(8)]
    for r, rep in enumerate(reps):
        half = 0 if r < 4 else 4
        assert rep["role"] == ("forward" if r < 4 else "backward")
        assert (rep["dp"], rep["tp"], rep["pp"]) == (2, 2, 1)
        assert rep["twin"] == (r + 4) % 8
        assert rep["grid_rank"] == r - half
        assert rep["world_ranks"] == list(range(half, half + 4))
        assert set(rep["tp_ranks"] + rep["dp_ranks"]) <= set(
            rep["world_ranks"])
        assert reps[rep["twin"]]["tp_ranks"] == [
            t + 4 - 2 * half for t in rep["tp_ranks"]]


def test_odd_dp_rejected():
    from megatronapp_tpu_torch.parallel.fbd import split_fbd_meshes
    with pytest.raises(ValueError, match="even data-parallel degree"):
        split_fbd_meshes(ParallelConfig(tensor_parallel=4, **FBD), rank=0,
                         world_size=4, init_method="file:///nonexistent",
                         device="cpu")


def test_golden_gpt_tiny_fbd(ranks):
    """tests/functional gpt_tiny_fbd (tp 2 × dp 4, FBD, 10 steps) on 8
    gloo ranks; every rank reads the same metrics."""
    with open(GOLDEN) as f:
        golden = json.load(f)["gpt_tiny_fbd"]
    for r in range(8):
        np.testing.assert_allclose(ranks[0][r]["golden"]["losses"], golden,
                                   rtol=2e-3)


def _check_fwd(rep):
    np.testing.assert_allclose(rep["fwd_losses"], rep["losses"], rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("case", ["pp1", "pp2"])
def test_ten_steps_match_jax(ranks, case):
    """pp 1 against JAX's FBD run, pp 2 against JAX's dp-2 train step;
    fwd_loss (the forward half's) is loss on every step and rank."""
    rep = ranks[0][4][case]
    want = _JAX["pp1"] if case == "pp1" else _JAX["dp2"][0]
    assert len(rep["losses"]) == STEPS
    np.testing.assert_allclose(rep["losses"], want, rtol=STEP_TOL)
    for r in range(8):
        got = ranks[0][r][case]
        assert got["losses"] == rep["losses"], r
        assert got["grad_norms"] == rep["grad_norms"], r
        _check_fwd(got)


def test_fbd_pp2_matches_the_ports_pp2(ranks):
    """JAX test_fbd_composes_with_pp_cp[pp]: the FBD pp 2 run (two pp 2 ×
    dp 2 halves) against the same pp 2 × dp 2 grid without FBD."""
    got, base = ranks[0][4]["pp2"], ranks[0][0]["pp2-base"]
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=0,
                               atol=SAME_TOL)
    np.testing.assert_allclose(got["grad_norms"], base["grad_norms"],
                               rtol=SAME_TOL)
    np.testing.assert_allclose(ranks[0][4]["pp2"]["losses"],
                               _JAX["dp2"][0], rtol=STEP_TOL)


@pytest.mark.parametrize("policy", ["dfc", "bfc"])
def test_fbd_interleaved_matches_the_ports_vpp(ranks, policy):
    """pp 2 × vpp 2 under FBD: the forward half ships stage 0's chunk-1
    inputs too, the backward half recomputes chunk by chunk; both chunk
    orders give the port's own pp 2 × vpp 2 run."""
    got = ranks[0][2][f"vpp-{policy}"]
    base = ranks[0][0][f"vpp-{policy}-base"]
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=0,
                               atol=SAME_TOL)
    np.testing.assert_allclose(got["grad_norms"], base["grad_norms"],
                               rtol=SAME_TOL)
    _check_fwd(got)


@pytest.mark.parametrize("case", ["pp1", "pp2"])
def test_forward_ranks_build_no_graph(ranks, case):
    """A forward rank's every stage forward runs without grad; a backward
    rank runs each (microbatch, stage) forward exactly once, with it."""
    micro = 2
    for r in range(8):
        rep = ranks[0][r][case]
        calls = rep["forwards"]
        assert len(calls) == STEPS * micro, (r, len(calls))
        if rep["role"] == "forward":
            assert set(calls) == {(False, False)}, r
        else:
            assert set(calls) == {(True, True)}, r


def test_twin_hops_and_param_stream_counted_exactly(ranks):
    """pp 2, 10 steps of 2 microbatches of [1, 16, 64] fp32: a forward
    stage-1 rank ships its 2 stage inputs a step (stage 0 ships nothing:
    its twin embeds the rows itself), its twin takes them; each backward
    rank streams its padded flat params once a step."""
    hop = 1 * 16 * 64 * 4
    for r in range(8):
        rep = ranks[0][r]["pp2"]
        traffic = rep["traffic"]
        fwd = rep["role"] == "forward"
        n = STEPS * 2 if rep["stage"] == 1 else 0
        kind = "send/fbd" if fwd else "recv/fbd"
        assert traffic.get(kind, {"calls": 0, "bytes": 0}) == {
            "calls": n, "bytes": n * hop}, r
        other = "recv/fbd" if fwd else "send/fbd"
        assert other not in traffic, r
        padded = -(-rep["local_params"] // 2) * 2
        stream = "recv/fbd-params" if fwd else "send/fbd-params"
        assert traffic[stream] == {"calls": STEPS,
                                   "bytes": STEPS * padded * 4}, r
        assert rep["shipped"] == [2 * 2 * hop] * STEPS, r


def test_rampup(ranks):
    """Rampup 8 → 16 under FBD: the backward half is a dp-2 grid, so the
    run is the port's dp-2 run's; the stream consumed the schedule."""
    from megatronapp_tpu_torch.training.num_microbatches_calculator import (
        build_calculator,
    )
    tc = _rampup_train()
    calc = build_calculator(tc.global_batch_size, tc.micro_batch_size, 2,
                            tc.rampup_batch_size)
    consumed = 0
    for _ in range(tc.train_iters):
        consumed += calc.get(consumed)[0]
    got, base = ranks[0][2]["rampup"], ranks[0][0]["rampup-base"]
    assert got["losses"] == base["losses"]
    assert got["consumed"] == base["consumed"] == consumed
    assert consumed > 8 * tc.train_iters
    assert np.isfinite(got["losses"]).all()
    _check_fwd(got)


def test_checkpoint_resume_and_metrics(ranks):
    """Save every 2 steps of 4 on the backward half; resume to 6 logs
    JAX's line and takes steps 5-6 bitwise a straight run's; the JSONL
    rows hold loss, fwd_loss and grad_norm."""
    _, tmp = ranks
    rows = [json.loads(x) for x in open(tmp / "m.jsonl")]
    assert [x["step"] for x in rows] == [1, 2, 3, 4]
    assert {"loss", "fwd_loss", "grad_norm"} <= set(rows[-1])
    lines = ranks[0][2]["ckpt-resume"]["log"]
    assert any("resumed from checkpoint at step 4" in x for x in lines)
    assert any(x.startswith("FBD: forward mesh") for x in lines)
    assert any("fwd-mesh loss" in x for x in lines)
    for r in range(4):
        resumed = ranks[0][r]["ckpt-resume"]["losses"]
        straight = ranks[0][r]["straight"]["losses"]
        assert resumed == straight[4:], r
        assert ranks[0][r]["ckpt-save"]["losses"] == straight[:4], r


@pytest.mark.parametrize("field,value,msg", [
    ("pp_schedule", "zero-bubble", "do not compose with "
     "--forward-backward-disaggregating"),
    ("pp_plan_from_trace", True, "do not compose with "
     "--forward-backward-disaggregating"),
])
def test_compose_refusals(field, value, msg):
    kw = dict(FBD, pipeline_parallel=2, **{field: value})
    with pytest.raises(ValueError, match=msg):
        ParallelConfig(**kw)


def test_bf16_moments_refused():
    """JAX arguments.py:985-995, at the entry point and in the trainer."""
    from megatronapp_tpu_torch import pretrain_gpt as entry
    from megatronapp_tpu_torch.training.train import _pretrain_gpt_fbd
    with pytest.raises(ValueError, match="not supported with "
                       "--forward-backward-disaggregating"):
        entry.parse_args(["--forward-backward-disaggregating",
                          "--exp-avg-dtype", "bf16"])
    _, tc = cfg_pair(**LLAMA)
    with pytest.raises(ValueError, match="exp-avg-dtype"):
        _pretrain_gpt_fbd(tc, TrainingConfig(), OptimizerConfig(
            exp_avg_sq_dtype="bf16"), types.SimpleNamespace(
                fbd_role="backward", is_lead=True), log_fn=lambda s: None)
