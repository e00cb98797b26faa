"""MoE pretraining on the port's dp × ep × tp grid against the JAX
package, fp32 on the CPU.

One spawn of four gloo ranks (FileStores under the test's tmp dir;
tests/torch_parallel_worker.py imports no jax) runs every case from the
params of JAX's seeded train-state init; JAX's make_train_step runs in
the test process on 2 or 4 of the 8 virtual CPU devices meanwhile.
Config: the llama-style one of the grid tests (GQA, swiglu, RMSNorm,
rope, QK-layernorm, untied) with 4 experts, top-2, aux 0.01 and z-loss
1e-3, S 16.

- The golden gpt_tiny_moe_ep2 curve (tests/functional) through the
  port's pretrain_gpt on 2 ranks at ep 2, at its rtol 2e-3.
- Ten steps within 2e-3 of JAX's make_train_step at ep 2 (the chunked
  all-to-all), at dp 2 with capacity factor 1.0 (the global capacity and
  arrival positions of transformer/moe.py: some copies drop) and at ep 2
  × tp 2; each within 1e-5 of the port's one-rank run on the grids'
  global microbatch.
- The bulk all-to-all (--no-moe-comm-overlap) trains as the chunked one.
- A checkpoint written at ep 2 restores at ep 1 bitwise (the state
  written back is the saved one), and one written on one device
  restores at ep 2 bitwise.
- The refusals name the ROADMAP.md item: MoE under pp, cp, MegaFBD,
  MegaDPP and with MTP depths, ep with pp / cp, experts that ep does not
  divide; and the entry point's MoE and ep flags.
- The grid's numbering at ep 2 × tp 2: rank = (((p · dp + d) · ep + x)
  · cp + c) · tp + t, the ep and the dp × ep batch groups.
- A traced ep 2 step records 'moe-a2a-permute' / 'moe-a2a-compute'
  spans with JAX's args and one 'collective-permute' event a hop; the
  hops, the bulk all-to-alls and the batch reductions are counted.
"""

import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_layers import cfg_pair
from test_torch_parallel_train import LLAMA_TP, OPT, _np_tree
from test_torch_training import GOLDEN, GOLDEN_MODEL

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.config.training_config import OptimizerConfig as JOpt
from megatronapp_tpu.config.transformer_config import (
    TransformerConfig as JConfig,
)
from megatronapp_tpu.data.mock import mock_batches as j_mock
from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu.training import train as jtrain
from megatronapp_tpu.training.optimizer import get_optimizer
from megatronapp_tpu.training.train_state import setup_train_state
from megatronapp_tpu.training.train_step import make_train_step as j_step
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)
from megatronapp_tpu_torch.parallel.mesh import MeshContext
from megatronapp_tpu_torch.training.checkpointing import CheckpointManager
from megatronapp_tpu_torch.training.train import (
    check_moe_training, pretrain_gpt,
)

SEQ, GBS, STEPS, SHORT = 16, 4, 10, 3
STEP_TOL = 2e-3
ONE_RANK_TOL = 1e-5
MOE = dict(num_moe_experts=4, moe_router_topk=2, moe_aux_loss_coeff=0.01,
           moe_z_loss_coeff=1e-3)
GOLDEN_MOE = dict(GOLDEN_MODEL, num_moe_experts=4, moe_aux_loss_coeff=0.01)
ITEM = "Queue 1 item 4 (MoE under pp, cp, FBD, DPP, MTP and serve-tp)"

# name: (world, tp, ParallelConfig fields, config fields)
GRIDS = {
    "one": (1, 1, {"expert_parallel": 1}, {}),
    "ep2": (2, 1, {"expert_parallel": 2}, {}),
    "ep2tp2": (4, 2, {"expert_parallel": 2}, {}),
    "dp2-cap": (2, 1, {}, {"moe_capacity_factor": 1.0}),
    "one-cap": (1, 1, {}, {"moe_capacity_factor": 1.0}),
}
JAX_GRIDS = {"ep2": (2, JPC(expert_parallel=2), {}),
             "ep2tp2": (4, JPC(expert_parallel=2, tensor_parallel=2), {}),
             "dp2-cap": (2, JPC(), {"moe_capacity_factor": 1.0})}


def _cfgs(**kw):
    return cfg_pair(**{**LLAMA_TP, **MOE, **kw})


def _train_cfg(**kw):
    return TrainingConfig(**{**dict(micro_batch_size=1,
                                    global_batch_size=GBS, seq_length=SEQ,
                                    train_iters=STEPS, log_interval=1,
                                    seed=1234), **kw})


def _jax_state(jc, par, world, steps, opt, seed=1234):
    ctx = j_build_mesh(par, devices=jax.devices()[:world])
    jopt = JOpt(**opt)
    optimizer = get_optimizer(jopt, steps, distributed=True)
    state, sh, _ = setup_train_state(
        jax.random.PRNGKey(seed), lambda r: jgpt.init_gpt_params(r, jc),
        optimizer, ctx)
    return ctx, jopt, optimizer, state, sh


_INIT = {}


def _init_params(cfg_kw=()):
    """setup_train_state's params (the same values on any mesh) as numpy."""
    key = tuple(sorted(dict(cfg_kw).items()))
    if key not in _INIT:
        jc = _cfgs(**dict(cfg_kw))[0]
        _INIT[key] = _np_tree(_jax_state(jc, JPC(), 1, STEPS, OPT)[3][
            "params"])
    return _INIT[key]


def _jax_losses(grid):
    """JAX's make_train_step on the grid's mesh: per-step losses."""
    world, par, kw = JAX_GRIDS[grid]
    jc = _cfgs(**kw)[0]
    ctx, jopt, optimizer, state, sh = _jax_state(jc, par, world, STEPS, OPT)
    step = j_step(jtrain.gpt_microbatch_loss(jc, ctx), optimizer, jopt, ctx,
                  sh, STEPS, donate=False)
    it = j_mock(SEQ, jc.vocab_size, GBS, seed=1234)
    num_micro = GBS // (ctx.dp * ctx.ep)
    losses = []
    with ctx.mesh:
        for _ in range(STEPS):
            b = next(it)
            b = jtrain.reshape_global_batch(
                {k: b[k] for k in ("tokens", "labels", "loss_mask")},
                num_micro)
            state, m = step(state, b)
            losses.append(float(jax.device_get(m["loss"])))
    return losses


def _case(name, grid, steps, **kw):
    world, tp, par, cfg_kw = GRIDS[grid]
    return dict(dict(name=name, kind="train", world=world, tp=tp, par=par,
                     cfg=_cfgs(**cfg_kw)[1], params=_init_params(cfg_kw),
                     train=_train_cfg(train_iters=steps),
                     opt=OptimizerConfig(**OPT)), **kw)


def _golden_params():
    jc = JConfig(compute_dtype=jax.numpy.float32, **GOLDEN_MOE)
    return _np_tree(_jax_state(jc, JPC(), 1, 10, {})[3]["params"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_train")
    paths = {k: str(d / k) for k in ("save", "back", "one", "one_back",
                                     "trace")}
    # A one-device checkpoint for the ep 2 ranks to restore.
    tc = _cfgs()[1]
    pretrain_gpt(tc, _train_cfg(train_iters=SHORT, save_dir=paths["one"],
                                save_interval=SHORT),
                 OptimizerConfig(**OPT), device="cpu",
                 log_fn=lambda s: None)
    cases = [_case(g, g, STEPS) for g in ("ep2", "ep2tp2", "dp2-cap")]
    # One rank's microbatch is the grids' global one (2 rows): the router's
    # losses and the capacity are functions of the microbatch's tokens.
    cases += [_case(g, g, STEPS, train=_train_cfg(micro_batch_size=2))
              for g in ("one", "one-cap")]
    cases.append(_case("ep2-bulk", "ep2", SHORT,
                       cfg=_cfgs(moe_comm_overlap=False)[1]))
    cases.append(dict(
        name="golden", kind="train", world=2, tp=1,
        par={"expert_parallel": 2},
        cfg=TransformerConfig(compute_dtype=torch.float32, **GOLDEN_MOE),
        params=_golden_params(),
        train=TrainingConfig(micro_batch_size=2, global_batch_size=8,
                             seq_length=32, train_iters=10, log_interval=2,
                             seed=1234),
        opt=OptimizerConfig(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=10)))
    cases.append(_case("ckpt-save", "ep2tp2", SHORT, train=_train_cfg(
        train_iters=SHORT, save_dir=paths["save"], save_interval=SHORT)))
    cases.append(_case("ckpt-load", "ep2", SHORT, params=None,
                       train=_train_cfg(train_iters=SHORT,
                                        load_dir=paths["one"],
                                        save_dir=paths["one_back"],
                                        save_interval=SHORT)))
    world, tp, par, _ = GRIDS["ep2"]
    for overlap in (True, False):
        cases.append(dict(
            name=f"trace-{overlap}", kind="trace", world=world, tp=tp,
            par=par, cfg=_cfgs(moe_comm_overlap=overlap)[1],
            opt=OptimizerConfig(**OPT),
            train=_train_cfg(train_iters=1, micro_batch_size=2,
                             trace=True,
                             trace_dir=f"{paths['trace']}-{overlap}",
                             trace_interval=10,
                             continuous_trace_iterations=1)))
    cases.append(dict(name="layout", kind="split", world=4, tp=2,
                      par={"expert_parallel": 2}))
    cases.append(dict(name="layout-dp2ep2", kind="split", world=4, tp=1,
                      par={"expert_parallel": 2}))
    started = W.start_ranks(4, str(d / "store"), cases)
    jax_runs = {g: _jax_losses(g) for g in JAX_GRIDS}
    ranks = W.collect(started, timeout=600)
    return {"ranks": ranks, "jax": jax_runs, "paths": paths}


def _rep(run, name, rank=0):
    return run["ranks"][rank][name]


def test_golden_gpt_tiny_moe_ep2(run):
    with open(GOLDEN) as f:
        golden = json.load(f)["gpt_tiny_moe_ep2"]
    for r in (0, 1):
        np.testing.assert_allclose(_rep(run, "golden", r)["losses"], golden,
                                   rtol=2e-3)


@pytest.mark.parametrize("grid", sorted(JAX_GRIDS))
def test_ten_steps_match_jax(run, grid):
    got = _rep(run, grid)["losses"]
    assert len(got) == STEPS
    np.testing.assert_allclose(got, run["jax"][grid], rtol=0, atol=STEP_TOL)
    world = GRIDS[grid][0]
    for r in range(world):
        assert _rep(run, grid, r)["losses"] == got


@pytest.mark.parametrize("grid,one", [("ep2", "one"), ("ep2tp2", "one"),
                                      ("dp2-cap", "one-cap")])
def test_grids_train_as_one_rank(run, grid, one):
    a, b = _rep(run, grid), _rep(run, one)
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(a[key], b[key], rtol=ONE_RANK_TOL, atol=0)


def test_bulk_all_to_all_trains_as_the_chunked_one(run):
    bulk, chunked = _rep(run, "ep2-bulk"), _rep(run, "ep2")
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(bulk[key], chunked[key][:SHORT],
                                   rtol=1e-6, atol=0)


def _same(a_dir, b_dir):
    saved = CheckpointManager(a_dir).restore(None)
    again = CheckpointManager(b_dir).restore(None)
    assert set(saved) == set(again)
    for k, v in saved.items():
        if hasattr(v, "shape"):
            assert np.array_equal(np.asarray(again[k]), np.asarray(v)), k
        else:
            assert again[k] == v, k


def test_ep2_checkpoint_restores_on_one_device_bitwise(run):
    paths = run["paths"]
    meta = json.load(open(os.path.join(paths["save"], str(SHORT),
                                       "meta.json")))
    assert meta["written_under"]["ep"] == 2
    pretrain_gpt(_cfgs()[1], _train_cfg(
        train_iters=SHORT, load_dir=paths["save"], save_dir=paths["back"],
        save_interval=SHORT), OptimizerConfig(**OPT), device="cpu",
        log_fn=lambda s: None)
    _same(paths["save"], paths["back"])


def test_one_device_checkpoint_restores_at_ep2_bitwise(run):
    paths = run["paths"]
    assert _rep(run, "ckpt-load")["step"] == SHORT
    _same(paths["one"], paths["one_back"])


def _ctx(**par):
    return MeshContext(group=None, parallel=ParallelConfig(**par), rank=0,
                       device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("par", [
    dict(pipeline_parallel=2), dict(context_parallel=2),
    dict(forward_backward_disaggregating=True), dict(use_dpp=True)])
def test_moe_training_refusals_name_their_item(par):
    tc = _cfgs()[1]
    with pytest.raises(NotImplementedError, match=ITEM.replace(
            "(", r"\(").replace(")", r"\)")):
        check_moe_training(tc, _ctx(**par), None)
    with pytest.raises(NotImplementedError, match="MoE under"):
        check_moe_training(tc, None, ParallelConfig(**par))


def test_mtp_and_one_process_dpp_refusals():
    tc = _cfgs()[1]
    with pytest.raises(NotImplementedError, match="MoE with MTP depths"):
        pretrain_gpt(dataclasses.replace(tc, mtp_num_layers=1),
                     _train_cfg(train_iters=1), OptimizerConfig(**OPT),
                     device="cpu", log_fn=lambda s: None)
    with pytest.raises(NotImplementedError, match="MoE under MegaDPP"):
        pretrain_gpt(tc, _train_cfg(train_iters=1), OptimizerConfig(**OPT),
                     device="cpu", log_fn=lambda s: None,
                     parallel=ParallelConfig(pipeline_parallel=2,
                                             use_dpp=True))


def test_entry_point_takes_the_moe_and_ep_flags():
    from megatronapp_tpu_torch import pretrain_gpt as entry
    base = ["--device", "cpu", "--num-layers", "2", "--hidden-size", "64",
            "--num-attention-heads", "8", "--vocab-size", "128",
            "--max-position-embeddings", "64", "--seq-length", "16"]
    args = entry.parse_args(base + [
        "--num-experts", "4", "--moe-router-topk", "1",
        "--moe-ffn-hidden-size", "96", "--moe-aux-loss-coeff", "0.02",
        "--moe-z-loss-coeff", "0.001", "--moe-expert-capacity-factor", "1.5",
        "--moe-layer-freq", "2", "--moe-shared-expert-intermediate-size",
        "32", "--no-moe-comm-overlap", "--expert-model-parallel-size", "2"])
    model = entry.configs_from_args(args)[0]
    assert (model.num_moe_experts, model.moe_router_topk,
            model.moe_ffn_hidden_size, model.moe_aux_loss_coeff,
            model.moe_z_loss_coeff, model.moe_capacity_factor,
            model.moe_layer_freq, model.moe_shared_expert_intermediate_size,
            model.moe_comm_overlap) == (4, 1, 96, 0.02, 0.001, 1.5, 2, 32,
                                        False)
    assert entry.parallel_from_args(args).expert_parallel == 2
    preset = entry.configs_from_args(entry.parse_args(
        ["--preset", "mixtral-8x7b", "--num-layers", "2",
         "--moe-aux-loss-coeff", "0.05"]))[0]
    assert (preset.num_moe_experts, preset.moe_router_topk,
            preset.moe_aux_loss_coeff, preset.num_layers) == (8, 2, 0.05, 2)
    bad = entry.parse_args(base + ["--num-experts", "4",
                                   "--expert-model-parallel-size", "2",
                                   "--pipeline-model-parallel-size", "2"])
    with pytest.raises(NotImplementedError, match="MoE under pp, cp"):
        entry.parallel_from_args(bad)
    with pytest.raises(SystemExit):
        entry.parse_args(base + ["--expert-model-parallel-size", "0"])


def test_grid_places_ep_between_dp_and_cp(run):
    """rank = ((dp_index · ep + ep_index) · cp + cp_index) · tp + tp_index
    (JAX's axis order); the ep group and the dp × ep batch group."""
    for r in range(4):
        got = _rep(run, "layout", r)
        assert (got["ep_rank"], got["tp_rank"], got["dp_rank"]) == (
            r // 2, r % 2, 0)
        assert got["ep_ranks"] == [r % 2, r % 2 + 2]
        assert got["tp_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert got["batch_ranks"] == got["ep_ranks"]
        four = _rep(run, "layout-dp2ep2", r)
        assert (four["dp_rank"], four["ep_rank"], four["batch_rank"]) == (
            r // 2, r % 2, r)
        assert four["ep_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert four["dp_ranks"] == [r % 2, r % 2 + 2]
        assert four["batch_ranks"] == [0, 1, 2, 3]


def test_ep_collectives_are_counted_and_traced(run):
    chunked = _rep(run, "trace-True")["traffic"]
    bulk = _rep(run, "trace-False")["traffic"]
    # Two MoE layers, 1 microbatch of 2 rows: at ep 2 one hop out and one
    # back forward, the same two backward.
    assert chunked["send/ep"]["calls"] == 2 * 4
    assert chunked["recv/ep"]["calls"] == chunked["send/ep"]["calls"]
    assert "all_to_all/ep" not in chunked
    assert bulk["all_to_all/ep"]["calls"] == 2 * 4
    assert "send/ep" not in bulk
    for tr in (chunked, bulk):
        # The router statistics' mean a layer, the token count, the grads
        # of the leaves that are not experts; the experts' over dp (1).
        assert tr["all_reduce/batch"]["calls"] >= 3
        assert tr["reduce_scatter/batch"]["calls"] == 1
    path = run["paths"]["trace"]
    recs = json.load(open(sorted(glob.glob(os.path.join(
        f"{path}-True", "benchmark-data-*.json")))[0]))
    permute = [r for r in recs if r["name"] == "moe-a2a-permute"]
    compute = [r for r in recs if r["name"] == "moe-a2a-compute"]
    assert {r["ph"] for r in permute} == {"B", "E"}
    assert {r["args"]["op"] for r in permute} == {"fwd", "ret"}
    assert {"rank", "step"} <= set(permute[0]["args"])
    # A layer's forward: the own chunk and the arrived one, B and E each.
    assert len(compute) == 2 * 2 * 2
    hops = [r for r in recs if r["name"] == "collective-permute"]
    assert len(hops) == chunked["send/ep"]["calls"]
    assert all(r["ph"] == "X" and r["args"]["axes"] == "ep" for r in hops)
