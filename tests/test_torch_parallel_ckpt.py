"""Checkpoints, signals, MegaScan's collective events and gather_tree on
the port's dp × tp training grid, fp32 on the CPU.

One spawn of four gloo ranks (tests/torch_parallel_worker.py, no jax)
runs the cases after the test process has trained on one device:

- Checkpoints hold every leaf whole (params gathered over tp, ZeRO-1's m
  and v over dp and tp), written once by rank 0: a step saved on one
  device resumes at dp 2 × tp 2 and one saved at dp 2 × tp 2 resumes on
  one device, each within 1e-5 of the straight one-device run; a resume
  on the same grid is bitwise; meta.json records the grid.
- SIGTERM to rank 1 alone stops both ranks after the same step, with one
  emergency save.
- A traced tp 2 step: one X event a collective, with the contract's
  fields (JAX trace/profiler_collectives.py collective_events), bytes
  equal to the tensors' (and to the collective counters), groups equal
  to the grid's; the merged trace goes through build_dependencies and
  detect_stage2.
- gather_tree(shard_tree(tree)) is the tree bitwise at tp 2 and tp 4.
- MTP depths under dp alone run and give the one-device losses.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch_parallel_worker as W
from test_torch_layers import cfg_pair
from test_torch_parallel_sharding import GATED

from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.trace.aggregate import aggregate_dir
from megatronapp_tpu_torch.trace.dependency import build_dependencies
from megatronapp_tpu_torch.trace.detect import detect_stage2
from megatronapp_tpu_torch.training.checkpointing import CheckpointManager
from megatronapp_tpu_torch.training.train import pretrain_gpt

MODEL = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
             num_query_groups=4, ffn_hidden_size=128, vocab_size=128,
             max_position_embeddings=64, normalization="rmsnorm",
             activation="swiglu", position_embedding="rope",
             add_bias_linear=False, qk_layernorm=True,
             untie_embeddings_and_output_weights=True)
SEQ = 16
OPT = OptimizerConfig(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=6)
CONTRACT = {"id", "group", "bytes", "axes", "bandwidth_gbps", "process",
            "device", "iteration"}


def _cfg():
    return cfg_pair(**MODEL)[1]


def _mtp_cfg():
    return cfg_pair(**dict(MODEL, mtp_num_layers=1))[1]


def _train(**kw):
    return TrainingConfig(**{**dict(micro_batch_size=1, global_batch_size=4,
                                    seq_length=SEQ, train_iters=6,
                                    log_interval=1, seed=1234), **kw})


def _one_device(**kw):
    res = pretrain_gpt(_cfg(), _train(**kw), OPT, device="cpu",
                       log_fn=lambda s: None)
    return [m["loss"] for m in res.log]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The one-device runs, then every rank's reports from one spawn."""
    d = tmp_path_factory.mktemp("parallel_ckpt")
    paths = {k: str(d / k) for k in ("one", "from_one", "grid", "grid2",
                                     "signal", "trace")}
    straight = _one_device()
    mtp = pretrain_gpt(_mtp_cfg(), _train(train_iters=2), OPT, device="cpu",
                       log_fn=lambda s: None).log
    _one_device(train_iters=3, save_dir=paths["one"], save_interval=3)
    jc, tc = cfg_pair(**GATED)
    tree = W.np_tree(jax.tree.map(
        np.asarray, jgpt.init_gpt_params(jax.random.PRNGKey(0), jc)[0]))
    grid = dict(kind="train", world=4, tp=2, cfg=_cfg(), opt=OPT)
    cases = [
        dict(grid, name="from-one", train=_train(
            load_dir=paths["one"], save_dir=paths["from_one"])),
        dict(grid, name="grid-straight", train=_train()),
        dict(grid, name="grid-save", train=_train(
            train_iters=3, save_dir=paths["grid"], save_interval=3)),
        dict(grid, name="grid-resume", train=_train(
            load_dir=paths["grid"], save_dir=paths["grid2"],
            save_interval=3)),
        dict(name="signal", kind="signal", world=2, tp=1, cfg=_cfg(),
             opt=OPT, signal_rank=1, signal_at=3, train=_train(
                 train_iters=8, save_dir=paths["signal"],
                 exit_signal_handler=True)),
        dict(name="trace", kind="trace", world=2, tp=2, cfg=_cfg(), opt=OPT,
             train=_train(train_iters=1, micro_batch_size=4, trace=True,
                          trace_dir=paths["trace"], trace_interval=10,
                          continuous_trace_iterations=1)),
        dict(name="mtp-dp2", kind="train", world=2, tp=1, opt=OPT,
             cfg=_mtp_cfg(), train=_train(train_iters=2)),
        dict(name="roundtrip-tp2", kind="roundtrip", world=2, tp=2, cfg=tc,
             params=tree),
        dict(name="roundtrip-tp4", kind="roundtrip", world=4, tp=4, cfg=tc,
             params=tree),
    ]
    ranks = W.spawn_ranks(4, str(d / "store"), cases)
    return {"paths": paths, "straight": straight, "ranks": ranks,
            "mtp": mtp}


def test_one_device_checkpoint_resumes_on_the_grid(run):
    got = run["ranks"][0]["from-one"]["losses"]
    np.testing.assert_allclose(got, run["straight"][3:], rtol=0, atol=1e-5)
    for r in range(1, 4):
        assert run["ranks"][r]["from-one"]["losses"] == got


def test_grid_checkpoint_resumes_bitwise_on_the_grid(run):
    r0 = run["ranks"][0]
    straight = r0["grid-straight"]["losses"]
    np.testing.assert_allclose(straight, run["straight"], rtol=0, atol=1e-5)
    assert r0["grid-save"]["losses"] + r0["grid-resume"]["losses"] == \
        straight


def test_grid_checkpoint_resumes_on_one_device(run, tmp_path):
    got = _one_device(load_dir=run["paths"]["grid"],
                      save_dir=str(tmp_path / "again"))
    np.testing.assert_allclose(got, run["straight"][3:], rtol=0, atol=1e-5)


def test_checkpoints_hold_whole_leaves_and_their_grid(run):
    """Rank 0 alone wrote: one step directory a save, every leaf at its
    one-device shape, and meta.json's written_under."""
    grid = CheckpointManager(run["paths"]["grid"])
    one = CheckpointManager(run["paths"]["one"])
    assert grid.all_steps() == one.all_steps() == [3]
    assert CheckpointManager(run["paths"]["grid2"]).all_steps() == [6]
    metas = [json.load(open(os.path.join(m.directory, "3", "meta.json")))
             for m in (grid, one)]
    assert metas[0]["written_under"] == {"dp": 2, "tp": 2, "zero1": True}
    assert "written_under" not in metas[1]
    assert metas[0]["leaves"] == metas[1]["leaves"]
    assert not [f for f in os.listdir(grid.directory)
                if f.startswith(".")]


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(run):
    for r in (0, 1):
        rep = run["ranks"][r]["signal"]
        assert rep["interrupted"] and rep["step"] == 3
        assert len(rep["losses"]) == 3
    assert CheckpointManager(run["paths"]["signal"]).all_steps() == [3]


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f) if e["ph"] == "X"]


def test_traced_step_records_one_event_a_collective(run):
    trace = run["paths"]["trace"]
    rows, hidden = 4, MODEL["hidden_size"]
    big, small = rows * SEQ * hidden * 4, rows * SEQ * 4
    for r in (0, 1):
        evs = _events(os.path.join(
            trace, f"benchmark-data-1-pipeline-1-tensor-2-process-{r}.json"))
        traffic = run["ranks"][r]["trace"]["traffic"]
        assert all(CONTRACT <= set(e["args"]) for e in evs)
        assert {e["pid"] for e in evs} == {1000 * (r + 1)}
        assert all(e["args"]["process"] == r == e["args"]["device"]
                   for e in evs)
        by = {}
        for e in evs:
            key = (e["name"].replace("-", "_") + "/" + e["args"]["axes"])
            by.setdefault(key, []).append(e["args"]["bytes"])
            assert e["args"]["group"] == [0, 1]
        assert {k: {"calls": len(v), "bytes": sum(v)}
                for k, v in by.items()} == traffic
        # One micro-batch of 4 rows: 2 + 4 L activations of S x H fp32
        # (embedding, attention and MLP outputs, their backward inputs,
        # the head's input), the CE's three [rows, S] fp32, the qk-norm
        # scales' grads (2 layers x 2 x head_dim fp32), then the world
        # all-gather of 5 metrics a rank.
        assert sorted(by["all_reduce/tp"]) == sorted(
            [big] * 10 + [small] * 3 + [2 * 2 * 8 * 4])
        assert by["all_gather/world"] == [2 * 5 * 4]


def test_merged_trace_feeds_dependencies_and_detect(run):
    out = aggregate_dir(run["paths"]["trace"])
    events = [e for e in out["traceEvents"] if e["ph"] != "M"]
    coll = [e for e in events if e["ph"] == "X" and "group" in e["args"]]
    related = build_dependencies(events)
    sets = {frozenset(v) for v in related.values()}
    assert len(coll) == 2 * len(sets) and all(len(s) == 2 for s in sets)
    for s in sets:
        assert len({next(e for e in coll if e["args"]["id"] == i)["pid"]
                    for i in s}) == 2
    assert {r: type(detect_stage2(events, related, r)) for r in (0, 1)} == \
        {0: bool, 1: bool}


def test_mtp_depths_run_under_dp_alone(run):
    """MTP under dp 2 (no layer change; each depth's token mean spans
    both ranks' rows) gives the one-device run's loss and mtp_loss."""
    for r in (0, 1):
        got = run["ranks"][r]["mtp-dp2"]
        np.testing.assert_allclose(got["losses"],
                                   [m["loss"] for m in run["mtp"]],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["mtp_losses"],
                                   [m["mtp_loss"] for m in run["mtp"]],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["roundtrip-tp2", "roundtrip-tp4"])
def test_gather_tree_inverts_shard_tree_bitwise(run, name):
    tp = int(name[-1])
    for r in range(tp):
        rep = run["ranks"][r][name]
        assert rep["same"] and all(rep["same"].values())
    shapes = run["ranks"][0][name]["local_shapes"]
    assert shapes["layers.0.attention.kv_kernel"] == (64, 2 * 4 * 8 // tp)
    assert shapes["layers.0.mlp.fc1_kernel"] == (64, 2 * 96 // tp)


@pytest.mark.parametrize("granularity", ["full", "schedule", "collective"])
def test_tracer_collective_events_carry_the_rank_and_follow_the_filter(
        tmp_path, granularity):
    """The records carry the rank (scopes on its pid, a collective on its
    device row 1000 · (rank + 1)), and 'schedule' drops collective
    events as JAX's granularity filter does."""
    from megatronapp_tpu_torch.trace.tracer import Tracer
    t = Tracer()
    t.configure(trace_dir=str(tmp_path), interval=1, rank=3,
                granularity=granularity)
    t.iteration_begin(0)
    with t.scope("forward"):
        with t.collective("all-reduce", group=[2, 3], bytes=64, axes="tp"):
            pass
    t.iteration_end(0)
    recs = t.drain()
    coll = [r for r in recs if r["ph"] == "X"]
    assert {r["pid"] for r in recs if r["ph"] != "X"} == {3}
    if granularity == "schedule":
        assert not coll
        return
    assert len(coll) == 1 and coll[0]["pid"] == 4000
    assert CONTRACT <= set(coll[0]["args"]) and coll[0]["dur"] >= 0
