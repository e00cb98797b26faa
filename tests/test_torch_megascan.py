"""MegaScan in the port against the JAX package, on the CPU.

- The offline passes: aggregate_dir (with and without detection),
  build_dependencies, amend_p2p, detect_stage1, detect_stage2,
  stage_step_gaps, try_detect and analyze give equal outputs on the same
  seeded per-process event lists (every pass is a copy, so equality is
  exact).
- Traced training: the port's pretrain_gpt on the CPU (2 layers, h 64,
  6 iterations, 2 microbatches, interval 3, continuous 1) beside the JAX
  trainer on one CPU device: the same file name, the same traced
  iterations and per-iteration multiset of (name, ph), JAX's aggregate_dir
  reads the port's file into the same X events by name and count, and the
  losses with tracing on equal those with it off bit for bit. The JAX
  file's order within a step is the order XLA ran its unordered
  io_callbacks (e.g. 'backward' opening inside 'forward'); the port's is
  the stream order, pinned here as its own sequence.
- The granularity filter and the interval windows are the JAX tracer's.
"""

import copy
import json
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.trace import aggregate as j_agg
from megatronapp_tpu.trace import analytics as j_an
from megatronapp_tpu.trace import dependency as j_dep
from megatronapp_tpu.trace import detect as j_det
from megatronapp_tpu.trace import tracer as j_tracer
from megatronapp_tpu_torch.trace import aggregate as t_agg
from megatronapp_tpu_torch.trace import analytics as t_an
from megatronapp_tpu_torch.trace import dependency as t_dep
from megatronapp_tpu_torch.trace import detect as t_det
from megatronapp_tpu_torch.trace import tracer as t_tracer

TRAIN_FILE = "benchmark-data-1-pipeline-1-tensor-1-process-0.json"
PHASES = ("forward", "loss", "backward")


def _records(seed: int, n_pids: int = 4, n_iters: int = 8,
             slow_pid: int = 2):
    """Seeded per-process records: schedule phases per microbatch, grouped
    all-reduces across the pids, a p2p exchange and ring-hop spans;
    `slow_pid` runs its backward 1.3x longer, so it waits less in the
    'allreduce' phase and its 'all-reduce' ends first (the reference's
    two detection stages)."""
    rng = np.random.default_rng(seed)
    per = {}
    for pid in range(n_pids):
        recs = []
        for it in range(n_iters):
            t = 0.0
            recs.append({"name": "iteration", "ph": "B", "ts": 0.0,
                         "pid": pid, "tid": 0, "iteration": it,
                         "args": {"iteration": it}})
            for mb in range(2):
                for name, base in (("forward", 30.0), ("backward", 60.0),
                                   ("loss", 2.0)):
                    dur = base * rng.uniform(0.95, 1.05)
                    if name == "backward" and pid == slow_pid:
                        dur *= 1.3
                    recs.append({"name": name, "ph": "B", "ts": t,
                                 "pid": pid, "tid": 0, "iteration": it,
                                 "args": {"mb": mb}})
                    t += dur
                    recs.append({"name": name, "ph": "E", "ts": t,
                                 "pid": pid, "tid": 0, "iteration": it,
                                 "args": {"mb": mb}})
            for name in ("allreduce", "all-reduce"):
                wait = 20.0 * rng.uniform(0.9, 1.1)
                if pid == slow_pid:
                    wait *= 0.5
                args = {"group": list(range(n_pids)), "bytes": 4096,
                        "bandwidth": float(rng.uniform(1, 9))}
                recs.append({"name": name, "ph": "B", "ts": t, "pid": pid,
                             "tid": 0, "iteration": it, "args": args})
                # The collective ends together on every rank, the slow
                # one a hair early.
                t = (max(t + wait, 400.0) - (0.5 if pid == slow_pid
                                             else 0.0)
                     if name == "all-reduce" else t + wait)
                recs.append({"name": name, "ph": "E", "ts": t, "pid": pid,
                             "tid": 0, "iteration": it, "args": {}})
            if pid in (0, 1):
                # One p2p exchange between pids 0 and 1 (both sides of a
                # transfer carry its name and group).
                name = "exchange-next"
                recs.append({"name": name, "ph": "B", "ts": t, "pid": pid,
                             "tid": 0, "iteration": it,
                             "args": {"group": [0, 1],
                                      "bandwidth": float(pid + 1)}})
                t += 5.0 + 3.0 * pid
                recs.append({"name": name, "ph": "E", "ts": t, "pid": pid,
                             "tid": 0, "iteration": it, "args": {}})
            for hop in range(3):
                recs.append({"name": "pp-overlap-permute", "ph": "B",
                             "ts": t, "pid": pid, "tid": 1,
                             "iteration": it,
                             "args": {"op": "pp-schedule", "rank": pid}})
                t += 1.0
                recs.append({"name": "pp-overlap-permute", "ph": "E",
                             "ts": t, "pid": pid, "tid": 1,
                             "iteration": it, "args": {}})
                t += float(rng.uniform(3, 6))
            recs.append({"name": "iteration", "ph": "E", "ts": t + 1.0,
                         "pid": pid, "tid": 0, "iteration": it,
                         "args": {}})
        per[pid] = recs
    return per


def _write(per, d):
    os.makedirs(d, exist_ok=True)
    for pid, recs in per.items():
        with open(os.path.join(d, f"benchmark-data-process-{pid}.json"),
                  "w") as f:
            json.dump(recs, f)
    return str(d)


def _events(mod_agg, mod_dep, per):
    merged = mod_agg.aggregate_benchmark_data(copy.deepcopy(per))
    events = mod_agg.transform_to_complete_events(merged)
    related = mod_dep.build_dependencies(events)
    return events, related


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("detect", [False, True])
def test_aggregate_dir_matches_jax(tmp_path, seed, detect):
    d = _write(_records(seed), tmp_path / "t")
    want = j_agg.aggregate_dir(d, os.path.join(d, "j.json"), detect=detect)
    j_abnormal = (open(os.path.join(d, "abnormal.txt")).read()
                  if detect and os.path.exists(
                      os.path.join(d, "abnormal.txt")) else None)
    if j_abnormal is not None:
        os.remove(os.path.join(d, "abnormal.txt"))
    got = t_agg.aggregate_dir(d, os.path.join(d, "t.json"), detect=detect)
    assert got == want
    assert json.load(open(os.path.join(d, "t.json"))) == json.load(
        open(os.path.join(d, "j.json")))
    t_abnormal = (open(os.path.join(d, "abnormal.txt")).read()
                  if os.path.exists(os.path.join(d, "abnormal.txt"))
                  else None)
    assert t_abnormal == j_abnormal
    if detect:
        assert t_abnormal == "Abnormal chip: process 2\n"


@pytest.mark.parametrize("seed", [0, 3])
def test_dependencies_and_p2p_match_jax(seed):
    per = _records(seed)
    ev_j, rel_j = _events(j_agg, j_dep, per)
    ev_t, rel_t = _events(t_agg, t_dep, per)
    assert rel_t == rel_j and ev_t == ev_j
    j_dep.amend_p2p(ev_j, rel_j)
    t_dep.amend_p2p(ev_t, rel_t)
    assert ev_t == ev_j
    assert any("orig_dur" in e["args"] for e in ev_t)


@pytest.mark.parametrize("seed", [0, 5])
def test_detection_matches_jax(seed):
    per = _records(seed)
    ev_j, rel_j = _events(j_agg, j_dep, per)
    ev_t, rel_t = _events(t_agg, t_dep, per)
    assert t_det.detect_stage1(ev_t) == j_det.detect_stage1(ev_j)
    for pid in range(4):
        assert (t_det.detect_stage2(ev_t, rel_t, pid)
                == j_det.detect_stage2(ev_j, rel_j, pid))
    assert t_det.try_detect(ev_t, rel_t) == j_det.try_detect(ev_j, rel_j)
    assert t_det.try_detect(ev_t, rel_t) == [2]
    merged = j_agg.aggregate_benchmark_data(copy.deepcopy(per))
    assert (t_det.stage_step_gaps(merged)
            == j_det.stage_step_gaps(copy.deepcopy(merged)))


def test_analytics_match_jax(tmp_path):
    d = _write(_records(7), tmp_path / "t")
    got, want = t_an.analyze(d), j_an.analyze(d)
    assert got == want
    assert got["iteration_time"]["iterations"] == 4 * 8
    events = [e for e in j_agg.aggregate_dir(d)["traceEvents"]
              if e.get("ph") == "X"]
    for e in events[:40:3]:
        e["args"].update(hlo_op="all-reduce.1", bandwidth_gbps=2.5,
                         bytes=64)
    assert (t_an.collective_stats(copy.deepcopy(events))
            == j_an.collective_stats(copy.deepcopy(events)))
    assert t_an.phase_windows(events) == j_an.phase_windows(events)
    assert t_an.compute_comm_ratio(events) == j_an.compute_comm_ratio(
        events)


@pytest.mark.parametrize("gran", ["full", "schedule", "collective",
                                  "bogus"])
def test_granularity_filter_matches_jax(gran):
    names = sorted(set().union(*t_tracer.GRANULARITY_EVENTS.values())
                   | {"iteration", "custom-span", "decode"})
    assert t_tracer.GRANULARITY_EVENTS == j_tracer.GRANULARITY_EVENTS
    jt, tt = j_tracer.Tracer(), t_tracer.Tracer()
    jt.granularity = tt.granularity = gran
    assert [tt._allowed(n) for n in names] == [jt._allowed(n)
                                               for n in names]


def test_tracer_windows_scopes_and_attrs_on_the_cpu_clock(tmp_path):
    """Interval windows as the JAX tracer's; a scope's B/E with its attrs
    and an instant on the host clock; nothing recorded outside a
    window."""
    tr = t_tracer.Tracer()
    tr.configure(enabled=True, trace_dir=str(tmp_path), interval=4,
                 continuous_iterations=2, granularity="schedule")
    jt = j_tracer.Tracer()
    jt.interval, jt.continuous_iterations = 4, 2
    for it in range(9):
        assert tr._window_active(it) == jt._window_active(it)
        tr.iteration_begin(it)
        with tr.scope("forward", mb=0, tokens=8):
            tr.instant("data")
            tr.instant("custom")          # filtered at 'schedule'
        tr.iteration_end(it)
    recs = tr.drain()
    assert sorted({r["iteration"] for r in recs}) == [0, 1, 4, 5, 8]
    one = [(r["name"], r["ph"]) for r in recs if r["iteration"] == 4]
    assert one == [("iteration", "B"), ("forward", "B"), ("data", "i"),
                   ("forward", "E"), ("iteration", "E")]
    b = next(r for r in recs if r["name"] == "forward" and r["ph"] == "B")
    assert b["args"] == {"mb": 0, "tokens": 8}
    ts = [r["ts"] for r in recs if r["iteration"] == 4]
    assert ts[0] == 0.0 and ts == sorted(ts)
    tr.finalize()
    assert not os.listdir(tmp_path)        # drained: nothing to save


# ---------------------------------------------------------------------------
# traced training, the port beside the JAX trainer
# ---------------------------------------------------------------------------

MODEL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=64)
TRAIN = dict(micro_batch_size=2, global_batch_size=4, seq_length=32,
             train_iters=6, log_interval=3, trace_interval=3,
             continuous_trace_iterations=1)


def _by_iteration(path):
    with open(path) as f:
        recs = json.load(f)
    out = {}
    for r in recs:
        out.setdefault(r["iteration"], []).append((r["name"], r["ph"]))
    return out


def _port_run(trace_dir=None, granularity="full"):
    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.config.transformer_config import (
        TransformerConfig,
    )
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    cfg = TransformerConfig(compute_dtype=torch.float32, **MODEL)
    train = TrainingConfig(trace=trace_dir is not None,
                           trace_dir=trace_dir or "trace",
                           trace_granularity=granularity, **TRAIN)
    res = pretrain_gpt(cfg, train, OptimizerConfig(lr=1e-3), device="cpu",
                       log_fn=lambda s: None)
    return res.losses


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    """The JAX trainer's trace of the same run, on one CPU device."""
    from megatronapp_tpu.config.parallel_config import ParallelConfig
    from megatronapp_tpu.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu.config.transformer_config import TransformerConfig
    from megatronapp_tpu.parallel.mesh import build_mesh
    from megatronapp_tpu.training.train import pretrain_gpt
    d = str(tmp_path_factory.mktemp("jax_trace"))
    par = ParallelConfig()
    pretrain_gpt(TransformerConfig(compute_dtype=jnp.float32, **MODEL), par,
                 TrainingConfig(trace=True, trace_dir=d, **TRAIN),
                 OptimizerConfig(lr=1e-3),
                 ctx=build_mesh(par, devices=jax.devices()[:1]),
                 log_fn=lambda m: None)
    return d


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_trace"))
    return d, _port_run(d)


def test_traced_training_files_match_jax(jax_trace, port_trace):
    d, _ = port_trace
    assert sorted(os.listdir(d)) == sorted(os.listdir(jax_trace)) == [
        TRAIN_FILE]
    got = _by_iteration(os.path.join(d, TRAIN_FILE))
    want = _by_iteration(os.path.join(jax_trace, TRAIN_FILE))
    assert sorted(got) == sorted(want) == [0, 3]
    for it in got:
        assert Counter(got[it]) == Counter(want[it]), it
        per_micro = [("forward", "B"), ("forward", "E"), ("loss", "B"),
                     ("loss", "E"), ("backward", "B"), ("backward", "E")]
        assert got[it] == ([("iteration", "B"), ("train-step", "B")]
                           + 2 * per_micro
                           + [("allreduce", "B"), ("allreduce", "E"),
                              ("optimizer", "B"), ("optimizer", "E"),
                              ("train-step", "E"), ("iteration", "E")])


def test_jax_aggregate_reads_the_port_trace(jax_trace, port_trace):
    d, _ = port_trace

    def x_names(trace):
        return Counter((e["name"], e["args"]["iteration"])
                       for e in trace["traceEvents"] if e.get("ph") == "X")

    got = j_agg.aggregate_dir(d)
    assert x_names(got) == x_names(j_agg.aggregate_dir(jax_trace))
    assert got == t_agg.aggregate_dir(d)
    report = j_an.analyze(d)
    assert report["phases"]["forward"]["count"] == 4
    assert report["iteration_time"]["iterations"] == 2
    # Every phase lies inside its train-step on the port's clock.
    xs = [e for e in got["traceEvents"] if e.get("ph") == "X"]
    for it in (0, 3):
        step = next(e for e in xs if e["name"] == "train-step"
                    and e["args"]["iteration"] == it)
        for e in xs:
            if e["args"]["iteration"] == it and e["name"] in PHASES:
                assert step["ts"] <= e["ts"]
                assert e["ts"] + e["dur"] <= step["ts"] + step["dur"]


def test_tracing_leaves_the_losses_bitwise(port_trace):
    _, traced = port_trace
    assert traced == _port_run() == _port_run()


def test_a_failed_traced_run_leaves_the_tracer_off(tmp_path):
    """A traced pretrain_gpt that raises mid-run keeps the iterations it
    closed and leaves the process-wide tracer disabled, so a later
    untraced run records nothing."""
    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.config.transformer_config import (
        TransformerConfig,
    )
    from megatronapp_tpu_torch.training.train import pretrain_gpt

    def stop(msg):
        raise RuntimeError("stop")

    cfg = TransformerConfig(compute_dtype=torch.float32, **MODEL)
    d = str(tmp_path / "t")
    with pytest.raises(RuntimeError, match="stop"):
        pretrain_gpt(cfg, TrainingConfig(trace=True, trace_dir=d, **TRAIN),
                     OptimizerConfig(lr=1e-3), device="cpu", log_fn=stop)
    tracer = t_tracer.get_tracer()
    assert not tracer.enabled and not tracer.active
    path = os.path.join(d, TRAIN_FILE)
    assert sorted(_by_iteration(path)) == [0]
    with open(path) as f:
        before = f.read()
    _port_run()
    with open(path) as f:
        assert f.read() == before
    assert tracer.drain() == []


def test_schedule_granularity_keeps_the_phase_spans(tmp_path, port_trace):
    d, _ = port_trace
    sched = str(tmp_path / "sched")
    _port_run(sched, "schedule")
    assert (_by_iteration(os.path.join(sched, TRAIN_FILE))
            == _by_iteration(os.path.join(d, TRAIN_FILE)))


def test_entry_point_trace_flags():
    """--trace and its companions with the JAX parser's defaults."""
    from megatronapp_tpu_torch import pretrain_gpt
    args = pretrain_gpt.parse_args([])
    _, train, _ = pretrain_gpt.configs_from_args(args)
    assert (train.trace, train.trace_interval,
            train.continuous_trace_iterations, train.trace_dir,
            train.trace_granularity) == (False, 5, 2, "trace", "full")
    args = pretrain_gpt.parse_args([
        "--trace", "--trace-interval", "3", "--continuous-trace-iterations",
        "1", "--trace-dir", "/x", "--trace-granularity", "schedule"])
    _, train, _ = pretrain_gpt.configs_from_args(args)
    assert (train.trace, train.trace_interval,
            train.continuous_trace_iterations, train.trace_dir,
            train.trace_granularity) == (True, 3, 1, "/x", "schedule")
