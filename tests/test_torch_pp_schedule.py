"""The port's pipeline schedule layer against the JAX package's, and the
pipeline's trace-driven planner, refusals and flags, on the CPU.

- The copied programs are JAX's: forward_tables, zb_backward_tables,
  combined_programs, simulate_timeline and analytic_vpp_bubble give
  identical values over a grid of (pp, M, vpp), and validate_programs
  refuses the same corrupted programs with the same messages.
- The Planner fed the same samples plans, re-plans and exports the same
  gauges as JAX's; the port's stage_step_gaps mines the same gaps.
- Layer placement: each stage's layers.<id> are JAX's
  reshape_params_for_pipeline [stage, chunk, i] slices bitwise, and the
  seeded init on a stage is that stage's pieces of the one-device init.
- On 2 spawned gloo ranks (tests/torch_parallel_worker.py, no jax):
  --pp-plan-from-trace re-plans 1f1b → zero-bubble and keeps the losses
  (JAX's test_plan_from_trace_replans_and_preserves_losses); a traced
  pp 2 run's merged trace gives stage_step_gaps samples for both stages,
  which the Planner takes; a packed batch freezes planning and reverts
  zero-bubble to 1f1b with the losses kept; packed batches through the
  pipeline give one device's losses; each rank's hops are the tables'
  reckoning.
- Refusals name their item or carry JAX's message: MTP under pp, 'vpp'
  without vpp, an interleaved M not divisible by pp (at startup for a
  rampup stage too), zero-bubble on packed sequences; the pp flags parse
  with JAX's parse-time rules.
"""

import os

import jax
import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_layers import cfg_pair

from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.parallel import schedule as jsched
from megatronapp_tpu.parallel.pipeline import reshape_params_for_pipeline
from megatronapp_tpu.utils import metrics as jmetrics
from megatronapp_tpu_torch import pretrain_gpt as entry
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.parallel import schedule as sched
from megatronapp_tpu_torch.parallel.mesh import MeshContext
from megatronapp_tpu_torch.utils import metrics as tmetrics

GRID = [(pp, m, vpp) for pp in (2, 3, 4) for vpp in (1, 2)
        for m in (pp, 2 * pp, 3 * pp + 1)]
TINY = dict(num_layers=4, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)


def fake_ctx(pp, stage, vpp=1, tp=1, tp_rank=0):
    """A stage rank's view without groups (placement only)."""
    return MeshContext(group=None, parallel=ParallelConfig(
        tensor_parallel=tp, pipeline_parallel=pp,
        virtual_pipeline_parallel=vpp, data_parallel=1),
        rank=stage * tp + tp_rank, device=torch.device("cpu"),
        backend="gloo")


@pytest.mark.parametrize("pp,m,vpp", GRID)
def test_tables_are_jax(pp, m, vpp):
    for a, b in zip(sched.forward_tables(pp, m, vpp),
                    jsched.forward_tables(pp, m, vpp)):
        assert np.array_equal(a, b)
    for a, b in zip(sched.zb_backward_tables(pp, m, vpp),
                    jsched.zb_backward_tables(pp, m, vpp)):
        assert np.array_equal(a, b)
    if vpp == 1 or m % pp == 0:
        sched.validate_programs(pp, m, vpp, sched.forward_tables(pp, m, vpp),
                                sched.zb_backward_tables(pp, m, vpp))
    for name in sched.SCHEDULES:
        assert [[(i.kind, i.mb, i.chunk) for i in prog] for prog in
                sched.combined_programs(name, pp, m)] == \
            [[(i.kind, i.mb, i.chunk) for i in prog] for prog in
             jsched.combined_programs(name, pp, m)]
        costs = [1.0 + 0.25 * s for s in range(pp)]
        assert sched.simulate_timeline(name, pp, m, costs, comm=0.1,
                                       bwd_ratio=1.5) == \
            jsched.simulate_timeline(name, pp, m, costs, comm=0.1,
                                     bwd_ratio=1.5)
    assert sched.analytic_vpp_bubble(pp, m, vpp, [1.0] * pp) == \
        jsched.analytic_vpp_bubble(pp, m, vpp, [1.0] * pp)
    assert sched.stage_cost_model(None, pp, vpp) == \
        jsched.stage_cost_model(None, pp, vpp)


def _corruptions(lib):
    """(name, args of validate_programs) of corrupted pp-2 programs."""
    fwd = [a.copy() for a in lib.forward_tables(2, 4, 1)]
    kind, mb, ck = (a.copy() for a in lib.zb_backward_tables(2, 4, 1))
    out = []
    act, mbt, ckt = (a.copy() for a in fwd)
    dup = [t for t in range(act.shape[0]) if act[t, 0]][:2]
    mbt[dup[1], 0] = mbt[dup[0], 0]
    out.append(("duplicate F", (2, 4, 1, (act, mbt, ckt))))
    act, mbt, ckt = (a.copy() for a in fwd)
    ts = [t for t in range(act.shape[0]) if act[t, 1]]
    mbt[ts[0], 1], mbt[ts[1], 1] = mbt[ts[1], 1], mbt[ts[0], 1]
    out.append(("misaligned F", (2, 4, 1, (act, mbt, ckt))))
    k2 = kind.copy()
    k2[[t for t in range(k2.shape[0]) if k2[t, 0] == lib.KIND_W][0], 0] = \
        lib.KIND_NOP
    out.append(("missing W", (2, 4, 1, fwd, (k2, mb, ck))))
    k3 = kind.copy()
    tb = [t for t in range(k3.shape[0]) if k3[t, 1] == lib.KIND_B]
    k3[tb[1], 1] = lib.KIND_NOP
    out.append(("missing B", (2, 4, 1, fwd, (k3, mb, ck))))
    act, mbt, ckt = (a.copy() for a in fwd)
    act[[t for t in range(act.shape[0]) if act[t, 1]][-1], 1] = False
    out.append(("missing F", (2, 4, 1, (act, mbt, ckt))))
    return out


@pytest.mark.parametrize("case", [c[0] for c in _corruptions(sched)])
def test_validate_programs_refuses_what_jax_refuses(case):
    mine = dict(_corruptions(sched))[case]
    theirs = dict(_corruptions(jsched))[case]
    with pytest.raises(ValueError) as a:
        sched.validate_programs(*mine)
    with pytest.raises(ValueError) as b:
        jsched.validate_programs(*theirs)
    assert str(a.value) == str(b.value)


def _gap_events(gaps_by_stage, hop_us=50.0, op="pp-schedule"):
    events = []
    for stage, gaps in gaps_by_stage.items():
        ts = 1000.0
        for g in gaps:
            for ph, t in (("B", ts), ("E", ts + hop_us)):
                events.append({"name": "pp-overlap-permute", "ph": ph,
                               "ts": t, "pid": stage, "tid": 0,
                               "args": {"op": op, "rank": stage}})
            ts += hop_us + g
    return events


def test_planner_is_jax():
    """The same samples give the same plans, re-plans, costs and gauges;
    the port's stage_step_gaps mines what JAX's does."""
    from megatronapp_tpu.trace.detect import stage_step_gaps as jgaps
    from megatronapp_tpu_torch.trace.detect import stage_step_gaps
    ev = _gap_events({0: [100.0] * 9, 1: [300.0] * 9}) + _gap_events(
        {0: [50.0] * 4}, op="pp-1f1b-bwd")
    assert stage_step_gaps(ev) == jgaps(ev)
    jmetrics.enable()
    tmetrics.enable()
    try:
        got = []
        for lib in (sched, jsched):
            pl = lib.Planner(2)
            plans = [pl.plan(8)]
            pl.observe_step(0.5)
            plans.append(pl.maybe_replan(8))
            n = pl.ingest_trace_events(ev)
            plans.append(pl.maybe_replan(8))
            pl.export_metrics()
            got.append((n, pl.stage_costs(), pl.replans, [
                None if p is None else (p.schedule, p.bubble_fraction,
                                        p.candidates) for p in plans]))
        assert got[0] == got[1]
        assert got[0][0] == 8 + 8 + 3     # the gaps between hops
        gauges = [m.snapshot()["gauges"] for m in (tmetrics, jmetrics)]
        assert gauges[0] == gauges[1]
        assert 'pp_stage_step_time_ewma_ms{stage="1",vstage="0"}' in \
            gauges[0]
        assert 'pp_stage_step_time_ewma_ms{stage="1",vstage="0"}' in \
            tmetrics.render_prometheus()
        assert sched.Planner(2, vpp=2).plan(4).schedule == "vpp"
    finally:
        jmetrics.disable()
        tmetrics.disable()


@pytest.mark.parametrize("pp,vpp", [(2, 1), (2, 2), (4, 1)])
def test_layer_placement_is_jax(pp, vpp):
    """layers.<i> of stage s is JAX's reshaped block[s, c, i - ...] for
    every global layer i: chunk c of stage s holds [(c·pp + s)·Lc, ...);
    the embedding sits on stage 0, the final norm and output layer on the
    last stage."""
    jc, tc = cfg_pair(**dict(TINY, num_layers=8,
                             untie_embeddings_and_output_weights=True))
    jp = jax.tree.map(np.asarray, jgpt.init_gpt_params(
        jax.random.PRNGKey(0), jc)[0])
    staged = jax.tree.map(np.asarray,
                          reshape_params_for_pipeline(jp["block"], pp, vpp))
    lc = 8 // (pp * vpp)
    full = params_from_jax(jp, tc)
    seen = set()
    for s in range(pp):
        ctx = fake_ctx(pp, s, vpp)
        mine = dict(params_from_jax(jp, tc, ctx=ctx).named_parameters())
        ids = {int(n.split(".")[1]) for n in mine if n.startswith("layers.")}
        assert ids == {(c * pp + s) * lc + i for c in range(vpp)
                       for i in range(lc)}
        seen |= ids
        assert ("embedding.word" in mine) == (s == 0)
        assert ("output" in mine) == ("final_ln_scale" in mine) == \
            (s == pp - 1)
        for n, t in mine.items():
            if not n.startswith("layers."):
                assert torch.equal(t, dict(full.named_parameters())[n])
                continue
            _, lid, *rest = n.split(".")
            lid = int(lid)
            c, i = divmod(lid, lc)
            c //= pp
            i = lid - (c * pp + s) * lc
            leaf = staged
            for k in rest:
                leaf = leaf[k]
            assert np.array_equal(t.numpy(), leaf[s, c, i]), n
    assert seen == set(range(8))


@pytest.mark.parametrize("tied", [True, False])
def test_stage_init_is_the_one_device_init(tied):
    """A stage's seeded init is its pieces of the one-device init (each
    piece drawn whole, in order): a tied model's last stage also holds
    the word embedding."""
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.parallel.sharding import shard_tree
    _, tc = cfg_pair(**dict(TINY, untie_embeddings_and_output_weights=not
                            tied, position_embedding="learned_absolute"))
    whole = init_gpt_params(tc, torch.Generator().manual_seed(3), "cpu")
    for s in range(2):
        for tp_rank in range(2):
            ctx = fake_ctx(2, s, vpp=2, tp=2, tp_rank=tp_rank)
            mine = dict(init_gpt_params(tc, torch.Generator().manual_seed(3),
                                        "cpu", ctx).named_parameters())
            want = dict(shard_tree(whole, ctx).named_parameters())
            assert mine.keys() == want.keys()
            assert all(torch.equal(mine[n], want[n]) for n in want)
            assert ("embedding.word" in mine) == (s == 0 or tied)
            assert ("embedding.pos" in mine) == (s == 0)


def test_refusals_name_their_items_or_carry_jax_messages():
    from megatronapp_tpu.parallel.pipeline import spmd_pipeline  # noqa
    from megatronapp_tpu_torch.models.gpt import (
        gpt_pipeline_loss, init_gpt_params,
    )
    from megatronapp_tpu_torch.parallel.pipeline import check_schedule
    from megatronapp_tpu_torch.training.num_microbatches_calculator import (
        build_calculator,
    )
    from megatronapp_tpu_torch.training.train import (
        _validate_schedule_stages,
    )
    _, tc = cfg_pair(**dict(TINY, mtp_num_layers=1))
    with pytest.raises(NotImplementedError, match="MTP under grids"):
        init_gpt_params(tc, torch.Generator().manual_seed(0), "cpu",
                        fake_ctx(2, 0))
    _, tc = cfg_pair(**TINY)
    p = init_gpt_params(tc, torch.Generator().manual_seed(0), "cpu",
                        fake_ctx(2, 0))
    toks = torch.zeros(4, 1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError,
                       match="zero-bubble does not compose with packed"):
        gpt_pipeline_loss(p, {"tokens": toks, "labels": toks,
                              "loss_mask": toks.float(),
                              "segment_ids": toks.int()}, tc,
                          fake_ctx(2, 0), schedule="zero-bubble")
    with pytest.raises(ValueError, match="requires vpp > 1"):
        check_schedule(2, 4, 1, "vpp", "dfc", False)
    with pytest.raises(ValueError, match=r"num_microbatches \(3\) "
                       "divisible by pipeline_parallel"):
        check_schedule(2, 3, 2, "1f1b", "dfc", False)
    check_schedule(2, 3, 2, "1f1b", "bfc", False)
    with pytest.raises(ValueError, match="requires "
                       "virtual_pipeline_parallel > 1"):
        ParallelConfig(pipeline_parallel=2, pp_schedule="vpp")
    with pytest.raises(ValueError, match="'dfc' or 'bfc'"):
        ParallelConfig(pipeline_order_policy="depth")
    calc = build_calculator(12, 1, 1, (2, 1, 20))
    with pytest.raises(ValueError, match="batch size 3 in the schedule "
                       "gives 3 microbatches"):
        _validate_schedule_stages(calc, 2, 2, "dfc")
    _validate_schedule_stages(calc, 2, 2, "bfc")
    _validate_schedule_stages(calc, 2, 1, "dfc")


def test_pp_flags_follow_jax_parse_time_rules():
    from megatronapp_tpu.config.arguments import (
        build_parser, configs_from_args,
    )
    base = ("--num-layers 8 --hidden-size 64 --num-attention-heads 4 "
            "--vocab-size 128 --seq-length 32 --max-position-embeddings 64 "
            "--micro-batch-size 1 --global-batch-size 8 --train-iters 1")
    for extra in ("--pipeline-model-parallel-size 2",
                  "--pipeline-model-parallel-size 2 "
                  "--num-layers-per-virtual-pipeline-stage 2 "
                  "--pp-schedule vpp --pp-plan-from-trace",
                  "--pipeline-model-parallel-size 4 "
                  "--num-layers-per-virtual-pipeline-stage 1 "
                  "--pp-schedule zero-bubble"):
        argv = (base + " " + extra).split()
        mine = entry.parallel_from_args(entry.parse_args(argv))
        theirs = configs_from_args(build_parser().parse_args(argv))[1]
        for f in ("pipeline_parallel", "virtual_pipeline_parallel",
                  "pp_schedule", "pp_plan_from_trace",
                  "pipeline_order_policy"):
            assert getattr(mine, f) == getattr(theirs, f), (extra, f)


# ---- two spawned ranks -------------------------------------------------------

PLAN_TRAIN = dict(micro_batch_size=2, global_batch_size=8, seq_length=32,
                  log_interval=1, seed=1234)


def _cases(tmp):
    _, tc = cfg_pair(**TINY)
    opt = OptimizerConfig(lr=1e-3, lr_decay_iters=3)
    base = dict(world=2, tp=1, cfg=tc, opt=opt, keep_log=True)
    pp = dict(pipeline_parallel=2)
    plan = dict(pp, pp_plan_from_trace=True)
    return [
        dict(base, name="static", kind="trace", par=pp,
             train=TrainingConfig(train_iters=2, **PLAN_TRAIN)),
        dict(base, name="planned", kind="trace", par=plan,
             train=TrainingConfig(train_iters=2, **PLAN_TRAIN)),
        dict(base, name="traced", kind="trace", par=plan,
             train=TrainingConfig(
                 train_iters=3, trace=True, trace_dir=str(tmp / "trace"),
                 trace_interval=5, continuous_trace_iterations=1,
                 **PLAN_TRAIN)),
        dict(base, name="packed-static", kind="packed", par=pp,
             packed_from=1,
             train=TrainingConfig(train_iters=3, **PLAN_TRAIN)),
        dict(base, name="packed-planned", kind="packed", par=plan,
             packed_from=1,
             train=TrainingConfig(train_iters=3, **PLAN_TRAIN)),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_schedule")
    return W.spawn_ranks(2, str(tmp / "store"), _cases(tmp)), tmp


def test_plan_from_trace_replans_and_preserves_losses(ranks):
    reps, _ = ranks
    log = "\n".join(reps[0]["planned"]["log"])
    assert "pp-planner: active" in log
    assert "APPLYING schedule 'zero-bubble'" in log
    for r in (0, 1):
        np.testing.assert_allclose(reps[r]["planned"]["losses"],
                                   reps[r]["static"]["losses"],
                                   rtol=0, atol=1e-6)


def test_traced_hops_feed_the_planner(ranks):
    """The merged trace of the traced iteration holds each stage's hop
    spans with JAX's args; stage_step_gaps yields samples for both
    stages on each op's timeline, and the Planner takes them."""
    from megatronapp_tpu_torch.trace.aggregate import (
        collect_benchmark_files, read_benchmark_file,
    )
    from megatronapp_tpu_torch.trace.detect import stage_step_gaps
    reps, tmp = ranks
    assert "pp-planner: active" in "\n".join(reps[0]["traced"]["log"])
    files = collect_benchmark_files(str(tmp / "trace"))
    assert len(files) == 2
    events = [e for f in files for e in read_benchmark_file(f)
              if e.get("name") == "pp-overlap-permute"]
    ops = {e["args"]["op"] for e in events}
    assert ops <= {"pp-schedule", "pp-1f1b-bwd", "pp-zb-bwd"}
    assert "pp-schedule" in ops
    assert {e["args"]["rank"] for e in events} == {0, 1}
    gaps = stage_step_gaps(events)
    assert set(gaps) == {0, 1} and all(gaps.values())
    assert sched.Planner(2).ingest_trace_events(events) == sum(
        len(g) for g in gaps.values())


def test_packed_batch_freezes_planning_and_reverts(ranks):
    reps, _ = ranks
    log = "\n".join(reps[0]["packed-planned"]["log"])
    assert "APPLYING schedule 'zero-bubble'" in log
    assert "planning frozen" in log and "reverting to 1f1b" in log
    np.testing.assert_allclose(reps[0]["packed-planned"]["losses"],
                               reps[0]["packed-static"]["losses"],
                               rtol=0, atol=1e-6)


def test_packed_pipeline_is_one_devices(ranks):
    """Packed batches through the pipeline (each stage's own positions,
    rope tables and segment masks) give one device's losses on the same
    seeded weights and stream."""
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    reps, _ = ranks
    _, tc = cfg_pair(**TINY)
    train = TrainingConfig(train_iters=3, **PLAN_TRAIN)
    one = pretrain_gpt(tc, train, OptimizerConfig(lr=1e-3, lr_decay_iters=3),
                       device="cpu", log_fn=lambda s: None,
                       batch_iter=W.packed_stream(train, tc.vocab_size, 1))
    np.testing.assert_allclose(reps[0]["packed-static"]["losses"],
                               [m["loss"] for m in one.log], rtol=1e-5)
    np.testing.assert_allclose(reps[0]["packed-static"]["grad_norms"],
                               [m["grad_norm"] for m in one.log], rtol=1e-5)


def test_each_rank_hops_as_the_tables_reckon(ranks):
    """pp 2, vpp 1, M 4: a step's forward sends stage 0's 4 outputs and
    its backward sends stage 1's 4 input cotangents (either schedule), so
    each rank sends and receives 4 hops a step of mb · S · H fp32."""
    reps, _ = ranks
    _, tc = cfg_pair(**TINY)
    hop = PLAN_TRAIN["micro_batch_size"] * PLAN_TRAIN["seq_length"] * \
        tc.hidden_size * 4
    for name, steps in (("static", 2), ("planned", 2)):
        for r in (0, 1):
            t = reps[r][name]["traffic"]
            for kind in ("send/pp", "recv/pp"):
                assert t[kind] == {"calls": 4 * steps,
                                   "bytes": 4 * steps * hop}, (name, r)


def test_pipeline_grid_groups():
    """rank = (pp_index · dp + dp_index) · tp + tp_index: each rank's tp,
    dp and stage-ring ranks, its neighbours and its embedding group."""
    par = ParallelConfig(tensor_parallel=2, pipeline_parallel=2,
                         data_parallel=2)
    got = []
    for r in range(8):
        c = MeshContext(group=None, parallel=par, rank=r,
                        device=torch.device("cpu"), backend="gloo")
        got.append((c.pp_rank, c.dp_rank, c.tp_rank, c.tp_ranks, c.dp_ranks,
                    c.pp_ranks, c.next_rank, c.prev_rank, c.embed_ranks))
    assert got[0] == (0, 0, 0, [0, 1], [0, 2], [0, 4], 4, 4, [0, 4])
    assert got[3] == (0, 1, 1, [2, 3], [1, 3], [3, 7], 7, 7, [3, 7])
    assert got[6] == (1, 1, 0, [6, 7], [4, 6], [2, 6], 2, 2, [2, 6])
    assert os.path.basename(__file__).startswith("test_torch_")
