"""The port's TP overlap rings (megatronapp_tpu_torch/parallel/overlap.py)
against the JAX package's, fp32 on the CPU.

One spawn of four gloo ranks (tests/torch_parallel_worker.py, no jax)
runs every case; JAX runs its primitives on 2 or 4 of the 8 virtual CPU
devices. The mirror of tests/test_tp_overlap.py:50-318:

- all_gather_matmul (one weight, and the two-weight QKV case) and
  matmul_reduce_scatter: values, input grads and weight grads within
  1e-5 of JAX's at tp 2, tp 4 and dp 2 × tp 2 (the wgrads summed over
  dp); S = 13 on tp 4 (zero-padded); JAX's bulk forward forms, built in
  the worker as the reference, equal the ring forms; a weight dim tp
  does not divide raises JAX's words;
- the hops by count and bytes (JAX's ring: tp − 1 hops a ring);
- the MLP (gelu and swiglu) and GQA attention with the rings against
  the plain column/row tp layers, forward and grads;
- tp_overlap_eligible's fallbacks against JAX's predicates;
- the 'tp-overlap-*' spans (steps, tids = tp rank + 1, the hops' bytes),
  and none when tracing is off;
- training: the golden gpt_tiny_tp2 curve with tp_comm_overlap; ten
  steps at pp 2 × tp 2 with the rings within 1e-5 of the same run
  without them; at dp 2 × tp 2 the three dist_opt_comm modes (gspmd,
  ring, bulk) give bitwise-equal losses, with and without fp8, and the
  ring's param return moves dp − 1 hops of the ZeRO-1 chunk a step.
"""

import json

import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_training import GOLDEN, GOLDEN_MODEL, _golden_init

import jax
import jax.numpy as jnp

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.config.transformer_config import (
    TransformerConfig as JConfig,
)
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu.parallel.overlap import (
    all_gather_matmul as j_agmm, matmul_reduce_scatter as j_mmrs,
    tp_overlap_eligible as j_eligible,
)
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)
from megatronapp_tpu_torch.parallel.mesh import MeshContext
from megatronapp_tpu_torch.parallel.overlap import (
    OVERLAP_COMPUTE_EVENT, OVERLAP_PERMUTE_EVENT, tp_columns, tp_rows,
    tp_overlap_eligible, tp_overlap_ineligible_reason,
)

TOL = 1e-5
# name: (world, tp)
GRIDS = {"tp2": (2, 2), "tp4": (4, 4), "dp2tp2": (4, 2)}


def close(a, b, err=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL, err_msg=err)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _runs():
    rng = np.random.default_rng(0)
    x = _rand(rng, 4, 12, 16)
    ws = [_rand(rng, 16, 8), _rand(rng, 16, 16)]
    coefs = [_rand(rng, 4, 12, 8), _rand(rng, 4, 12, 16)]
    y, w, coef = _rand(rng, 4, 12, 8), _rand(rng, 8, 16), \
        _rand(rng, 4, 12, 16)
    x13 = _rand(rng, 4, 13, 16)
    wa, wb = _rand(rng, 16, 8, scale=0.1), _rand(rng, 8, 16, scale=0.1)
    runs = {
        "ag": dict(kind="ag", x=x, ws=ws[:1], coefs=coefs[:1]),
        "ag2": dict(kind="ag2", x=x, ws=ws, coefs=coefs),
        "rs": dict(kind="rs", y=y, w=w, coef=coef),
        "chain13": dict(kind="chain", x=x13, w=wa, w2=wb),
    }
    for k in ("ag2", "rs", "chain13"):
        runs[f"bulk-{k}"] = dict(runs[k], overlap=False)
    return runs


def _tiny(**kw):
    return TransformerConfig(**{**GOLDEN_MODEL, "compute_dtype":
                                torch.float32, **kw})


def _train_cases():
    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    jc = JConfig(compute_dtype=jnp.float32, **GOLDEN_MODEL)
    cases = [dict(
        name="golden", kind="train", world=2, tp=2,
        cfg=_tiny(tp_comm_overlap=True), params=_golden_init(jc),
        train=TrainingConfig(micro_batch_size=2, global_batch_size=4,
                             seq_length=32, train_iters=10, log_interval=2,
                             seed=1234),
        opt=OptimizerConfig(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=10))]
    tc = TrainingConfig(micro_batch_size=1, global_batch_size=4,
                        seq_length=32, train_iters=10, log_interval=1,
                        seed=1234)
    for on in (False, True):
        cases.append(dict(name=f"pp2tp2-{on}", kind="train", world=4, tp=2,
                          par=dict(pipeline_parallel=2),
                          cfg=_tiny(tp_comm_overlap=on), train=tc,
                          opt=OptimizerConfig(lr=1e-3, lr_warmup_iters=2)))
    tc3 = TrainingConfig(micro_batch_size=1, global_batch_size=4,
                         seq_length=32, train_iters=3, log_interval=1,
                         seed=1234)
    for fp8 in (False, True):
        for comm in ("gspmd", "ring", "bulk"):
            cases.append(dict(
                name=f"comm-{comm}-{fp8}", kind="trace", world=4, tp=2,
                cfg=_tiny(tp_comm_overlap=True, fp8=fp8,
                          fp8_amax_history_len=4), train=tc3,
                opt=OptimizerConfig(lr=1e-3, dist_opt_comm=comm)))
    return cases


def _cases():
    return _train_cases() + [
        dict(name=f"prims-{g}", kind="overlap", world=world, tp=tp,
             runs=_runs()) for g, (world, tp) in GRIDS.items()] + [
        dict(name="spans", kind="spans", world=4, tp=4,
             run=_runs()["chain13"]),
        dict(name="mlp-gelu", kind="layers_overlap", world=4, tp=2,
             layer="mlp", **_layer_inputs("mlp", "gelu")),
        dict(name="mlp-swiglu", kind="layers_overlap", world=4, tp=2,
             layer="mlp", **_layer_inputs("mlp", "swiglu")),
        dict(name="attn-gqa", kind="layers_overlap", world=4, tp=2,
             layer="attention", **_layer_inputs("attention", "gelu", 2)),
        dict(name="attn-mha", kind="layers_overlap", world=4, tp=2,
             layer="attention", **_layer_inputs("attention", "gelu", 4))]


def _layer_inputs(layer, act, nkv=4):
    from megatronapp_tpu_torch.config.transformer_config import (
        ActivationKind,
    )
    from megatronapp_tpu_torch.transformer.attention import (
        init_attention_params,
    )
    from megatronapp_tpu_torch.transformer.mlp import init_mlp_params
    cfg = TransformerConfig(
        num_layers=2, hidden_size=64, num_attention_heads=4,
        num_query_groups=nkv, vocab_size=128, max_position_embeddings=64,
        compute_dtype=torch.float32, activation=ActivationKind[act],
        ffn_hidden_size=192 if act == "swiglu" else 256,
        attention_impl="reference")
    gen = torch.Generator().manual_seed(1)
    init = init_mlp_params if layer == "mlp" else init_attention_params
    p = init(cfg, gen, "cpu", 0.02)
    x = np.random.default_rng(2).normal(size=(4, 12, 64)).astype(np.float32)
    return {"cfg": cfg, "x": x,
            "params": {n: t.numpy() for n, t in p.named_parameters()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("overlap") / "store"
    return W.spawn_ranks(4, str(store), _cases())


def _mesh(grid):
    world, tp = GRIDS[grid]
    return j_build_mesh(JPC(tensor_parallel=tp, data_parallel=world // tp),
                        devices=jax.devices()[:world]).mesh


def _jax_run(run, mesh):
    """JAX's primitive on the whole inputs: (outputs, input grads, weight
    grads) as numpy."""
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else
             [jnp.asarray(u) for u in v]) for k, v in run.items()
         if k not in ("kind", "overlap")}
    with mesh:
        if run["kind"] in ("ag", "ag2"):
            def f(x, ws):
                ys = j_agmm(x, tuple(ws), mesh)
                return sum(jnp.sum(y * c)
                           for y, c in zip(ys, j["coefs"])), ys
            (_, ys), (dx, dws) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(j["x"], j["ws"])
            return ([np.asarray(y) for y in ys], np.asarray(dx),
                    [np.asarray(d) for d in dws])
        if run["kind"] == "rs":
            def f(y, w):
                out = j_mmrs(y, w, mesh)
                return jnp.sum(out * j["coef"]), out
            (_, out), (dy, dw) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(j["y"], j["w"])
            return np.asarray(out), np.asarray(dy), np.asarray(dw)

        def f(x, w, w2):
            out = j_mmrs(j_agmm(x, w, mesh), w2, mesh)
            return jnp.sum(out ** 2), out
        (_, out), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(j["x"], j["w"], j["w2"])
        return np.asarray(out), [np.asarray(g) for g in grads]


def _assemble(reps, grid, key, field, rows: bool, cols: bool, i=None):
    """A whole array from every rank's piece: dp rows along dim 0 when
    `rows`, tp columns along the last dim when `cols`."""
    world, tp = GRIDS[grid]
    dp = world // tp
    blocks = []
    for d in range(dp if rows else 1):
        pieces = []
        for t in range(tp if cols else 1):
            v = reps[d * tp + t][f"prims-{grid}"][key][field]
            pieces.append(v[i] if i is not None else v)
        blocks.append(np.concatenate(pieces, axis=-1))
    return np.concatenate(blocks, axis=0)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("key", ["ag", "ag2"])
def test_all_gather_matmul_matches_jax(ranks, grid, key):
    run = _runs()[key]
    ys, dx, dws = _jax_run(run, _mesh(grid))
    for i, y in enumerate(ys):
        close(_assemble(ranks, grid, key, "ys", True, True, i), y, "y")
        # The wgrads are summed over dp (the worker sums them, as the
        # trainer's flat-buffer reduction does).
        close(_assemble(ranks, grid, key, "dws", False, True, i), dws[i],
              "dw")
    close(_assemble(ranks, grid, key, "dx", True, False), dx, "dx")


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_matmul_reduce_scatter_matches_jax(ranks, grid):
    out, dy, dw = _jax_run(_runs()["rs"], _mesh(grid))
    close(_assemble(ranks, grid, "rs", "out", True, False), out)
    close(_assemble(ranks, grid, "rs", "dy", True, True), dy)
    world, tp = GRIDS[grid]
    got = np.concatenate([ranks[t]["prims-" + grid]["rs"]["dw"]
                          for t in range(tp)], axis=0)
    close(got, dw)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_padded_sequence_chain_matches_jax(ranks, grid):
    """S = 13: zero-padded to a multiple of tp outside the Functions; the
    chain's value and all three grads."""
    out, (dx, dw, dw2) = _jax_run(_runs()["chain13"], _mesh(grid))
    assert _assemble(ranks, grid, "chain13", "out", True, False).shape \
        == out.shape == (4, 13, 16)
    close(_assemble(ranks, grid, "chain13", "out", True, False), out)
    close(_assemble(ranks, grid, "chain13", "dx", True, False), dx)
    close(_assemble(ranks, grid, "chain13", "dw", False, True), dw)
    world, tp = GRIDS[grid]
    got = np.concatenate([ranks[t]["prims-" + grid]["chain13"]["dw2"]
                          for t in range(tp)], axis=0)
    close(got, dw2)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("key", ["ag2", "rs", "chain13"])
def test_bulk_forms_equal_ring_forms(ranks, grid, key):
    world, _ = GRIDS[grid]
    for r in range(world):
        ring = ranks[r][f"prims-{grid}"][key]
        bulk = ranks[r][f"prims-{grid}"][f"bulk-{key}"]
        for field, v in ring.items():
            if field == "traffic":
                continue
            for a, b in (zip(v, bulk[field]) if isinstance(v, list)
                         else [(v, bulk[field])]):
                close(b, a, f"{key} {field}")


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_ring_hops_by_count_and_bytes(ranks, grid):
    """JAX's rings: tp − 1 hops a ring, each a chunk [b, S/tp, .] fp32.
    ag2's forward rings x once for both weights, its backward once for
    the wgrads and once for the dgrad's reduce-scatter."""
    world, tp = GRIDS[grid]
    b = 4 // (world // tp)
    sc = 12 // tp
    for r in range(world):
        t = ranks[r][f"prims-{grid}"]["ag2"]["traffic"]
        hops = 3 * (tp - 1)
        want = (tp - 1) * b * sc * 4 * (16 + 16 + 16)
        assert t["send/tp"] == {"calls": hops, "bytes": want}
        assert t["recv/tp"] == t["send/tp"]
        t = ranks[r][f"prims-{grid}"]["rs"]["traffic"]
        want = (tp - 1) * b * sc * 4 * (16 + 16)
        assert t["send/tp"] == {"calls": 2 * (tp - 1), "bytes": want}
        # The seq gather after the ring, and its backward's dgrad gather.
        assert t["all_gather/tp"]["calls"] == 1


def test_indivisible_weight_dim_raises():
    ctx = _fake(4, 0)
    with pytest.raises(ValueError, match="not divisible"):
        tp_columns(torch.ones(16, 6), ctx)
    with pytest.raises(ValueError, match="divide"):
        tp_rows(torch.ones(6, 16), ctx)


@pytest.mark.parametrize("name", ["mlp-gelu", "mlp-swiglu", "attn-gqa",
                                  "attn-mha"])
def test_layers_with_rings_match_the_tp_layers(ranks, name):
    """dp 2 × tp 2: the MLP (gelu; swiglu's [gate | value] shards) and
    attention (GQA and MHA) with tp_comm_overlap against the column/row
    tp layers, output and every grad within 1e-5."""
    for r in range(4):
        rep = ranks[r][name]
        for k, d in rep["diff"].items():
            assert d <= TOL * max(1.0, rep["scale"][k]), (r, k, d)


def _fake(tp, rank, dp=1, cp=1):
    return MeshContext(group=None, parallel=ParallelConfig(
        tensor_parallel=tp, data_parallel=dp, context_parallel=cp),
        rank=rank, device=torch.device("cpu"), backend="gloo")


def test_eligibility_fallbacks_follow_jax():
    """JAX's TestEligibility cases, each predicate on both sides."""
    j_on = JConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                   vocab_size=128, tp_comm_overlap=True)
    j_off = JConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                    vocab_size=128)
    t_on = TransformerConfig(num_layers=2, hidden_size=64,
                             num_attention_heads=4, vocab_size=128,
                             tp_comm_overlap=True)
    t_off = TransformerConfig(num_layers=2, hidden_size=64,
                              num_attention_heads=4, vocab_size=128)
    devs = jax.devices()
    jm = {("tp", 4): j_build_mesh(JPC(tensor_parallel=4), devices=devs[:4]),
          ("tp", 1): j_build_mesh(JPC(tensor_parallel=1), devices=devs[:1]),
          ("cp", 2): j_build_mesh(JPC(context_parallel=2), devices=devs[:2]),
          ("dp2", 2): j_build_mesh(JPC(tensor_parallel=2, data_parallel=2),
                                   devices=devs[:4])}
    tm = {("tp", 4): _fake(4, 0), ("tp", 1): _fake(1, 0),
          ("cp", 2): _fake(1, 0, cp=2), ("dp2", 2): _fake(2, 0, dp=2)}
    cases = [
        (True, ("tp", 4), (64,), 4), (False, ("tp", 4), (64,), 4),
        (True, None, (64,), None), (True, ("tp", 1), (64,), None),
        (True, ("cp", 2), (64,), None), (True, ("tp", 4), (64, 170), 4),
        (True, ("dp2", 2), (64,), 3),
    ]
    for on, mesh, dims, batch in cases:
        want = j_eligible(j_on if on else j_off,
                          None if mesh is None else jm[mesh], *dims,
                          batch=batch)
        got = tp_overlap_eligible(t_on if on else t_off,
                                  None if mesh is None else tm[mesh],
                                  *dims, batch=batch)
        assert got == want, (on, mesh, dims, batch)
    assert "cp == 2" in tp_overlap_ineligible_reason(t_on,
                                                      _fake(2, 0, cp=2))
    fbd = _fake(2, 0)
    fbd.fbd_role = "forward"
    assert "FBD" in tp_overlap_ineligible_reason(t_on, fbd, 64)


def test_ring_spans_carry_tids_steps_and_bytes(ranks):
    """tp 4: both span kinds, B and E, every ring step, one timeline a tp
    rank (tid = rank + 1), forward and fused backward ops; a permute span
    carries its hop's bytes; nothing recorded once tracing is off."""
    for r in range(4):
        recs = ranks[r]["spans"]["records"]
        compute = [x for x in recs if x["name"] == OVERLAP_COMPUTE_EVENT]
        permute = [x for x in recs if x["name"] == OVERLAP_PERMUTE_EVENT]
        assert compute and permute
        assert {x["args"]["step"] for x in compute} == {0, 1, 2, 3}
        assert {x["ph"] for x in compute} == {"B", "E"}
        assert {x["ph"] for x in permute} == {"B", "E"}
        assert {x["tid"] for x in recs} == {r + 1}
        assert {x["args"]["rank"] for x in recs} == {r}
        ops = {x["args"]["op"] for x in compute}
        assert {"all-gather-matmul", "matmul-reduce-scatter"} <= ops
        assert any(op.endswith("-bwd") for op in ops)
        # x chunks: [4 rows, 13 → 16 / 4 positions, 16] fp32.
        fwd = [x for x in permute if x["args"]["op"] == "all-gather-matmul"]
        assert fwd and all(x["args"]["bytes"] == 4 * 4 * 16 * 4
                           for x in fwd)
        assert ranks[r]["spans"]["after"] == 0


def test_golden_gpt_tiny_tp2_with_the_rings(ranks):
    """tests/functional gpt_tiny_tp2 through pretrain_gpt on 2 ranks with
    tp_comm_overlap, at test_torch_parallel_train's golden tolerance."""
    with open(GOLDEN) as f:
        golden = json.load(f)["gpt_tiny_tp2"]
    for r in (0, 1):
        np.testing.assert_allclose(ranks[r]["golden"]["losses"], golden,
                                   rtol=2e-3, atol=2e-4)


def test_pp2_tp2_rings_match_the_tp_layers(ranks):
    """Ten steps at pp 2 × tp 2: each stage body's layers through the
    rings against the column/row tp layers."""
    off, on = ranks[0]["pp2tp2-False"], ranks[0]["pp2tp2-True"]
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
    np.testing.assert_allclose(on["grad_norms"], off["grad_norms"],
                               rtol=1e-5)
    for r in range(1, 4):
        assert ranks[r]["pp2tp2-True"]["losses"] == on["losses"]


@pytest.mark.parametrize("fp8", [False, True])
def test_dist_opt_comm_modes_are_bitwise_equal(ranks, fp8):
    """gspmd, ring and bulk return the same bits (JAX test_fp8.py:
    454-468); the ring moves dp − 1 = 1 hop of the ZeRO-1 chunk a step,
    counted on dp, where the others all-gather."""
    base = ranks[0][f"comm-gspmd-{fp8}"]
    for comm in ("ring", "bulk"):
        rep = ranks[0][f"comm-{comm}-{fp8}"]
        assert rep["losses"] == base["losses"], comm
        assert rep["grad_norms"] == base["grad_norms"], comm
    ring = ranks[0][f"comm-ring-{fp8}"]["traffic"]
    chunk = base["traffic"]["reduce_scatter/dp"]["bytes"]
    assert ring["send/dp"] == {"calls": 3, "bytes": chunk}
    assert ring["recv/dp"] == ring["send/dp"]
    assert "all_gather/dp" not in ring
    assert base["traffic"]["all_gather/dp"]["calls"] == 3
