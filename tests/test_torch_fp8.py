"""fp8 training in the port (megatronapp_tpu_torch/training/fp8.py and the
fp8 twins of parallel/overlap.py's rings) against the JAX package's, on
the CPU.

- ``fp8_quantize`` (codes, amax, saturation count), ``fp8_scale_from_hist``
  and ``rolled_hist`` equal JAX's bit for bit on seeded numpy inputs,
  saturation included.
- The fp8 ring Functions at dp 2 × tp 2 (one spawn of four gloo ranks,
  tests/torch_parallel_worker.py): outputs and grads within 1e-5 of
  JAX's ``_ag_mm_fp8`` / ``_mm_rs_fp8`` (the two-weight QKV case too),
  their rolled histories and saturation counts exactly JAX's "fp8
  cotangents"; the e4m3 chunks' hops move one byte an element, the
  reduce-scatter's partial sums the output dtype's.
- Six steps of fp8 training at tp 2 and dp 2 × tp 2 from JAX's initial
  params: within 2e-3 of JAX's fp8 pretrain_gpt, within FP8_LOSS_RTOL of
  the port's own unquantized run with the rings, and every history's
  slot 0 filled on every layer.
- A durable checkpoint holds the fp8 state bitwise and a resumed run
  repeats the unbroken one's losses; a skipped step keeps the history;
  the /metrics gauges are JAX's, by name and value; every layout
  fp8_ineligible_reason refuses is refused in JAX's words, in the
  config path and at parse time.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_training import _golden_init

import jax
import jax.numpy as jnp

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.config.training_config import (
    OptimizerConfig as JOpt, TrainingConfig as JTrain,
)
from megatronapp_tpu.config.transformer_config import (
    TransformerConfig as JConfig,
)
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu.parallel import overlap as jov
from megatronapp_tpu.training import fp8 as jfp8
from megatronapp_tpu.training.train import pretrain_gpt as j_pretrain
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)
from megatronapp_tpu_torch.training import fp8 as tfp8

# The JAX package's documented fp8-vs-unquantized tolerance
# (tests/test_fp8.py FP8_LOSS_RTOL).
FP8_LOSS_RTOL = 1e-2
JAX_TOL = 2e-3
MODEL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=64,
             tp_comm_overlap=True, fp8_amax_history_len=4)
STEPS = 6
GRIDS = {"tp2": (2, 2), "dp2tp2": (4, 2)}


def _tcfg(**kw):
    return TransformerConfig(**{**MODEL, "compute_dtype": torch.float32,
                                "fp8": True, **kw})


def _jcfg(**kw):
    return JConfig(**{**MODEL, "compute_dtype": jnp.float32, "fp8": True,
                      **kw})


def _train_cfg(**kw):
    return TrainingConfig(**{**dict(micro_batch_size=2, global_batch_size=4,
                                    seq_length=32, train_iters=STEPS,
                                    log_interval=1), **kw})


# ---- the elementwise pieces, no ranks ------------------------------------

def test_quantize_scale_and_roll_are_jaxs_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 96)) * 60.0).astype(np.float32)
    for scale in (1.0, 3.7, 448.0 / 90.0):
        q, amax, sat = tfp8.fp8_quantize(torch.from_numpy(x),
                                         torch.tensor(scale))
        jq, jamax, jsat = jfp8.fp8_quantize(jnp.asarray(x),
                                            jnp.float32(scale))
        assert np.array_equal(q.view(torch.uint8).numpy(),
                              np.asarray(jq).view(np.uint8))
        assert float(amax) == float(jamax)
        assert float(sat) == float(jsat)
    assert float(jsat) > 0          # saturation exercised
    hist = np.abs(rng.normal(size=(5, 4))).astype(np.float32)
    hist[2] = 0.0                   # an empty history: scale 1
    for margin in (0, 1, 3):
        got = tfp8.fp8_scale_from_hist(torch.from_numpy(hist), margin)
        want = jfp8.fp8_scale_from_hist(jnp.asarray(hist), margin)
        assert np.array_equal(got.numpy(), np.asarray(want))
    amaxes = np.abs(rng.normal(size=5)).astype(np.float32)
    assert np.array_equal(
        tfp8.rolled_hist(torch.from_numpy(hist),
                         torch.from_numpy(amaxes)).numpy(),
        np.asarray(jfp8.rolled_hist(jnp.asarray(hist),
                                    jnp.asarray(amaxes))))


def test_accumulate_and_carry_follow_jax():
    rng = np.random.default_rng(1)
    cfg = _tcfg()
    a, b, old = (jax.tree.map(lambda t: np.abs(rng.normal(
        size=t.shape)).astype(np.float32),
        jax.tree.map(lambda t: t.numpy(), tfp8.init_fp8_state(cfg)))
        for _ in range(3))

    def t(tree):
        return jax.tree.map(torch.from_numpy, tree)

    for port, jax_fn, args in (
            (tfp8.fp8_accumulate, jfp8.fp8_accumulate, (a, b)),
            (tfp8.fp8_carry_sat, jfp8.fp8_carry_sat, (old, a))):
        got = port(*(t(x) for x in args))
        want = jax_fn(*(jax.tree.map(jnp.asarray, x) for x in args))
        for g, w in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(),
                                                     got)),
                        jax.tree.leaves(want)):
            assert np.array_equal(g, np.asarray(w))


def test_metrics_gauges_are_jaxs():
    """export_fp8_metrics on the same state: JAX's gauge names and
    values."""
    from megatronapp_tpu.utils import metrics as jtel
    from megatronapp_tpu_torch.utils import metrics as ttel
    rng = np.random.default_rng(2)
    state = jax.tree.map(lambda t: np.abs(rng.normal(size=t.shape)).astype(
        np.float32), jax.tree.map(lambda t: t.numpy(),
                                  tfp8.init_fp8_state(_tcfg())))
    ttel.disable()
    jtel.disable()
    try:
        ttel.enable()
        jtel.enable()
        tfp8.export_fp8_metrics(jax.tree.map(torch.from_numpy, state),
                                _tcfg(fp8_margin=1))
        jfp8.export_fp8_metrics(jax.tree.map(jnp.asarray, state),
                                _jcfg(fp8_margin=1))
        got, want = ttel.snapshot()["gauges"], jtel.snapshot()["gauges"]
    finally:
        ttel.disable()
        jtel.disable()
    assert got == want
    for name in ("fp8_scale_attention_qkv", "fp8_scale_mlp_fc1",
                 "fp8_amax_attention_out", "fp8_amax_mlp_fc2",
                 "fp8_saturated_mlp_fc1", "fp8_amax_history_len"):
        assert name in got


def _refusal_cases():
    ok = dict()
    return [
        ("tp_comm_overlap off", dict(tp_comm_overlap=False), {}),
        ("tp 1", ok, dict(tensor_parallel=1)),
        ("pp", ok, dict(pipeline_parallel=2)),
        ("cp", ok, dict(context_parallel=2)),
        ("moe", dict(num_moe_experts=4), {}),
        ("mla", dict(multi_latent_attention=True, kv_lora_rank=32,
                     qk_head_dim=16, qk_pos_emb_head_dim=8,
                     v_head_dim=16), {}),
        ("mtp", dict(mtp_num_layers=1), {}),
        ("fbd", ok, dict(pipeline_parallel=2,
                         forward_backward_disaggregating=True)),
        ("dpp", ok, dict(pipeline_parallel=2, use_dpp=True)),
    ]


@pytest.mark.parametrize("what,model,par",
                         _refusal_cases(),
                         ids=[c[0] for c in _refusal_cases()])
def test_ineligible_layouts_are_refused_in_jaxs_words(what, model, par):
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    p = dict(dict(tensor_parallel=2), **par)
    want = jfp8.fp8_ineligible_reason(_jcfg(**model), JPC(**p))
    got = tfp8.fp8_ineligible_reason(_tcfg(**model), ParallelConfig(**p))
    assert want is not None and got == want
    assert tfp8.fp8_ineligible_reason(_tcfg(), ParallelConfig(
        tensor_parallel=2)) is None
    if p == {"tensor_parallel": 1} or model == {"tp_comm_overlap": False}:
        # The trainer refuses before anything else (one device here).
        with pytest.raises(ValueError) as e:
            pretrain_gpt(_tcfg(**model), _train_cfg(), OptimizerConfig(),
                         device="cpu")
        assert str(e.value) == want


def test_parse_time_refusals_are_jaxs():
    import megatronapp_tpu_torch.pretrain_gpt as entry
    from megatronapp_tpu.config.arguments import (
        build_parser, configs_from_args, parse_args,
    )
    base = ["--num-layers", "2", "--hidden-size", "64",
            "--num-attention-heads", "4", "--vocab-size", "128",
            "--max-position-embeddings", "64", "--seq-length", "32"]
    for extra in (["--fp8"], ["--fp8", "--tp-comm-overlap"],
                  ["--fp8", "--tp-comm-overlap",
                   "--tensor-model-parallel-size", "2",
                   "--pipeline-model-parallel-size", "2"],
                  ["--fp8", "--tp-comm-overlap",
                   "--tensor-model-parallel-size", "2",
                   "--fp8-amax-history-len", "0"],
                  ["--tp-comm-overlap", "--tensor-model-parallel-size",
                   "3"]):
        with pytest.raises(ValueError) as want:
            configs_from_args(parse_args(build_parser(), base + extra))
        with pytest.raises(ValueError) as got:
            entry.configs_from_args(entry.parse_args(base + extra))
        assert str(got.value) == str(want.value), extra
    args = entry.parse_args(base + ["--fp8", "--tp-comm-overlap",
                                    "--tensor-model-parallel-size", "2"])
    model, _, _ = entry.configs_from_args(args)
    assert model.fp8 and model.tp_comm_overlap
    assert model.fp8_amax_history_len == 16 and model.fp8_margin == 0


# ---- the rings and training, on ranks ------------------------------------

def _ring_runs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 12, 16)).astype(np.float32)
    ws = [(0.3 * rng.normal(size=(16, 8))).astype(np.float32),
          (0.3 * rng.normal(size=(16, 16))).astype(np.float32)]
    coefs = [rng.normal(size=(4, 12, 8)).astype(np.float32),
             (40 * rng.normal(size=(4, 12, 16))).astype(np.float32)]
    y = (3 * rng.normal(size=(4, 12, 8))).astype(np.float32)
    w = (0.3 * rng.normal(size=(8, 16))).astype(np.float32)
    coef = rng.normal(size=(4, 12, 16)).astype(np.float32)
    hist5 = np.abs(rng.normal(size=(5, 4))).astype(np.float32)
    hist5[0, :] = [0.5, 0.4, 0.2, 0.1]     # x's scale saturates x
    hist3 = np.abs(rng.normal(size=(3, 4))).astype(np.float32)
    return {"ag2": dict(kind="ag2", x=x, ws=ws, coefs=coefs, hist=hist5,
                        margin=1),
            "rs": dict(kind="rs", y=y, w=w, coef=coef, hist=hist3)}


def _jax_fp8(run, mesh):
    """JAX's fp8 custom VJPs on the whole inputs: outputs, the grads and
    the fp8 "cotangent" (rolled history, saturation counts)."""
    margin = run.get("margin", 0)
    n = run["hist"].shape[0]
    f8 = {"hist": jnp.asarray(run["hist"]), "sat": jnp.zeros((n,))}
    with mesh:
        if run["kind"] == "ag2":
            def f(x, ws, st):
                ys = jov._ag_mm_fp8(mesh, margin, x, tuple(ws), st)
                return sum(jnp.sum(y * jnp.asarray(c))
                           for y, c in zip(ys, run["coefs"])), ys
            (_, out), grads = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(run["x"]), [jnp.asarray(w) for w in run["ws"]],
                f8)
        else:
            def f(y, w, st):
                o = jov._mm_rs_fp8(mesh, margin, y, w, st)
                return jnp.sum(o * jnp.asarray(run["coef"])), o
            (_, out), grads = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(run["y"]), jnp.asarray(run["w"]), f8)
    return jax.tree.map(np.asarray, (out, grads))


def _cases():
    jc = _jcfg()
    params = _golden_init(jc)
    cases = [dict(name="rings", kind="fp8_rings", world=4, tp=2,
                  runs=_ring_runs())]
    for grid, (world, tp) in GRIDS.items():
        for fp8 in (True, False):
            cases.append(dict(name=f"train-{grid}-{fp8}", kind="train",
                              world=world, tp=tp, cfg=_tcfg(fp8=fp8),
                              params=params, train=_train_cfg(),
                              opt=OptimizerConfig(lr=1e-3)))
    return cases


def _ckpt_cases(tmp):
    """An 8-step fp8 run that saves and exits at step 4, the 8-step run
    resuming from it, and an unbroken 8-step run (one lr schedule); two
    runs of a stream whose second batch is NaN-masked (1 and 2 steps)."""
    from megatronapp_tpu_torch.data.mock import mock_batches
    save = os.path.join(tmp, "ckpt")
    cases = [
        dict(name="save4", kind="train", world=2, tp=2, cfg=_tcfg(),
             train=_train_cfg(train_iters=8, exit_interval=4,
                              save_dir=save, save_interval=4),
             opt=OptimizerConfig(lr=1e-3)),
        dict(name="resume8", kind="train", world=2, tp=2, cfg=_tcfg(),
             train=_train_cfg(train_iters=8, save_dir=save,
                              save_interval=4),
             opt=OptimizerConfig(lr=1e-3)),
        dict(name="straight8", kind="train", world=2, tp=2, cfg=_tcfg(),
             train=_train_cfg(train_iters=8),
             opt=OptimizerConfig(lr=1e-3))]
    batches = list(b for _, b in zip(range(2), mock_batches(32, 128, 4,
                                                            seed=5)))
    batches[1] = dict(batches[1],
                      loss_mask=np.full_like(batches[1]["loss_mask"],
                                             np.nan))
    for n in (1, 2):
        cases.append(dict(name=f"skip{n}", kind="train", world=2, tp=2,
                          cfg=_tcfg(), train=_train_cfg(train_iters=n),
                          opt=OptimizerConfig(lr=1e-3),
                          batch_iter=iter(list(batches))))
    return cases, save


_JAX = {}


def _jax_runs():
    """JAX's fp8 pretrain_gpt at tp 2 and dp 2 × tp 2 (while the ranks
    run), and its fp8 ring references."""
    for grid, (world, tp) in GRIDS.items():
        ctx = j_build_mesh(JPC(tensor_parallel=tp,
                               data_parallel=world // tp),
                           devices=jax.devices()[:world])
        res = j_pretrain(_jcfg(), ctx.parallel, JTrain(
            micro_batch_size=2, global_batch_size=4, seq_length=32,
            train_iters=STEPS, log_interval=1), JOpt(lr=1e-3), ctx=ctx,
            log_fn=lambda *_: None)
        _JAX[grid] = [float(x) for x in res.losses]
    mesh = j_build_mesh(JPC(tensor_parallel=2, data_parallel=2),
                        devices=jax.devices()[:4]).mesh
    for key, run in _ring_runs().items():
        _JAX[key] = _jax_fp8(run, mesh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fp8")
    ckpt, save = _ckpt_cases(str(tmp))
    started = W.start_ranks(4, str(tmp / "store"), _cases() + ckpt)
    _jax_runs()
    reps = W.collect(started)
    reps[0]["_save_dir"] = save
    return reps


def _whole(reps, key, field, rows, cols, i=None):
    blocks = []
    for d in range(2 if rows else 1):
        pieces = []
        for t in range(2 if cols else 1):
            v = reps[d * 2 + t]["rings"][key][field]
            pieces.append(v[i] if i is not None else v)
        blocks.append(np.concatenate(pieces, axis=-1))
    return np.concatenate(blocks, axis=0)


def close(a, b, err=""):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=err)


def test_fp8_ag_ring_matches_jax(ranks):
    ys, (dx, dws, f8) = _JAX["ag2"]
    for i in range(2):
        close(_whole(ranks, "ag2", "ys", True, True, i), ys[i], "y")
        close(_whole(ranks, "ag2", "dws", False, True, i), dws[i], "dw")
    close(_whole(ranks, "ag2", "dx", True, False), dx, "dx")
    for r in range(4):
        rep = ranks[r]["rings"]["ag2"]
        assert np.array_equal(rep["hist"], f8["hist"])
        assert np.array_equal(rep["sat"], f8["sat"])
    assert f8["sat"][0] > 0 and f8["sat"][3] > 0


def test_fp8_rs_ring_matches_jax(ranks):
    out, (dy, dw, f8) = _JAX["rs"]
    close(_whole(ranks, "rs", "out", True, False), out, "out")
    close(_whole(ranks, "rs", "dy", True, True), dy, "dy")
    close(np.concatenate([ranks[t]["rings"]["rs"]["dw"] for t in (0, 1)]),
          dw, "dw")
    for r in range(4):
        rep = ranks[r]["rings"]["rs"]
        assert np.array_equal(rep["hist"], f8["hist"])
        assert np.array_equal(rep["sat"], f8["sat"])


def test_e4m3_hops_move_a_quarter_of_fp32s_bytes(ranks):
    """The e4m3 all-gather rings (x forward and backward, the cotangents
    of the dgrad ring) move one byte an element; the reduce-scatter's
    partial sums move the output dtype's four."""
    b, sc = 2, 6
    t = ranks[0]["rings"]["ag2"]["traffic"]
    # x forward, x backward (wgrads): 16 codes a row each; the dgrad
    # reduce-scatter's fp32 partial sums: 16 a row.
    assert t["send/tp"] == {"calls": 3, "bytes": b * sc * (16 + 16 + 64)}
    t = ranks[0]["rings"]["rs"]["traffic"]
    # forward partial sums fp32 [b, sc, 16]; backward e4m3 dout chunk.
    assert t["send/tp"] == {"calls": 2, "bytes": b * sc * (64 + 16)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_six_fp8_steps_track_jax_and_the_unquantized_run(ranks, grid):
    world, _ = GRIDS[grid]
    rep = ranks[0][f"train-{grid}-True"]
    np.testing.assert_allclose(rep["losses"], _JAX[grid], rtol=JAX_TOL)
    plain = ranks[0][f"train-{grid}-False"]["losses"]
    for a, b in zip(plain, rep["losses"]):
        assert abs(a - b) / abs(a) <= FP8_LOSS_RTOL
    assert rep["losses"] != plain
    for r in range(1, world):
        assert ranks[r][f"train-{grid}-True"]["losses"] == rep["losses"]
        for k, v in rep["fp8"].items():
            assert np.array_equal(ranks[r][f"train-{grid}-True"]["fp8"][k],
                                  v), k
    for (mod, site), n in tfp8.SITE_TENSORS.items():
        hist = rep["fp8"][f"fp8/block/{mod}/{site}/hist"]
        assert hist.shape == (2, n, 4)
        assert (hist[:, :, 0] > 0).all(), (mod, site)


def test_checkpoint_holds_the_fp8_state_and_resumes_bitwise(ranks):
    from megatronapp_tpu_torch.training.checkpointing import (
        CheckpointManager,
    )
    saved = ranks[0]["save4"]["fp8"]
    mngr = CheckpointManager(ranks[0]["_save_dir"])
    flat = mngr.restore(None, step=4)
    mngr.close()
    for k, v in saved.items():
        assert np.array_equal(np.asarray(flat[k]), v), k
    resumed, straight = ranks[0]["resume8"], ranks[0]["straight8"]
    assert len(resumed["losses"]) == 4
    assert resumed["losses"] == straight["losses"][4:]
    for k, v in straight["fp8"].items():
        assert np.array_equal(resumed["fp8"][k], v), k


def test_a_skipped_step_keeps_the_history(ranks):
    one, two = ranks[0]["skip1"], ranks[0]["skip2"]
    assert not any(np.isnan(one["losses"]))
    assert np.isnan(two["losses"][1])
    assert any(v.any() for v in one["fp8"].values())
    for k, v in one["fp8"].items():
        assert np.array_equal(two["fp8"][k], v), k


def test_fp8_needs_no_change_to_a_config_without_it():
    cfg = _tcfg(fp8=False)
    assert not cfg.fp8
    with pytest.raises(ValueError, match="must be >= 1"):
        dataclasses.replace(_tcfg(), fp8_amax_history_len=0)
