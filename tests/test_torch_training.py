"""The port's training path against the JAX package, fp32 on the CPU.

- Data: mock batches byte-identical for the same seed and start index.
- gpt_forward logits and gpt_loss for a llama-style config (GQA, swiglu,
  rmsnorm, rope, untied) and a gpt2-style one (learned positions,
  layernorm, biases, tied), with and without packed segments: atol/rtol
  1e-4 (matmul summation orders over widths 64-128, logits of order 10).
- One train step with 2 microbatches against make_train_step: loss, grad
  norm and lr within 1e-5 relative; the Adam moments after the step
  within 1e-5 absolute (exact functions of the grads, which agree to
  ~1e-9); the params within 1e-2 of the lr: Adam's first update is
  g / (|g| + eps), which turns the grads' summation-order difference into
  a visible one where |g| is near eps = 1e-8 (seen: one element in 4096
  off by 0.6 % of the lr). Cases: Adam, a warmup step (a zero first
  update), a NaN-skip step and SGD.
- The gpt_tiny_dense golden loss curve (tests/functional) through the
  port's pretrain_gpt from the JAX init, at that test's rtol 2e-3 /
  atol 2e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.config.parallel_config import ParallelConfig
from megatronapp_tpu.config.training_config import (
    OptimizerConfig as JOpt, TrainingConfig as JTrain,
)
from megatronapp_tpu.config.transformer_config import (
    TransformerConfig as JConfig,
)
from megatronapp_tpu.data.mock import mock_batches as j_mock
from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.parallel.mesh import build_mesh
from megatronapp_tpu.training import train as jtrain
from megatronapp_tpu.training.optimizer import get_optimizer, lr_schedule
from megatronapp_tpu.training.train_state import setup_train_state
from megatronapp_tpu.training.train_step import make_train_step as j_step
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)
from megatronapp_tpu_torch.data.mock import mock_batches as t_mock
from megatronapp_tpu_torch.models import gpt as tgpt
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.training import optimizer as topt
from megatronapp_tpu_torch.training import train as ttrain
from megatronapp_tpu_torch.training.train_step import (
    TrainState, make_train_step, named_trainable,
)
from test_torch_layers import GPT2_SMALL, LLAMA_SMALL, cfg_pair

FWD_TOL = 1e-4
STEP_TOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "functional",
                      "golden_values.json")
GOLDEN_MODEL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                    vocab_size=128, max_position_embeddings=64)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def jax_named(tree, prefix=""):
    """The JAX param (or moment) tree as {port parameter name: array}:
    block leaves [L, ...] become layers.i.<path>."""
    out = {}
    for k, v in tree.items():
        if k == "block":
            for name, arr in jax_named(v).items():
                for i in range(arr.shape[0]):
                    out[f"layers.{i}.{name}"] = arr[i]
        elif isinstance(v, dict):
            out.update(jax_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(seed, n, s, vocab, segments=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, s + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "loss_mask": (rng.random((n, s)) > 0.2).astype(np.float32)}
    if segments:
        b["segment_ids"] = np.sort(rng.integers(0, 3, (n, s)),
                                   axis=1).astype(np.int32)
    return b


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,start", [(1234, 0), (7, 13)])
def test_mock_batches_are_the_jax_batches(seed, start):
    jit, tit = (f(32, 128, 4, seed=seed, start_idx=start)
                for f in (j_mock, t_mock))
    for _ in range(3):
        a, b = next(jit), next(tit)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,segments", [
    ("llama", False), ("llama", True), ("gpt2", False), ("gpt2", True)])
def test_forward_and_loss_match_jax(arch, segments):
    jc, tc = cfg_pair(**(LLAMA_SMALL if arch == "llama" else GPT2_SMALL))
    jp, _ = jgpt.init_gpt_params(jax.random.PRNGKey(3), jc)
    tp = params_from_jax(_np_tree(jp), tc)
    b = _batch(4, 2, 24, tc.vocab_size, segments)
    jseg = jnp.asarray(b["segment_ids"]) if segments else None
    tseg = torch.from_numpy(b["segment_ids"]) if segments else None
    j_logits, _ = jgpt.gpt_forward(jp, jnp.asarray(b["tokens"]), jc,
                                   segment_ids=jseg)
    t_logits, aux = tgpt.gpt_forward(tp, torch.from_numpy(b["tokens"]), tc,
                                     segment_ids=tseg)
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), atol=FWD_TOL,
                               rtol=FWD_TOL)
    assert float(aux) == 0.0
    j_loss, j_m = jgpt.gpt_loss(jp, jnp.asarray(b["tokens"]),
                                jnp.asarray(b["labels"]),
                                jnp.asarray(b["loss_mask"]), jc,
                                segment_ids=jseg)
    t_loss, t_m = tgpt.gpt_loss(tp, torch.from_numpy(b["tokens"]),
                                torch.from_numpy(b["labels"]),
                                torch.from_numpy(b["loss_mask"]), tc,
                                segment_ids=tseg)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=FWD_TOL)
    np.testing.assert_allclose(float(t_m["lm_loss"]), float(j_m["lm_loss"]),
                               rtol=FWD_TOL)


@pytest.mark.parametrize("z_loss,masked", [(0.0, False), (0.0, True),
                                           (1e-3, True)])
def test_cross_entropy_and_its_gradient_match_jax(z_loss, masked):
    """Loss, per-token loss and d loss / d logits (the one-buffer custom
    backward) against jax.value_and_grad of the JAX function."""
    from megatronapp_tpu.ops.cross_entropy import cross_entropy_loss as jce
    from megatronapp_tpu_torch.ops.cross_entropy import (
        cross_entropy_loss as tce,
    )
    rng = np.random.default_rng(9)
    logits = (3 * rng.normal(size=(2, 7, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = ((rng.random((2, 7)) > 0.3).astype(np.float32) if masked
            else None)

    def jloss(x):
        return jce(x, jnp.asarray(targets),
                   None if mask is None else jnp.asarray(mask), z_loss)

    (j_loss, j_tok), j_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    t_loss, t_tok = tce(x, torch.from_numpy(targets),
                        None if mask is None else torch.from_numpy(mask),
                        z_loss)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(t_tok.detach().numpy(), np.asarray(j_tok),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad),
                               atol=1e-7)


def test_packed_position_ids_match_jax():
    seg = np.array([[0, 0, 1, 1, 1, 2], [5, 5, 5, 5, 0, 0]], np.int32)
    want = np.asarray(jgpt.packed_position_ids(jnp.asarray(seg)))
    got = tgpt.packed_position_ids(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_full_remat_gives_the_same_gradients():
    """remat_policy "full" recomputes each layer in the backward
    (torch.utils.checkpoint): same loss and grads as saving everything."""
    import dataclasses
    _, tc = cfg_pair(**LLAMA_SMALL)
    b = _batch(5, 2, 16, tc.vocab_size)
    grads = []
    for policy in ("full", "none"):
        cfg = dataclasses.replace(tc, remat_policy=policy)
        p = tgpt.init_gpt_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu").requires_grad_()
        loss, _ = tgpt.gpt_loss(p, *(torch.from_numpy(b[k]) for k in
                                     ("tokens", "labels", "loss_mask")), cfg)
        loss.backward()
        grads.append([loss.detach()] + [x.grad for x in p.parameters()])
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


def _jax_state(jc, jopt, iters, seed):
    ctx = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    optimizer = get_optimizer(jopt, iters, distributed=True)
    state, sh, _ = setup_train_state(
        jax.random.PRNGKey(seed), lambda r: jgpt.init_gpt_params(r, jc),
        optimizer, ctx)
    step = j_step(jtrain.gpt_microbatch_loss(jc, ctx), optimizer, jopt, ctx,
                  sh, iters, donate=False)
    return ctx, state, step


@pytest.mark.parametrize("case", ["adam", "warmup", "nan-skip", "sgd"])
def test_train_step_matches_jax(case):
    """One step, 2 microbatches of 2: loss, grad norm, lr, skipped, params
    and the optimizer moments after the step."""
    opt = dict(lr=1e-2, lr_decay_iters=10, weight_decay=0.1, clip_grad=0.5)
    if case == "warmup":
        opt["lr_warmup_iters"] = 2
    if case == "sgd":
        opt["optimizer"] = "sgd"
    jc, tc = cfg_pair(**dict(LLAMA_SMALL, init_method_std=0.05))
    ctx, state, step = _jax_state(jc, JOpt(**opt), 10, 11)
    b = _batch(12, 4, 16, tc.vocab_size)
    if case == "nan-skip":
        b["loss_mask"][1, 3] = np.nan
    micro = jtrain.reshape_global_batch(b, 2)
    tp = params_from_jax(_np_tree(state["params"]), tc).requires_grad_()
    optimizer = topt.Optimizer(OptimizerConfig(**opt), 10)
    t_state = TrainState(tp, optimizer.init(named_trainable(tp)))
    t_step = make_train_step(ttrain.gpt_microbatch_loss(tc), optimizer)
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    with ctx.mesh:
        new_state, jm = step(state, micro)
    tm = t_step(t_state, {k: torch.from_numpy(v) for k, v in micro.items()})
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    assert tm["skipped"] == jm["skipped"] == (case == "nan-skip")
    for k in ("loss", "grad_norm", "lr", "lm_loss", "moe_aux_loss"):
        if np.isfinite(jm[k]):
            np.testing.assert_allclose(tm[k], jm[k], rtol=STEP_TOL,
                                       atol=1e-7, err_msg=k)
        else:
            assert not np.isfinite(tm[k]), k
    j_params = jax_named(_np_tree(new_state["params"]))
    t_params = {n: p.detach().numpy() for n, p in tp.named_parameters()}
    assert j_params.keys() == t_params.keys()
    for n in j_params:
        np.testing.assert_allclose(t_params[n], j_params[n],
                                   atol=1e-2 * opt["lr"], err_msg=n)
    if case in ("warmup", "nan-skip"):     # lr_schedule(0) = 0 / skipped
        for n, p in tp.named_parameters():
            torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)
    opt_state = jax.device_get(new_state["opt_state"])
    assert t_state.opt_state["count"] == int(opt_state["count"])
    for moment in ("mu", "nu") if case != "sgd" else ("mu",):
        want = jax_named(_np_tree(opt_state[moment]))
        for n, t in t_state.opt_state[moment].items():
            np.testing.assert_allclose(t.numpy(), want[n], atol=STEP_TOL,
                                       err_msg=f"{moment} {n}")


def test_lr_schedule_matches_jax():
    for style in ("cosine", "linear", "constant"):
        kw = dict(lr=3e-3, min_lr=1e-4, lr_warmup_iters=3, lr_decay_iters=12,
                  lr_decay_style=style)
        j = lr_schedule(JOpt(**kw), 20)
        t = topt.lr_schedule(OptimizerConfig(**kw), 20)
        for step in range(20):
            np.testing.assert_allclose(float(t(step)), float(j(step)),
                                       rtol=1e-6, err_msg=f"{style} {step}")


def test_weight_decay_mask_matches_jax():
    from megatronapp_tpu.training.optimizer import _weight_decay_mask
    jc, tc = cfg_pair(**GPT2_SMALL)
    jp, _ = jgpt.init_gpt_params(jax.random.PRNGKey(0), jc)
    want = jax_named(jax.tree.map(lambda m: np.full(jc.num_layers, m),
                                  _weight_decay_mask(jp)))
    tp = params_from_jax(_np_tree(jp), tc)
    for n, p in tp.named_parameters():
        assert topt.decays(n, p) == bool(np.ravel(want[n])[0]), n


# ---------------------------------------------------------------------------
# pretrain_gpt and the golden curve
# ---------------------------------------------------------------------------


def _golden_init(jc):
    """The JAX pretrain_gpt's initial params: setup_train_state's."""
    _, state, _ = _jax_state(jc, JOpt(), 10, 1234)
    return _np_tree(state["params"])


def test_jax_init_is_the_train_state_init():
    """init_gpt_params(PRNGKey(seed)) called eagerly gives the params
    setup_train_state makes under jit (train.py:336) to within one ulp
    (the jitted init fuses the std scaling differently), so the golden
    run takes setup_train_state's params themselves."""
    jc = JConfig(compute_dtype=jnp.float32, **GOLDEN_MODEL)
    direct, _ = jgpt.init_gpt_params(jax.random.PRNGKey(1234), jc)
    a, b = jax_named(_golden_init(jc)), jax_named(_np_tree(direct))
    assert a.keys() == b.keys()
    for n in a:
        np.testing.assert_array_max_ulp(a[n], b[n], maxulp=1)


def test_golden_gpt_tiny_dense():
    """tests/functional gpt_tiny_dense (2 layers, hidden 64, 10 steps,
    2 microbatches, warmup 2) through the port's pretrain_gpt."""
    with open(GOLDEN) as f:
        golden = json.load(f)["gpt_tiny_dense"]
    jc = JConfig(compute_dtype=jnp.float32, **GOLDEN_MODEL)
    tc = TransformerConfig(compute_dtype=torch.float32, **GOLDEN_MODEL)
    jp = _golden_init(jc)
    train = dict(micro_batch_size=2, global_batch_size=4, seq_length=32,
                 train_iters=10, log_interval=2, seed=1234)
    opt = dict(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=10)
    JTrain(**train), JOpt(**opt)           # the same fields on both sides
    res = ttrain.pretrain_gpt(tc, TrainingConfig(**train),
                              OptimizerConfig(**opt), device="cpu",
                              params=params_from_jax(jp, tc),
                              log_fn=lambda s: None)
    np.testing.assert_allclose(res.losses, golden, rtol=2e-3, atol=2e-4)
    assert res.consumed_samples == 40 and len(res.log) == 5


@pytest.mark.parametrize("field,value,flag", [
    ("heartbeat_dir", "x", "--heartbeat-dir"),
    ("log_straggler", True, "--log-straggler"),
    ("rerun_mode", "validate_results", "--rerun-mode")])
def test_unported_training_fields_raise(field, value, flag):
    with pytest.raises(ValueError, match=flag):
        TrainingConfig(**{field: value})


def test_trace_training_fields_are_ported(tmp_path):
    """trace=True (MegaScan) runs: the traced iteration's file holds the
    iteration window, the train-step scope and the step's phase spans, and
    a granularity outside the JAX parser's choices raises."""
    d = str(tmp_path / "trace")
    train = TrainingConfig(micro_batch_size=2, global_batch_size=4,
                           seq_length=16, train_iters=2, log_interval=1,
                           trace=True, trace_dir=d, trace_interval=2,
                           continuous_trace_iterations=1)
    cfg = TransformerConfig(compute_dtype=torch.float32, **GOLDEN_MODEL)
    ttrain.pretrain_gpt(cfg, train, OptimizerConfig(), device="cpu",
                        log_fn=lambda s: None)
    with open(os.path.join(
            d, "benchmark-data-1-pipeline-1-tensor-1-process-0.json")) as f:
        recs = json.load(f)
    assert {r["iteration"] for r in recs} == {0}
    assert [r["name"] for r in recs if r["ph"] == "B"] == [
        "iteration", "train-step", "forward", "loss", "backward", "forward",
        "loss", "backward", "allreduce", "optimizer"]
    with pytest.raises(ValueError, match="trace_granularity"):
        TrainingConfig(trace_granularity="ops")


def test_unported_optimizer_fields_raise():
    """bf16 params with an fp32 master copy are not ported; bf16 Adam
    moments are (tests/test_torch_parallel_train.py)."""
    with pytest.raises(ValueError, match="--main-params-dtype"):
        OptimizerConfig(main_params_dtype="bf16")
    with pytest.raises(ValueError, match="--exp-avg-dtype"):
        OptimizerConfig(exp_avg_dtype="fp8")
    assert OptimizerConfig(exp_avg_dtype="bf16").exp_avg_dtype == "bf16"


@pytest.mark.parametrize("argv,msg", [
    (["--tensor-model-parallel-size", "0"], "--tensor-model-parallel-size"),
    (["--heartbeat-dir", "/tmp/hb"], "--heartbeat-dir"),
    (["--rerun-mode", "disabled"], "--rerun-mode"),
])
def test_entry_point_refuses_other_flags(argv, msg, capsys):
    from megatronapp_tpu_torch import pretrain_gpt
    with pytest.raises(SystemExit):
        pretrain_gpt.parse_args(argv)
    assert msg in capsys.readouterr().err


def test_entry_point_preset_overrides():
    from megatronapp_tpu_torch import pretrain_gpt
    args = pretrain_gpt.parse_args(["--preset", "llama3-8b", "--num-layers",
                                    "4", "--seq-length", "4096"])
    model, train, _ = pretrain_gpt.configs_from_args(args)
    assert (model.num_layers, model.hidden_size, model.num_query_groups,
            model.ffn_hidden_size, model.vocab_size) == (4, 4096, 8, 14336,
                                                         128256)
    assert model.compute_dtype == torch.bfloat16
    assert model.params_dtype == torch.float32 and train.seq_length == 4096
