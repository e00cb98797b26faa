"""The port's training loop on an indexed corpus against JAX's pretrain_gpt,
fp32 on the CPU.

From setup_train_state's weights carried across (params_from_jax), on the
same corpus (each side's GPTDataset and gpt_batches over one .bin/.idx):

- per-step losses and the eval losses (every 5 steps, over mock batches
  from seed + 1 on both sides: JAX evaluates there when no eval stream
  is given) within the golden rtol 2e-3, 10 steps straight and 5 + save +
  resume 5 (the port's resumed run against JAX's resumed run);
- in the port, 10 steps straight equal 5 + save + resume 5 bit for bit,
  with a batch-size rampup; also with the side state gone (the rampup
  schedule replayed), from a local checkpoint fresher than the durable
  one, and after the signal's emergency save (SIGTERM mid-run);
- the rampup calculator equals JAX's, sizes and errors; exit_interval
  ends the run; the JSONL sink writes one line a logged step, and the
  TensorBoard sink without its package warns and drops its lines;
- pretrain_gpt.py trains on --data-path with --save and resumes bitwise.
"""

import os
import signal
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.config import arguments as jargs
from megatronapp_tpu.config.parallel_config import ParallelConfig
from megatronapp_tpu.config.training_config import (
    OptimizerConfig as JOpt, TrainingConfig as JTrain,
)
from megatronapp_tpu.config.transformer_config import (
    TransformerConfig as JConfig,
)
from megatronapp_tpu.parallel.mesh import build_mesh
from megatronapp_tpu.training import num_microbatches_calculator as jcalc
from megatronapp_tpu.training import train as jtrain
from megatronapp_tpu_torch import pretrain_gpt as entry
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)
from megatronapp_tpu_torch.data.indexed_dataset import IndexedDatasetWriter
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.training import num_microbatches_calculator as tcalc
from megatronapp_tpu_torch.training import train as ttrain
from test_torch_training import GOLDEN_MODEL, _golden_init

GOLDEN_RTOL = 2e-3
TRAIN = dict(micro_batch_size=2, global_batch_size=4, seq_length=32,
             train_iters=10, log_interval=1, seed=1234, eval_interval=5,
             eval_iters=2)
OPT = dict(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=10)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("corpus") / "text")
    rng = np.random.default_rng(21)
    with IndexedDatasetWriter(prefix, np.uint16) as w:
        for _ in range(80):
            w.add_document(rng.integers(0, 128, rng.integers(10, 70)))
    return prefix


def _port_factory(prefix, train):
    ns = types.SimpleNamespace(data_path=prefix)
    return entry.make_batch_iter_factory(ns, train, None)


def _eval_losses(lines):
    return [float(ln.split("loss ")[1].split()[0]) for ln in lines
            if ln.startswith("eval @")]


@pytest.fixture(scope="module")
def jax_runs(corpus, tmp_path_factory):
    """JAX's pretrain_gpt on the corpus: 10 steps straight, then 5 with a
    save and 5 resumed (its log lines and losses), on one CPU device."""
    jc = JConfig(compute_dtype=jnp.float32, **GOLDEN_MODEL)
    ctx = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
    out = {}
    for name, extra in (("straight", {}),
                        ("first", dict(save_dir=ckpt, save_interval=5,
                                       exit_interval=5)),
                        ("resumed", dict(save_dir=ckpt, save_interval=5))):
        train = JTrain(**TRAIN, **extra)
        factory = jargs.make_batch_iter_factory(
            types.SimpleNamespace(data_path=corpus), train, jc)
        lines = []
        res = jtrain.pretrain_gpt(jc, ParallelConfig(), train, JOpt(**OPT),
                                  ctx=ctx, log_fn=lines.append,
                                  batch_iter_factory=factory)
        out[name] = (list(res.losses), _eval_losses(lines), lines)
    out["init"] = _golden_init(jc)
    return out


def _port_run(jax_runs, corpus, params=None, **extra):
    tc = TransformerConfig(compute_dtype=torch.float32, **GOLDEN_MODEL)
    train = TrainingConfig(**{**TRAIN, **extra})
    lines = []
    res = ttrain.pretrain_gpt(
        tc, train, OptimizerConfig(**OPT), device="cpu",
        params=params_from_jax(jax_runs["init"], tc) if params is None
        else params,
        batch_iter_factory=_port_factory(corpus, train),
        log_fn=lines.append)
    return res, lines


def test_losses_and_eval_losses_match_jax(jax_runs, corpus):
    res, _ = _port_run(jax_runs, corpus)
    j_losses, j_eval, _ = jax_runs["straight"]
    assert len(res.losses) == 10 and res.consumed_samples == 40
    np.testing.assert_allclose(res.losses, j_losses, rtol=GOLDEN_RTOL)
    assert [it for it, _ in res.eval_losses] == [5, 10]
    np.testing.assert_allclose([x for _, x in res.eval_losses], j_eval,
                               rtol=GOLDEN_RTOL)


def test_resumed_run_matches_jax_and_is_bitwise(jax_runs, corpus,
                                                tmp_path):
    d = str(tmp_path)
    first, _ = _port_run(jax_runs, corpus, save_dir=d, save_interval=5,
                         exit_interval=5)
    assert first.consumed_samples == 20 and len(first.losses) == 5
    assert sorted(os.listdir(d)) == ["5", "layout.json",
                                     "side_state_5.json"]
    resumed, lines = _port_run(jax_runs, corpus, save_dir=d,
                               save_interval=5)
    assert "resumed from checkpoint at step 5" in lines
    assert resumed.checkpoint_s["restore"] is not None
    straight, _ = _port_run(jax_runs, corpus)
    assert first.losses + resumed.losses == straight.losses
    j_first, _, _ = jax_runs["first"]
    j_resumed, j_eval, j_lines = jax_runs["resumed"]
    assert "resumed from checkpoint at step 5" in j_lines
    np.testing.assert_allclose(first.losses + resumed.losses,
                               j_first + j_resumed, rtol=GOLDEN_RTOL)
    np.testing.assert_allclose([x for _, x in resumed.eval_losses], j_eval,
                               rtol=GOLDEN_RTOL)
    assert sorted(int(s) for s in os.listdir(d) if s.isdigit()) == [5, 10]


RAMP = dict(global_batch_size=8, rampup_batch_size=(2, 2, 16))


def _ramp_run(jax_runs, corpus, **extra):
    return _port_run(jax_runs, corpus, **{**RAMP, **extra})


@pytest.fixture(scope="module")
def ramp_straight(jax_runs, corpus):
    res, _ = _ramp_run(jax_runs, corpus)
    return res


@pytest.mark.parametrize("case", ["side_state", "replayed", "local",
                                  "fresher_local"])
def test_rampup_resume_is_bitwise(jax_runs, corpus, ramp_straight,
                                  tmp_path, case):
    d, local = str(tmp_path / "ckpt"), str(tmp_path / "local")
    kw = dict(save_dir=d, save_interval=4)
    if case in ("local", "fresher_local"):
        kw.update(non_persistent_save_interval=3,
                  non_persistent_ckpt_dir=local)
    first, _ = _ramp_run(jax_runs, corpus, exit_interval=6, **kw)
    # Steps 1-6 take 2, 2, 2, 4, 4, 6 rows (the rampup over 16 samples).
    assert first.consumed_samples == 20
    if case == "replayed":
        os.unlink(os.path.join(d, "side_state_6.json"))
    if case == "fresher_local":       # the final durable save never landed
        import shutil
        shutil.rmtree(os.path.join(d, "6"))
    resumed, lines = _ramp_run(jax_runs, corpus, **kw)
    if case in ("local", "fresher_local"):
        # A tie goes to the local copy, and so does a fresher one.
        assert "restoring from local checkpoint (step 6)" in lines
    else:
        assert not any("local" in ln for ln in lines)
    assert "resumed from checkpoint at step 6" in lines
    assert first.losses + resumed.losses == ramp_straight.losses
    assert resumed.consumed_samples == ramp_straight.consumed_samples == 52


def test_signal_emergency_save_and_resume(jax_runs, corpus, ramp_straight,
                                          tmp_path):
    d, local = str(tmp_path / "ckpt"), str(tmp_path / "local")
    tc = TransformerConfig(compute_dtype=torch.float32, **GOLDEN_MODEL)
    train = TrainingConfig(**{**TRAIN, **RAMP, "save_dir": d,
                              "save_interval": 4,
                              "exit_signal_handler": True,
                              "non_persistent_ckpt_dir": local})
    inner = _port_factory(corpus, train)

    def factory(consumed):
        def gen():
            for i, b in enumerate(inner(consumed)):
                if i == 2:    # the handler must be in place to catch it
                    assert signal.getsignal(signal.SIGTERM) not in (
                        signal.SIG_DFL, signal.SIG_IGN, None)
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b
        return gen()
    lines = []
    res = ttrain.pretrain_gpt(
        tc, train, OptimizerConfig(**OPT), device="cpu",
        params=params_from_jax(jax_runs["init"], tc),
        batch_iter_factory=factory, log_fn=lines.append)
    assert res.interrupted
    stop = len(res.losses)
    assert any(ln.startswith(f"signal: exit requested — emergency "
                             f"checkpoint at iteration {stop}")
               for ln in lines)
    assert os.path.isdir(os.path.join(d, str(stop)))
    assert os.listdir(local) == ["local_ckpt_p0.npz"]
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    resumed, lines = _ramp_run(jax_runs, corpus, save_dir=d, save_interval=4,
                               non_persistent_ckpt_dir=local)
    assert f"restoring from local checkpoint (step {stop})" in lines
    assert res.losses + resumed.losses == ramp_straight.losses


def test_rampup_calculator_equals_jax():
    for args in ((16, 2, 1, (4, 2, 40)), (12, 4, 1, (4, 4, 24)),
                 (8, 1, 2, None), (30, 3, 1, (6, 6, 7))):
        j = jcalc.build_calculator(*args)
        t = tcalc.build_calculator(*args)
        assert t.stages() == j.stages()
        consumed = 0
        for _ in range(30):
            assert t.get(consumed) == j.get(consumed)
            consumed += t.get(consumed)[0]
    for bad in ((10, 2, 1, (4, 4, 8)), (12, 4, 1, (2, 2, 8))):
        with pytest.raises(ValueError) as te:
            tcalc.build_calculator(*bad)
        with pytest.raises(ValueError) as je:
            jcalc.build_calculator(*bad)
        assert str(te.value) == str(je.value)


def test_exit_interval_and_the_jsonl_sink(jax_runs, corpus, tmp_path,
                                         monkeypatch):
    # The TensorBoard sink without its package: warns and drops.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path = str(tmp_path / "m" / "metrics.jsonl")
    res, lines = _port_run(jax_runs, corpus, exit_interval=3,
                           metrics_jsonl=path, eval_interval=None,
                           tensorboard_dir=str(tmp_path / "tb"))
    assert len(res.losses) == 3 and res.consumed_samples == 12
    assert not res.interrupted
    import json
    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["step"] for r in recs] == [1, 2, 3]
    for r, m in zip(recs, res.log):
        assert r["loss"] == m["loss"] and r["grad_norm"] == m["grad_norm"]
        assert {"lr", "skipped", "lm_loss", "moe_aux_loss", "ts",
                "tokens_per_sec", "step_time_ms",
                "tflops_per_device"} <= set(r)
    assert any(ln.startswith("tensorboard sink disabled: ")
               for ln in lines)


def test_entry_point_trains_on_a_corpus_and_resumes(corpus, tmp_path):
    base = ["--device", "cpu", "--fp32", "--num-layers", "1",
            "--hidden-size", "32", "--num-attention-heads", "2",
            "--vocab-size", "128", "--max-position-embeddings", "32",
            "--seq-length", "16", "--micro-batch-size", "2",
            "--global-batch-size", "4", "--train-iters", "4",
            "--log-interval", "1", "--data-path", corpus,
            "--save", str(tmp_path), "--save-interval", "2"]
    first = entry.main(base + ["--exit-interval", "2"])
    again = entry.main(base)
    straight = entry.main(base[:-4])
    assert first.losses + again.losses == straight.losses
    assert os.path.exists(tmp_path / "resolved_args.json")
    with pytest.raises(ValueError, match="needs a directory"):
        entry.configs_from_args(entry.parse_args(
            ["--non-persistent-save-interval", "2"]))
