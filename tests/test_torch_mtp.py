"""The port's MTP heads and their proposer against the JAX package, fp32 on
the CPU.

- gpt_loss with MTP depth modules (one and two depths, masked labels):
  the loss and mtp_loss within 1e-5 of JAX's (and the packed-sequence
  refusal); one train step with mtp_num_layers=1 (2 micro-batches): loss,
  mtp_loss, grad norm within 1e-5, the MTP params after the step within
  1e-2 of the lr (tests/test_torch_training.py says why).
- _mtp_draft equals JAX's token for token (init std 0.4 against ties).
- MTP engines (spec_method="mtp", k 4 capped at the depth), unfused and
  fused on bf16 (fp32 here) and int8 pools: token-exact with JAX's MTP
  engine and with the port's plain decode, with JAX's speculation counts,
  on random weights (rejections) and on weights whose MTP head predicts
  what the model does (acceptances).
- serve.py --load-dir serves a checkpoint the port's trainer wrote (its
  params and streams, "loaded checkpoint step N"), its MTP depth read
  from the checkpoint, with --spec-method mtp; --draft-load-dir restores
  the draft; another model's checkpoint and a directory without a step
  are refused.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.inference import dynamic_engine as jde
from megatronapp_tpu.inference import speculative as jspec
from megatronapp_tpu.inference.engine import SamplingParams as JSampling
from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.training import train as jtrain
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.inference import dynamic_engine as tde
from megatronapp_tpu_torch.inference import speculative as tspec
from megatronapp_tpu_torch.inference.engine import SamplingParams
from megatronapp_tpu_torch.models import gpt as tgpt
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.training import optimizer as topt
from megatronapp_tpu_torch.training import train as ttrain
from megatronapp_tpu_torch.training.train_step import (
    TrainState, make_train_step, named_trainable,
)
from test_torch_engine import ENGINE, MAX_NEW, _prompts, _synchronous
from test_torch_layers import LLAMA_SMALL, cfg_pair
from test_torch_training import _batch, _jax_state, _np_tree, jax_named

TOL = 1e-5


def _cfgs(depths=1, **kw):
    return cfg_pair(**dict(LLAMA_SMALL, mtp_num_layers=depths, **kw))


@pytest.mark.parametrize("depths", [1, 2])
def test_mtp_loss_matches_jax(depths):
    jc, tc = _cfgs(depths, mtp_loss_scaling_factor=0.3)
    jp, _ = jgpt.init_gpt_params(jax.random.PRNGKey(depths), jc)
    tp = params_from_jax(_np_tree(jp), tc)
    assert len(tp["mtp"]) == depths
    b = _batch(7, 3, 20, tc.vocab_size)
    jl, jm = jax.jit(functools.partial(jgpt.gpt_loss, cfg=jc))(
        jp, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]),
        jnp.asarray(b["loss_mask"]))
    tl, tm = tgpt.gpt_loss(tp, torch.from_numpy(b["tokens"]),
                           torch.from_numpy(b["labels"]),
                           torch.from_numpy(b["loss_mask"]), tc)
    assert set(tm) == set(jm) == {"lm_loss", "moe_aux_loss", "mtp_loss"}
    for k in ("lm_loss", "mtp_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    np.testing.assert_allclose(
        float(tl), float(tm["lm_loss"]) + 0.3 * float(tm["mtp_loss"]),
        rtol=1e-6)
    with pytest.raises(NotImplementedError, match="sequence packing"):
        tgpt.gpt_loss(tp, torch.from_numpy(b["tokens"]),
                      torch.from_numpy(b["labels"]), None, tc,
                      segment_ids=torch.zeros_like(
                          torch.from_numpy(b["tokens"])))


def test_mtp_params_init_and_convert():
    _, tc = _cfgs(2)
    p = tgpt.init_gpt_params(tc, torch.Generator().manual_seed(0), "cpu")
    names = {n for n, _ in p.named_parameters() if n.startswith("mtp.")}
    assert {"mtp.0.hnorm_scale", "mtp.1.enorm_scale", "mtp.0.proj",
            "mtp.1.layer.attention.q_kernel",
            "mtp.0.layer.mlp.fc2_kernel"} <= names
    assert p["mtp"][0]["proj"].shape == (2 * tc.hidden_size, tc.hidden_size)
    jc, tc = _cfgs(1)
    jp, _ = jgpt.init_gpt_params(jax.random.PRNGKey(0), jc)
    tree = _np_tree(jp)
    tree["mtp"][0]["layer"]["bogus"] = np.zeros(3)
    with pytest.raises(KeyError, match="mtp.0.layer.bogus"):
        params_from_jax(tree, tc)


def test_mtp_train_step_matches_jax():
    opt = dict(lr=1e-2, lr_decay_iters=10, weight_decay=0.1, clip_grad=0.5)
    jc, tc = _cfgs(1, init_method_std=0.05)
    from megatronapp_tpu.config.training_config import OptimizerConfig as JO
    ctx, state, step = _jax_state(jc, JO(**opt), 10, 11)
    b = _batch(12, 4, 16, tc.vocab_size)
    micro = jtrain.reshape_global_batch(b, 2)
    tp = params_from_jax(_np_tree(state["params"]), tc).requires_grad_()
    optimizer = topt.Optimizer(OptimizerConfig(**opt), 10)
    t_state = TrainState(tp, optimizer.init(named_trainable(tp)))
    t_step = make_train_step(ttrain.gpt_microbatch_loss(tc), optimizer)
    with ctx.mesh:
        new_state, jm = step(state, micro)
    tm = t_step(t_state, {k: torch.from_numpy(v) for k, v in micro.items()})
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    for k in ("loss", "grad_norm", "lm_loss", "mtp_loss"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=TOL, err_msg=k)
    j_params = _np_tree(new_state["params"])["mtp"][0]
    t_mtp = tp["mtp"][0]
    for n in ("proj", "hnorm_scale"):
        np.testing.assert_allclose(t_mtp[n].detach().numpy(), j_params[n],
                                   atol=1e-2 * opt["lr"], err_msg=n)
    want = jax_named(j_params["layer"])
    for n, p in t_mtp["layer"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n],
                                   atol=1e-2 * opt["lr"], err_msg=n)


def test_mtp_draft_matches_jax():
    jc, tc = _cfgs(2)        # init std 0.4: no argmax ties
    jp, _ = jgpt.init_gpt_params(jax.random.PRNGKey(5), jc)
    tp = params_from_jax(_np_tree(jp), tc)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(6, tc.hidden_size)).astype(np.float32)
    toks = rng.integers(0, tc.vocab_size, 6).astype(np.int32)
    pos = rng.integers(0, 40, 6).astype(np.int32)
    for k in (1, 2):
        want = np.asarray(jspec._mtp_draft(jp, jnp.asarray(h),
                                           jnp.asarray(toks),
                                           jnp.asarray(pos), jc, k))
        got = tspec._mtp_draft(tp, torch.from_numpy(h),
                               torch.from_numpy(toks).long(),
                               torch.from_numpy(pos).long(), tc, k)
        np.testing.assert_array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _model(weights):
    """(jax cfg, port cfg, JAX params, port params) with one MTP depth.
    "random": every leaf perturbed (the drafts are rejected); "echo": the
    layers' residual outputs zeroed, so the model predicts from the
    current token alone, and the depth's projection passes the token's
    normed embedding through a zeroed layer: the MTP head predicts what
    the model does (the drafts are accepted)."""
    jc, tc = _cfgs(1)
    params, _ = jgpt.init_gpt_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    npp = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.normal(
        size=a.shape)).astype(np.float32), params)
    if weights == "echo":
        h = tc.hidden_size
        for layer in (npp["block"], npp["mtp"][0]["layer"]):
            layer["attention"]["out_kernel"][...] = 0.0
            layer["mlp"]["fc2_kernel"][...] = 0.0
        npp["mtp"][0]["proj"] = np.concatenate(
            [np.zeros((h, h)), np.eye(h)]).astype(np.float32)
        npp["mtp"][0]["enorm_scale"] = np.ones(h, np.float32)
    return (jc, tc, jax.tree.map(jnp.asarray, npp),
            params_from_jax(npp, tc, "cpu"))


def _run_jax(jc, jp, kind, fused):
    eng = jde.DynamicInferenceEngine(jp, jc, paged=True, kv_cache_dtype=kind,
                                     fused_decode=fused, spec_method="mtp",
                                     spec_k=4, **ENGINE)
    assert eng.megakernel is fused and eng.spec_method == "mtp"
    eng._decode = _synchronous(eng._decode)
    eng._mq_step = _synchronous(eng._mq_step)
    ids = [eng.add_request(p, MAX_NEW, JSampling(greedy=True))
           for p in _prompts()]
    res = eng.run_to_completion()
    return [res[r].tolist() for r in ids], dict(eng.spec_stats)


def _run_port(tc, tp, kind, fused, method):
    eng = tde.DynamicInferenceEngine(tp, tc, device="cpu",
                                     kv_cache_dtype=kind, fused_decode=fused,
                                     spec_method=method, spec_k=4, **ENGINE)
    assert eng.megakernel is fused and eng.spec_method == method
    ids = [eng.add_request(p, MAX_NEW, SamplingParams(greedy=True))
           for p in _prompts()]
    while eng.has_work:
        eng.step()
        eng.pool.audit()
    assert eng.pool.blocks_in_use() == 0
    assert not eng._h_valid.any()
    return [eng.requests[r].tokens.tolist() for r in ids], \
        dict(eng.spec_stats)


CASES = [(w, kind, step) for w in ("random", "echo")
         for kind in ("bf16", "int8") for step in ("unfused", "fused")]


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_mtp_engine_token_exact_with_jax_and_plain(case):
    weights, kind, step = case
    jc, tc, jp, tp = _model(weights)
    fused = step == "fused"
    j_streams, j_spec = _run_jax(jc, jp, kind, fused)
    t_streams, t_spec = _run_port(tc, tp, kind, fused, "mtp")
    plain, _ = _run_port(tc, tp, kind, fused, None)
    assert t_streams == j_streams
    assert t_streams == plain
    assert t_spec == j_spec
    assert t_spec["proposed"] > 0
    if weights == "echo":
        assert t_spec["accepted"] >= 0.9 * t_spec["proposed"]
    else:
        assert t_spec["accepted"] < t_spec["proposed"]


# ---------------------------------------------------------------------------
# serving a checkpoint the port's trainer wrote
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_preset(monkeypatch):
    from megatronapp_tpu_torch.models import presets
    _, tc = _cfgs(1)

    def tiny(**kw):
        return dataclasses.replace(tc, **{"mtp_num_layers": None,
                                          "compute_dtype": torch.float32,
                                          **kw})
    monkeypatch.setitem(presets.PRESETS, "tiny-test", tiny)
    return tiny


def _train(cfg, save_dir, iters=2):
    train = TrainingConfig(micro_batch_size=2, global_batch_size=2,
                           seq_length=16, train_iters=iters, log_interval=1,
                           save_dir=save_dir, save_interval=iters)
    return ttrain.pretrain_gpt(cfg, train, OptimizerConfig(lr=1e-2),
                               device="cpu", log_fn=lambda s: None)


def test_serve_load_dir_serves_the_trainers_checkpoint(tiny_preset,
                                                       tmp_path, capsys):
    from megatronapp_tpu_torch import serve
    cfg = tiny_preset(mtp_num_layers=1)
    res = _train(cfg, str(tmp_path / "mtp"))
    argv = ["--preset", "tiny-test", "--engine", "dynamic",
            "--paged-kv-cache", "--device", "cpu", "--params-dtype", "fp32",
            "--max-seq-len", "64", "--max-batch", "3"]
    eng = serve.build_engine(serve.parse_args(
        argv + ["--load-dir", str(tmp_path / "mtp"), "--spec-method",
                "mtp"]))
    assert "loaded checkpoint step 2" in capsys.readouterr().out
    assert eng.spec_method == "mtp"
    trained = dict(res.state.params.named_parameters())
    for n, p in eng.params.named_parameters():
        assert torch.equal(p, trained[n].detach()), n
    ref = tde.DynamicInferenceEngine(res.state.params.requires_grad_(False),
                                     cfg, device="cpu", max_seq_len=64,
                                     max_batch=3)
    streams = []
    for e in (eng, ref):
        ids = [e.add_request(p, 6, SamplingParams(greedy=True))
               for p in _prompts()[:3]]
        out = e.run_to_completion()
        streams.append([out[r].tolist() for r in ids])
    assert streams[0] == streams[1]
    # The draft model's params from their own checkpoint.
    _train(tiny_preset(), str(tmp_path / "draft"), iters=1)
    eng = serve.build_engine(serve.parse_args(
        argv + ["--spec-method", "draft", "--draft-model", "tiny-test",
                "--draft-load-dir", str(tmp_path / "draft")]))
    assert "loaded draft checkpoint step 1" in capsys.readouterr().out
    serve.build_engine(serve.parse_args(
        argv + ["--spec-method", "draft", "--draft-model", "tiny-test"]))
    assert "draft model is randomly initialized" in capsys.readouterr().out
    # A checkpoint of another model is refused, naming the leaves; so are
    # a directory without a step and a depth count beside the checkpoint.
    with pytest.raises(ValueError, match="different state structure"):
        serve.build_engine(serve.parse_args(
            argv + ["--load-dir", str(tmp_path / "mtp"), "--num-layers",
                    "1"]))
    with pytest.raises(SystemExit, match="no checkpoint step to load"):
        serve.build_engine(serve.parse_args(
            argv + ["--load-dir", str(tmp_path / "mistyped")]))
    assert not (tmp_path / "mistyped").exists()
    with pytest.raises(SystemExit):
        serve.parse_args(argv + ["--load-dir", str(tmp_path / "mtp"),
                                 "--mtp-num-layers", "1"])
    assert "read from the checkpoint" in capsys.readouterr().err
