"""The port's pipeline-parallel training against the JAX package, fp32 on
the CPU.

One spawn of four gloo ranks (FileStores under the test's tmp dir;
tests/torch_parallel_worker.py imports no jax) runs every case; the JAX
references run in the test process on the 8 virtual CPU devices.
Configs: a llama-style one (GQA, swiglu, RMSNorm, rope, QK-layernorm,
untied) and a gpt2-style one (learned positions, LayerNorm, biases,
gelu, tied), 4 layers.

- One accumulation of 4 microbatches at pp 2 × vpp 2 (1F1B interleaved,
  'dfc') and at pp 2 zero-bubble: the loss within 1e-5 of JAX's
  gpt_pipeline_loss on a pp-2 mesh, every leaf's gradient gathered whole
  within 1e-5 of the max of jax.grad of JAX's gpt_pipeline_loss on a
  pp-1 mesh (its no-pipelining schedule: the same token mean over all
  microbatches; on this jax the grad of its pp > 1 region fails, as its
  own pipeline grad tests do).
- 'bfc' (vpp sequential passes) gives 'dfc''s loss and grads.
- Uneven loss masks across microbatches: JAX's pipelined loss (the
  token mean over all of them), which a mean of microbatch means misses.
- A tied embedding at pp 2: its grads summed over the two stages (JAX's
  replicated embedding), and after 3 steps both copies bitwise equal;
  gather_tree(shard_tree(tree)) is the tree bitwise at pp 2 x vpp 2 x
  tp 2.
- Ten steps at pp 2 × dp 2 (ZeRO-1) and at pp 2 × tp 2 zero-bubble
  within 2e-3 of JAX's non-pipelined make_train_step on a dp-2 / tp-2
  mesh (JAX's test_pipeline_grads_match_dense pins its pipeline to it);
  the pp 2 × dp 2 run's evaluations read one device's eval losses.
- The golden gpt_tiny_pp2_vpp2 curve (tests/functional) through the
  port's pretrain_gpt on 2 ranks, at rtol 2e-3 / atol 2e-4.
- A pp 2 × vpp 2 checkpoint restored at dp 2 and on one device: the
  state they write back is the saved one, bitwise. Another model's
  checkpoint (more layers; an untied head into a tied model) restored at
  pp 2 raises on every rank.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_layers import cfg_pair
from test_torch_parallel_train import _jax_run, _np_tree
from test_torch_training import GOLDEN, _golden_init, jax_named

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu.parallel.pipeline import reshape_params_for_pipeline
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)

LLAMA = dict(num_layers=4, hidden_size=64, num_attention_heads=8,
             num_query_groups=4, ffn_hidden_size=128, vocab_size=128,
             max_position_embeddings=64, normalization="rmsnorm",
             activation="swiglu", position_embedding="rope",
             add_bias_linear=False, qk_layernorm=True,
             untie_embeddings_and_output_weights=True,
             rotary_base=500000.0)
GPT2 = dict(num_layers=4, hidden_size=64, num_attention_heads=4,
            ffn_hidden_size=128, vocab_size=128, max_position_embeddings=64,
            normalization="layernorm", activation="gelu",
            position_embedding="learned_absolute", add_qkv_bias=True)
SEQ, M, MB = 16, 4, 2
GRAD_TOL = 1e-5
STEP_TOL = 2e-3
PP2VPP2 = dict(pipeline_parallel=2, virtual_pipeline_parallel=2)
PP2ZB = dict(pipeline_parallel=2, pp_schedule="zero-bubble")
OPT = dict(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=10, clip_grad=0.5)
EVAL = dict(eval_interval=5, eval_iters=2)
GOLDEN_PP = dict(num_layers=4, hidden_size=64, num_attention_heads=4,
                 vocab_size=128, max_position_embeddings=64)

_REFS = {}


def _refs():
    """Each arch's configs and eager JAX init, once."""
    if not _REFS:
        for arch, kw in (("llama", LLAMA), ("gpt2", GPT2)):
            jc, tc = cfg_pair(**kw)
            _REFS[arch] = (jc, tc, _np_tree(jgpt.init_gpt_params(
                jax.random.PRNGKey(7), jc)[0]))
    return _REFS


def _batch(seed, vocab, uneven=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (M, MB, SEQ + 1)).astype(np.int32)
    mask = (rng.random((M, MB, SEQ)) > 0.2).astype(np.float32)
    if uneven:
        # Microbatch 0 keeps a few tokens, the others nearly all.
        mask[0] = rng.random((MB, SEQ)) > 0.9
        mask[1:] = 1.0
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
            "loss_mask": mask}


def _train_cfg(**kw):
    return TrainingConfig(**{**dict(micro_batch_size=1, global_batch_size=4,
                                    seq_length=SEQ, train_iters=10,
                                    log_interval=1, seed=1234), **kw})


def _cases(tmp):
    refs = _refs()
    cases = []
    for arch, schedules in (("llama", ("pp2vpp2", "pp2zb", "pp2vpp2bfc")),
                            ("gpt2", ("pp2vpp2", "pp2zb"))):
        jc, tc, jp = refs[arch]
        for sched in schedules:
            par = {"pp2vpp2": PP2VPP2, "pp2zb": PP2ZB,
                   "pp2vpp2bfc": dict(PP2VPP2,
                                      pipeline_order_policy="bfc")}[sched]
            cases.append(dict(name=f"grads-{arch}-{sched}", kind="pp_grads",
                              world=2, tp=1, zero1=False, par=par, cfg=tc,
                              params=W.np_tree(jp),
                              batch=_batch(3, tc.vocab_size)))
    _, gtc, gjp = refs["gpt2"]
    cases.append(dict(name="roundtrip", kind="roundtrip", world=4, tp=2,
                      par=PP2VPP2, cfg=gtc, params=W.np_tree(gjp)))
    jc, tc, jp = refs["llama"]
    cases.append(dict(name="uneven", kind="pp_grads", world=2, tp=1,
                      zero1=False, par=PP2VPP2, cfg=tc, params=W.np_tree(jp),
                      batch=_batch(5, tc.vocab_size, uneven=True)))
    init = _init_params()
    cases.append(dict(name="steps-pp2dp2", kind="train", world=4, tp=1,
                      par=dict(pipeline_parallel=2), cfg=tc, params=init,
                      train=_train_cfg(**EVAL), opt=OptimizerConfig(**OPT)))
    cases.append(dict(name="steps-pp2tp2", kind="train", world=4, tp=2,
                      par=PP2ZB, cfg=tc, params=init,
                      train=_train_cfg(), opt=OptimizerConfig(**OPT)))
    _, gtc = cfg_pair(**GPT2)
    cases.append(dict(name="tied", kind="train", world=2, tp=1,
                      par=dict(pipeline_parallel=2), cfg=gtc,
                      train=_train_cfg(train_iters=3),
                      opt=OptimizerConfig(**OPT)))
    tc_golden = TransformerConfig(compute_dtype=torch.float32, **GOLDEN_PP)
    cases.append(dict(
        name="golden", kind="train", world=2, tp=1, par=PP2VPP2,
        cfg=tc_golden, params=_golden_init(jc_golden()),
        train=TrainingConfig(micro_batch_size=2, global_batch_size=8,
                             seq_length=32, train_iters=10, log_interval=2,
                             seed=1234),
        opt=OptimizerConfig(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=10)))
    # A pp 2 x vpp 2 run saves step 3; a dp 2 run restores it and saves
    # it again elsewhere (no step left to take).
    ckpt = dict(kind="train", world=2, tp=1, cfg=tc, opt=OptimizerConfig(
        **OPT))
    cases.append(dict(ckpt, name="ckpt-save", par=PP2VPP2, train=_train_cfg(
        train_iters=3, save_dir=str(tmp / "pp"), save_interval=3)))
    cases.append(dict(ckpt, name="ckpt-dp2", train=_train_cfg(
        train_iters=3, load_dir=str(tmp / "pp"), save_dir=str(tmp / "dp"),
        save_interval=3)))
    # Other models' checkpoints restored at pp 2: one of 8 layers at the
    # run's widths, and the untied pp checkpoint into a tied model.
    _, deep = cfg_pair(**dict(LLAMA, num_layers=8))
    _, tied = cfg_pair(**dict(LLAMA,
                              untie_embeddings_and_output_weights=False))
    pp2 = dict(pipeline_parallel=2)
    cases.append(dict(ckpt, name="ckpt-deep-save", cfg=deep, par=pp2,
                      train=_train_cfg(train_iters=1,
                                       save_dir=str(tmp / "deep"),
                                       save_interval=1)))
    for name, cfg, src in (("more-layers", tc, "deep"),
                           ("untied-into-tied", tied, "pp")):
        cases.append(dict(ckpt, name=f"ckpt-{name}", cfg=cfg, par=pp2,
                          expect_error=True, train=_train_cfg(
                              train_iters=4, load_dir=str(tmp / src))))
    return cases


def jc_golden():
    from megatronapp_tpu.config.transformer_config import (
        TransformerConfig as JConfig,
    )
    return JConfig(compute_dtype=jnp.float32, **GOLDEN_PP)


_INIT = {}


def _init_params():
    """setup_train_state's params of the llama config (the ten-step runs'
    start; the same values on every mesh)."""
    if "llama" not in _INIT:
        from test_torch_parallel_train import _jax_state
        state = _jax_state(_refs()["llama"][0], 1, 1, None)[3]
        _INIT["llama"] = _np_tree(state["params"])
    return _INIT["llama"]


_JAX = {}
_JITTED = {}


def _pipeline_loss(arch, batch, par, pp):
    """JAX's gpt_pipeline_loss of the batch on a pp-`pp` mesh under the
    ParallelConfig fields `par`: its value, and on a pp-1 mesh (the
    no-pipelining schedule) its jax.grad too. One compile a (arch, par,
    pp)."""
    jc, _, jp = _refs()[arch]
    p = {k: v for k, v in par.items() if k != "pipeline_parallel"}
    jpar = JPC(pipeline_parallel=pp, **p)
    ctx = j_build_mesh(jpar, devices=jax.devices()[:pp])
    vpp = jpar.virtual_pipeline_parallel if pp > 1 else 1
    key = (arch, tuple(sorted(par.items())), pp)
    if key not in _JITTED:
        def loss(q, t, lab, m):
            return jgpt.gpt_pipeline_loss(
                q, t, lab, m, jc, ctx, vpp=vpp, schedule=jpar.pp_schedule,
                order_policy=jpar.pipeline_order_policy)[0]
        _JITTED[key] = jax.jit(loss if pp > 1 else
                               jax.value_and_grad(loss))
    jp = dict(jp, block=reshape_params_for_pipeline(jp["block"], pp, vpp))
    args = [jnp.asarray(batch[k])
            for k in ("tokens", "labels", "loss_mask")]
    with ctx.mesh:
        out = _JITTED[key](jp, *args)
    if pp > 1:
        return float(out), None
    val, grad = out
    grad = _np_tree(grad)
    grad["block"] = jax.tree.map(lambda x: x.reshape(-1, *x.shape[3:]),
                                 grad["block"])
    return float(val), jax_named(grad)


def _jax_references():
    """Every JAX number the tests read (while the ranks run): two
    pipeline compiles (llama at pp 2 x vpp 2 and at pp 2 zero-bubble),
    the pp-1 grads of each arch, and two train steps."""
    for arch in ("llama", "gpt2"):
        b = _batch(3, _refs()[arch][1].vocab_size)
        _JAX[(arch, "pp1")] = _pipeline_loss(arch, b, PP2VPP2, 1)
    b = _batch(3, _refs()["llama"][1].vocab_size)
    for sched, par in (("pp2vpp2", PP2VPP2), ("pp2zb", PP2ZB)):
        _JAX[("llama", sched)] = _pipeline_loss("llama", b, par, 2)[0]
    jc, tc, jp = _refs()["llama"]
    b = _batch(5, tc.vocab_size, uneven=True)
    _JAX["uneven-pp1"] = _pipeline_loss("llama", b, PP2VPP2, 1)
    _JAX["uneven-pp2"] = _pipeline_loss("llama", b, PP2VPP2, 2)[0]
    loss = jax.jit(lambda t, lab, m: jgpt.gpt_loss(jp, t, lab, m, jc)[0])
    _JAX["uneven-means"] = float(np.mean([loss(*(
        jnp.asarray(b[k][i]) for k in ("tokens", "labels", "loss_mask")))
        for i in range(M)]))
    for grid in ("dp2", "tp2"):
        _JAX[grid] = _jax_run(jc, grid, OPT)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's reports of every case, from one spawn of 4 ranks."""
    tmp = tmp_path_factory.mktemp("pipeline")
    started = W.start_ranks(4, str(tmp / "store"), _cases(tmp))
    _jax_references()
    return W.collect(started), tmp


def _last(ranks, name, world=2):
    """The last stage's report (pp 2: the upper half of the ranks)."""
    return ranks[0][world // 2][name]


def _check_grads(got, want, err=""):
    assert got.keys() == want.keys()
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=f"{err} {n}")


@pytest.mark.parametrize("arch,sched", [("llama", "pp2vpp2"),
                                        ("llama", "pp2zb"),
                                        ("gpt2", "pp2vpp2"),
                                        ("gpt2", "pp2zb")])
def test_one_accumulation_matches_jax(ranks, arch, sched):
    """The loss against JAX's pipeline on a pp-2 mesh (llama; the gpt2
    config's against its pp-1 loss alone, to keep to two pipeline
    compiles), every grad against jax.grad on a pp-1 mesh."""
    reps = [ranks[0][r][f"grads-{arch}-{sched}"] for r in (0, 1)]
    assert reps[0]["loss"] == 0.0          # stage 0 holds no loss
    if arch == "llama":
        np.testing.assert_allclose(reps[1]["loss"], _JAX[(arch, sched)],
                                   rtol=0, atol=1e-5)
    pp1_loss, grads = _JAX[(arch, "pp1")]
    np.testing.assert_allclose(reps[1]["loss"], pp1_loss, rtol=0,
                               atol=1e-5)
    _check_grads(reps[0]["grads"], grads, f"{arch} {sched}")
    assert reps[1]["grads"].keys() == reps[0]["grads"].keys()
    for n in reps[0]["grads"]:
        assert np.array_equal(reps[1]["grads"][n], reps[0]["grads"][n]), n


def test_layer_placement_of_each_stage(ranks):
    """Stage 0 holds the embedding and layers 0 and 2 (chunks 0 and 1 at
    pp 2 x vpp 2), the last stage layers 1 and 3, the final norm and the
    output layer; a tied embedding's word also sits on the last stage."""
    def stage(r, name):
        return {n.split(".")[1] if n.startswith("layers.") else
                n.split(".")[0] for n in ranks[0][r][name]["names"]}
    assert stage(0, "grads-llama-pp2vpp2") == {"embedding", "0", "2"}
    assert stage(1, "grads-llama-pp2vpp2") == {"1", "3", "final_ln_scale",
                                               "output"}
    assert stage(1, "grads-gpt2-pp2zb") == {"2", "3", "final_ln_scale",
                                            "final_ln_bias", "embedding"}
    assert "embedding.pos" not in ranks[0][1]["grads-gpt2-pp2zb"]["names"]


def test_gather_tree_inverts_shard_tree_across_stages(ranks):
    """pp 2 x vpp 2 x tp 2, tied: each rank's stage pieces and tp shards
    gathered back (over tp, then every stage over the world) are the
    whole tree bitwise on every rank; the embedding's position table
    sits on stage 0 alone, the word table on both stages."""
    for r in range(4):
        rep = ranks[0][r]["roundtrip"]
        assert rep["same"] and all(rep["same"].values()), r
        shapes = rep["local_shapes"]
        assert ("embedding.pos" in shapes) == (r < 2)
        assert "embedding.word" in shapes
        assert shapes["embedding.word"][0] == 64       # vocab 128 / tp 2


def test_bfc_equals_dfc(ranks):
    a = _last(ranks, "grads-llama-pp2vpp2bfc")
    b = _last(ranks, "grads-llama-pp2vpp2")
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-7)
    _check_grads(a["grads"], b["grads"], "bfc")


def test_uneven_masks_give_the_token_mean_over_every_microbatch(ranks):
    rep = _last(ranks, "uneven")
    loss, grads = _JAX["uneven-pp1"]
    np.testing.assert_allclose(rep["loss"], _JAX["uneven-pp2"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rep["loss"], loss, rtol=0, atol=1e-5)
    _check_grads(rep["grads"], grads, "uneven")
    assert abs(_JAX["uneven-means"] - loss) > 100 * 1e-5


@pytest.mark.parametrize("grid", ["dp2", "tp2"])
def test_ten_steps_match_jax(ranks, grid):
    """pp 2 x dp 2 (ZeRO-1, 1F1B) and pp 2 x tp 2 (zero-bubble) against
    JAX's train step on a dp-2 / tp-2 mesh; every rank reads the same
    metrics."""
    losses, norms = _JAX[grid]
    name = f"steps-pp2{grid}"
    rep = ranks[0][0][name]
    np.testing.assert_allclose(rep["losses"], losses, rtol=STEP_TOL)
    np.testing.assert_allclose(rep["grad_norms"], norms, rtol=STEP_TOL)
    for r in range(1, 4):
        assert ranks[0][r][name]["losses"] == rep["losses"]
        assert ranks[0][r][name]["grad_norms"] == rep["grad_norms"]


def test_pipeline_evaluation_is_one_devices(ranks):
    """Evaluation every 5 steps at pp 2 x dp 2 (the pipeline's forward,
    the last stage's dp shares summed over the world) reads one device's
    eval losses on the same weights and stream."""
    from megatronapp_tpu_torch.models.convert import params_from_jax
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    _, tc, _ = _refs()["llama"]
    one = pretrain_gpt(tc, _train_cfg(**EVAL), OptimizerConfig(**OPT),
                       device="cpu", log_fn=lambda s: None,
                       params=params_from_jax(_init_params(), tc))
    for r in range(4):
        got = ranks[0][r]["steps-pp2dp2"]["eval_losses"]
        assert [i for i, _ in got] == [5, 10]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in one.eval_losses],
                                   rtol=1e-5)


def test_tied_embedding_copies_stay_bitwise_equal(ranks):
    a, b = ranks[0][0]["tied"], ranks[0][1]["tied"]
    assert a["losses"] == b["losses"] and len(a["losses"]) == 3
    assert np.array_equal(a["word"], b["word"])


def test_golden_gpt_tiny_pp2_vpp2(ranks):
    """tests/functional gpt_tiny_pp2_vpp2 (4 layers, hidden 64, 10 steps,
    4 microbatches, pp 2 x vpp 2) through the port's pretrain_gpt on 2
    ranks."""
    with open(GOLDEN) as f:
        golden = json.load(f)["gpt_tiny_pp2_vpp2"]
    for r in (0, 1):
        np.testing.assert_allclose(ranks[0][r]["golden"]["losses"], golden,
                                   rtol=2e-3, atol=2e-4)


def test_pp_checkpoint_restores_at_dp2_and_on_one_device(ranks):
    """The pp 2 x vpp 2 run's step-3 checkpoint holds every leaf whole
    under the one-device paths; restored at dp 2 and on one device, the
    state each writes back is the saved one, bitwise."""
    from megatronapp_tpu_torch.training.checkpointing import (
        CheckpointManager,
    )
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    _, tmp = ranks
    _, tc, _ = _refs()["llama"]
    saved = CheckpointManager(str(tmp / "pp")).restore(None)
    assert int(saved["step"]) == 3
    layers = {k.split(".")[1] for k in saved if k.startswith(
        "params/layers.")}
    assert layers == {"0", "1", "2", "3"}
    pretrain_gpt(tc, _train_cfg(train_iters=3, load_dir=str(tmp / "pp"),
                                save_dir=str(tmp / "one"), save_interval=3),
                 OptimizerConfig(**OPT), device="cpu",
                 log_fn=lambda s: None)
    for d in ("dp", "one"):
        back = CheckpointManager(str(tmp / d)).restore(None)
        assert back.keys() == saved.keys(), d
        for k, v in saved.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(back[k], v), (d, k)
            else:
                assert int(back[k]) == int(v), (d, k)


@pytest.mark.parametrize("case,leaf", [("more-layers", "layers.4."),
                                       ("untied-into-tied", "/output'")])
def test_pp_restore_refuses_another_models_checkpoint(ranks, case, leaf):
    """An 8-layer checkpoint restored into the 4-layer run at pp 2, and
    the untied pp checkpoint into a tied model of the same widths: each
    stage finds its own leaves there at their shapes, but the whole
    model's leaves are not the checkpoint's, so every rank raises."""
    for r in (0, 1):
        got = ranks[0][r][f"ckpt-{case}"]["raised"]
        assert "train state structure differs: missing []" in got, (r, got)
        assert leaf in got, (r, got)
