"""The port's dp × tp training grid against the JAX package, fp32 on the
CPU.

One spawn of four gloo ranks (FileStores under the test's tmp dir;
tests/torch_parallel_worker.py imports no jax) runs every case; the JAX
references run in the test process on 2 or 4 of the 8 virtual CPU
devices. Grids: dp 2, tp 2, dp 2 × tp 2 and tp 4, on a llama-style
config (GQA, swiglu, RMSNorm, rope, QK-layernorm, untied) and a
gpt2-style one (learned positions, LayerNorm, biases, gelu, tied).

- The golden gpt_tiny_tp2 curve (tests/functional) through the port's
  pretrain_gpt on 2 ranks, at that test's rtol 2e-3 / atol 2e-4.
- One accumulation of two microbatches: logits and loss within fp32
  1e-5 of JAX's gpt_forward / gpt_loss, every leaf's dp-summed gradient
  gathered whole within 1e-5 of the max of JAX's jax.grad, and the
  tp-replicated leaves' grads equal on every tp rank (the qk-layernorm
  scales after their tp sum).
- Ten steps: per-step loss and grad norm within 2e-3 of JAX's
  make_train_step on the same mesh with get_optimizer(distributed=True).
- ZeRO-1 at dp 2 bitwise equal to the replicated update after 3 steps
  (params, moments, metrics); bf16 moments against JAX's
  DistributedOptimizer with exp_avg_dtype / exp_avg_sq_dtype bf16.
- Uneven loss masks over the dp ranks give JAX's loss, which a mean of
  per-rank means misses.
- The vocab-parallel cross entropy with masks and the z-loss at tp 2 and
  dp 2 x tp 2: loss, per-token loss and logits' gradient against JAX's
  cross_entropy_loss and shard_map_cross_entropy.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_layers import cfg_pair
from test_torch_training import GOLDEN, GOLDEN_MODEL, _golden_init, jax_named

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.config.training_config import OptimizerConfig as JOpt
from megatronapp_tpu.data.mock import mock_batches as j_mock
from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu.training import train as jtrain
from megatronapp_tpu.training.optimizer import get_optimizer
from megatronapp_tpu.training.train_state import setup_train_state
from megatronapp_tpu.training.train_step import make_train_step as j_step
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)
from megatronapp_tpu_torch.parallel.sharding import tp_dim

LLAMA_TP = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
                num_query_groups=4, ffn_hidden_size=128, vocab_size=128,
                max_position_embeddings=64, normalization="rmsnorm",
                activation="swiglu", position_embedding="rope",
                add_bias_linear=False, qk_layernorm=True,
                untie_embeddings_and_output_weights=True,
                rotary_base=500000.0)
GPT2_TP = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
               ffn_hidden_size=128, vocab_size=128,
               max_position_embeddings=64, normalization="layernorm",
               activation="gelu", position_embedding="learned_absolute",
               add_qkv_bias=True)
ARCHS = {"llama": LLAMA_TP, "gpt2": GPT2_TP}
# name: (world, tp)
GRIDS = {"dp2": (2, 1), "tp2": (2, 2), "dp2tp2": (4, 2), "tp4": (4, 4)}
SEQ, GBS, STEPS = 16, 4, 10
OPT = dict(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=10, clip_grad=0.5)
GRAD_TOL = 1e-5
STEP_TOL = 2e-3


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _jax_state(jc, world, tp, opt, steps=STEPS, seed=1234):
    ctx = j_build_mesh(JPC(tensor_parallel=tp),
                       devices=jax.devices()[:world])
    jopt = JOpt(**(opt or OPT))
    optimizer = get_optimizer(jopt, steps, distributed=True)
    state, sh, _ = setup_train_state(
        jax.random.PRNGKey(seed), lambda r: jgpt.init_gpt_params(r, jc),
        optimizer, ctx)
    return ctx, jopt, optimizer, state, sh


def _jax_run(jc, grid, opt=None, steps=STEPS, seed=1234):
    """JAX's train step on the grid's mesh from setup_train_state's
    params (the same values on any mesh: _init_params): per-step losses
    and grad norms."""
    world, tp = GRIDS[grid]
    ctx, jopt, optimizer, state, sh = _jax_state(jc, world, tp, opt, steps,
                                                 seed)
    step = j_step(jtrain.gpt_microbatch_loss(jc, ctx), optimizer, jopt, ctx,
                  sh, steps, donate=False)
    it = j_mock(SEQ, jc.vocab_size, GBS, seed=seed)
    num_micro = GBS // ctx.dp
    losses, norms = [], []
    with ctx.mesh:
        for _ in range(steps):
            b = next(it)
            b = jtrain.reshape_global_batch(
                {k: b[k] for k in ("tokens", "labels", "loss_mask")},
                num_micro)
            state, m = step(state, b)
            m = jax.device_get(m)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms


def _batch(seed, n_micro, rows, vocab, uneven=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n_micro, rows, SEQ + 1)).astype(np.int32)
    mask = (rng.random((n_micro, rows, SEQ)) > 0.2).astype(np.float32)
    if uneven:
        # dp rank 0's rows keep a few tokens, rank 1's nearly all.
        mask[:, :rows // 2] = (rng.random((n_micro, rows // 2, SEQ))
                               > 0.9)
        mask[:, rows // 2:] = 1.0
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
            "loss_mask": mask}


def _train_cfg(**kw):
    return TrainingConfig(**{**dict(micro_batch_size=1,
                                    global_batch_size=GBS, seq_length=SEQ,
                                    train_iters=STEPS, log_interval=1,
                                    seed=1234), **kw})


_REFS = {}


def _refs():
    """Each arch's configs and eager JAX init (the grads cases'), once."""
    if not _REFS:
        for arch, kw in ARCHS.items():
            jc, tc = cfg_pair(**kw)
            _REFS[arch] = (jc, tc, jgpt.init_gpt_params(
                jax.random.PRNGKey(7), jc)[0])
    return _REFS


_INIT = {}


def _init_params(arch):
    """setup_train_state's params (JAX's seeded train-state init, the
    same values on every mesh) as numpy: the ten-step runs' start."""
    if arch not in _INIT:
        state = _jax_state(_refs()[arch][0], 1, 1, None)[3]
        _INIT[arch] = _np_tree(state["params"])
    return _INIT[arch]


def _cases():
    refs = _refs()
    cases = []
    golden_jc = jc_golden()
    tc_golden = TransformerConfig(compute_dtype=torch.float32,
                                  **GOLDEN_MODEL)
    cases.append(dict(
        name="golden", kind="train", world=2, tp=2, cfg=tc_golden,
        params=_golden_init(golden_jc),
        train=TrainingConfig(micro_batch_size=2, global_batch_size=4,
                             seq_length=32, train_iters=10, log_interval=2,
                             seed=1234),
        opt=OptimizerConfig(lr=1e-3, lr_warmup_iters=2, lr_decay_iters=10)))
    for arch, (jc, tc, jp) in refs.items():
        params = W.np_tree(_np_tree(jp))
        batch = _batch(3, 2, 4, tc.vocab_size)
        for grid, (world, tp) in GRIDS.items():
            cases.append(dict(name=f"grads-{arch}-{grid}", kind="grads",
                              world=world, tp=tp, zero1=False, cfg=tc,
                              params=params, batch=batch))
            cases.append(dict(name=f"steps-{arch}-{grid}", kind="train",
                              world=world, tp=tp, cfg=tc,
                              params=_init_params(arch),
                              train=_train_cfg(),
                              opt=OptimizerConfig(**OPT)))
    jc, tc, jp = refs["llama"]
    for zero1 in (True, False):
        cases.append(dict(name=f"zero1-{zero1}", kind="train", world=2, tp=1,
                          zero1=zero1, cfg=tc, flat=True,
                          train=_train_cfg(train_iters=3),
                          opt=OptimizerConfig(**OPT)))
    bf16 = BF16
    cases.append(dict(name="bf16-moments", kind="train", world=2, tp=1,
                      cfg=tc, params=_init_params("llama"),
                      train=_train_cfg(), opt=OptimizerConfig(**bf16)))
    cases.append(dict(name="uneven", kind="grads", world=4, tp=2,
                      zero1=False, cfg=tc, params=W.np_tree(_np_tree(jp)),
                      batch=_batch(5, 2, 4, tc.vocab_size, uneven=True)))
    logits, targets, mask = _ce_inputs()
    for grid in CE_GRIDS:
        world, tp = GRIDS[grid]
        cases.append(dict(name=f"ce-{grid}", kind="ce", world=world, tp=tp,
                          logits=logits, targets=targets, mask=mask,
                          z_losses=(0.0, 1e-3)))
    return cases


CE_GRIDS = ("tp2", "dp2tp2")


def _ce_inputs():
    rng = np.random.default_rng(9)
    logits = (3 * rng.normal(size=(4, 7, 64))).astype(np.float32)
    targets = rng.integers(0, 64, (4, 7)).astype(np.int32)
    mask = (rng.random((4, 7)) > 0.3).astype(np.float32)
    return logits, targets, mask


BF16 = dict(OPT, exp_avg_dtype="bf16", exp_avg_sq_dtype="bf16")
_JAX_RUNS = {}
_JAX_GRADS = {}


def _jax_references():
    """Every JAX run the tests read (while the ranks run)."""
    for arch in ARCHS:
        for grid in GRIDS:
            _JAX_RUNS[(arch, grid, "fp32")] = _jax_run(_refs()[arch][0],
                                                       grid)
        _jax_grads(arch, _batch(3, 2, 4, _refs()[arch][1].vocab_size))
    _JAX_RUNS[("llama", "dp2", "bf16")] = _jax_run(_refs()["llama"][0],
                                                   "dp2", BF16)
    _jax_grads("llama", _batch(5, 2, 4, _refs()["llama"][1].vocab_size,
                               uneven=True), key="uneven")


def jc_golden():
    from megatronapp_tpu.config.transformer_config import (
        TransformerConfig as JConfig,
    )
    return JConfig(compute_dtype=jnp.float32, **GOLDEN_MODEL)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's reports of every case, from one spawn of 4 ranks."""
    store = tmp_path_factory.mktemp("parallel_train") / "store"
    started = W.start_ranks(4, str(store), _cases())
    _jax_references()
    return W.collect(started)


def _lead(ranks, name):
    return ranks[0][name]


def test_golden_gpt_tiny_tp2(ranks):
    """tests/functional gpt_tiny_tp2 (2 layers, hidden 64, 10 steps, tp 2)
    through the port's pretrain_gpt on 2 ranks."""
    with open(GOLDEN) as f:
        golden = json.load(f)["gpt_tiny_tp2"]
    for r in (0, 1):
        np.testing.assert_allclose(ranks[r]["golden"]["losses"], golden,
                                   rtol=2e-3, atol=2e-4)


def _jax_grads(arch, batch, key=None):
    """JAX's mean over microbatches of (loss, jax.grad) and the first
    microbatch's logits, on one device (GSPMD computes the same function
    on any mesh); cached by arch (or key)."""
    key = key or arch
    if key in _JAX_GRADS:
        return _JAX_GRADS[key]
    jc, _, jp = _refs()[arch]

    @jax.jit
    def loss_grad(p, toks, labels, mask):
        return jax.value_and_grad(
            lambda q: jgpt.gpt_loss(q, toks, labels, mask, jc)[0])(p)

    n = batch["tokens"].shape[0]
    vals, grads = zip(*[loss_grad(jp, *(jnp.asarray(batch[k][i]) for k in (
        "tokens", "labels", "loss_mask"))) for i in range(n)])
    grad = jax.tree.map(lambda *g: sum(g) / n, *grads)
    logits, _ = jax.jit(lambda p, t: jgpt.gpt_forward(p, t, jc))(
        jp, jnp.asarray(batch["tokens"][0]))
    _JAX_GRADS[key] = (float(sum(vals) / n), jax_named(_np_tree(grad)),
                       np.asarray(logits))
    return _JAX_GRADS[key]


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_one_accumulation_matches_jax(ranks, arch, grid):
    """Logits, loss and every leaf's gradient of two microbatches."""
    world, tp = GRIDS[grid]
    name = f"grads-{arch}-{grid}"
    batch = _batch(3, 2, 4, _refs()[arch][1].vocab_size)
    loss, grads, logits = _jax_grads(arch, batch)
    dp = world // tp
    rows = batch["tokens"].shape[1] // dp
    # The loss: the dp ranks' shares summed, averaged over microbatches.
    got = sum(sum(ranks[d * tp][name]["losses"]) for d in range(dp)) / 2
    np.testing.assert_allclose(got, loss, rtol=0, atol=1e-5)
    for d in range(dp):
        np.testing.assert_allclose(
            ranks[d * tp][name]["logits"], logits[d * rows:(d + 1) * rows],
            rtol=0, atol=1e-5)
    rep = ranks[0][name]["grads"]
    assert rep.keys() == grads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(rep[n], g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=n)
    # Every rank holds the same dp-summed gradient of every leaf.
    for r in range(1, world):
        for n in rep:
            assert np.array_equal(ranks[r][name]["grads"][n], rep[n]), n


@pytest.mark.parametrize("grid", ["tp2", "dp2tp2", "tp4"])
def test_replicated_leaves_get_equal_grads_on_every_tp_rank(ranks, grid):
    """The norms, row-parallel biases and position embedding see the
    whole residual stream's gradient on every tp rank; the qk-layernorm
    scales see their heads' share (summed over tp before the update)."""
    world, tp = GRIDS[grid]
    for arch in ARCHS:
        name = f"grads-{arch}-{grid}"
        own = [ranks[r][name]["own"] for r in range(world)]
        partial = [n for n in own[0] if n.endswith(("q_ln_scale",
                                                    "k_ln_scale"))]
        assert bool(partial) == (arch == "llama")
        for n in own[0]:
            assert tp_dim(n) is None
            for r in range(1, tp):
                if n in partial:
                    assert not np.array_equal(own[r][n], own[0][n]), n
                else:
                    assert np.array_equal(own[r][n], own[0][n]), n


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_ten_steps_match_jax_on_the_same_mesh(ranks, arch, grid):
    losses, norms = _JAX_RUNS[(arch, grid, "fp32")]
    rep = ranks[0][f"steps-{arch}-{grid}"]
    np.testing.assert_allclose(rep["losses"], losses, rtol=STEP_TOL)
    np.testing.assert_allclose(rep["grad_norms"], norms, rtol=STEP_TOL)
    world = GRIDS[grid][0]
    for r in range(1, world):
        assert ranks[r][f"steps-{arch}-{grid}"]["losses"] == rep["losses"]


def test_zero1_is_bitwise_the_replicated_update(ranks):
    """dp 2, 3 steps, clipping on: reduce-scatter and all-reduce sum the
    same two operands, and the norm is summed in one order either way."""
    z, rep = ranks[0]["zero1-True"], ranks[0]["zero1-False"]
    assert z["losses"] == rep["losses"]
    assert z["grad_norms"] == rep["grad_norms"]
    assert max(rep["grad_norms"]) > OPT["clip_grad"]
    for r in (0, 1):
        a, b = ranks[r]["zero1-True"], ranks[r]["zero1-False"]
        assert np.array_equal(a["params"], b["params"])
        half = a["mu"].size
        assert b["mu"].size == 2 * half
        for k in ("mu", "nu"):
            assert np.array_equal(a[k], b[k][r * half:(r + 1) * half])


def test_bf16_moments_match_jax_distributed_optimizer(ranks):
    losses, norms = _JAX_RUNS[("llama", "dp2", "bf16")]
    rep = ranks[0]["bf16-moments"]
    np.testing.assert_allclose(rep["losses"], losses, rtol=STEP_TOL)
    np.testing.assert_allclose(rep["grad_norms"], norms, rtol=STEP_TOL)
    # The fp32-moment run of the same grid differs (the dtype matters).
    fp32 = ranks[0]["steps-llama-dp2"]["losses"]
    assert rep["losses"] != fp32


def test_uneven_masks_give_the_global_token_mean(ranks):
    """The token mean spans every dp rank's rows: each rank divides by
    the microbatch's whole mask count. A mean of per-rank means misses
    JAX's loss."""
    batch = _batch(5, 2, 4, _refs()["llama"][1].vocab_size, uneven=True)
    loss, grads, _ = _jax_grads("llama", batch, key="uneven")
    got = sum(sum(ranks[d * 2]["uneven"]["losses"]) for d in (0, 1)) / 2
    np.testing.assert_allclose(got, loss, rtol=0, atol=1e-5)
    rep = ranks[0]["uneven"]["grads"]
    for n, g in grads.items():
        np.testing.assert_allclose(rep[n], g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=n)
    jc, _, jp = _refs()["llama"]
    loss_fn = jax.jit(lambda t, lab, m: jgpt.gpt_loss(jp, t, lab, m, jc)[0])
    per_rank = [float(loss_fn(*(jnp.asarray(batch[k][i, 2 * d:2 * d + 2])
                                for k in ("tokens", "labels", "loss_mask"))))
                for i in range(2) for d in range(2)]
    assert abs(np.mean(per_rank) - loss) > 100 * 1e-5


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("grid", CE_GRIDS)
def test_vocab_parallel_cross_entropy_matches_jax(ranks, grid, z_loss):
    """The vocab-parallel CE with masks and the z-loss on the global
    log-sum-exp: the loss (the dp ranks' shares summed), each rank's
    rows' per-token loss and d loss / d logits gathered over tp against
    jax.value_and_grad of JAX's cross_entropy_loss, at the one-device
    test's tolerances; without the z-loss the per-token loss also
    against JAX's shard_map_cross_entropy on a tp-2 mesh."""
    from jax.sharding import Mesh, PartitionSpec as P

    from megatronapp_tpu.ops.cross_entropy import (
        cross_entropy_loss as jce, shard_map_cross_entropy,
    )
    from megatronapp_tpu.parallel.collectives import shard_map_compat
    logits, targets, mask = _ce_inputs()
    (j_loss, j_tok), j_grad = jax.value_and_grad(
        lambda x: jce(x, jnp.asarray(targets), jnp.asarray(mask), z_loss),
        has_aux=True)(jnp.asarray(logits))
    world, tp = GRIDS[grid]
    dp = world // tp
    rows = logits.shape[0] // dp
    reps = [ranks[r][f"ce-{grid}"][z_loss] for r in range(world)]
    got = sum(reps[d * tp]["loss"] for d in range(dp))
    np.testing.assert_allclose(got, float(j_loss), rtol=1e-6)
    for r, rep in enumerate(reps):
        mine = slice((r // tp) * rows, (r // tp + 1) * rows)
        np.testing.assert_allclose(rep["per_token"], np.asarray(j_tok)[mine],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rep["grad"], np.asarray(j_grad)[mine],
                                   atol=1e-7)
    if z_loss:
        return
    cols = logits.shape[-1] // 2

    def local_fn(lg, tg):
        return shard_map_cross_entropy(lg, tg, jax.lax.axis_index("tp")
                                       * cols, "tp")

    sharded = jax.jit(shard_map_compat(
        local_fn, Mesh(np.array(jax.devices()[:2]), ("tp",)),
        in_specs=(P(None, None, "tp"), P(None, None)),
        out_specs=P(None, None)))(jnp.asarray(logits), jnp.asarray(targets))
    for r, rep in enumerate(reps):
        mine = slice((r // tp) * rows, (r // tp + 1) * rows)
        np.testing.assert_allclose(rep["per_token"],
                                   np.asarray(sharded)[mine], rtol=1e-6,
                                   atol=1e-6)


def test_grids_start_from_one_devices_init():
    """The seeded init on a grid is the tp shards of the one-device
    init (each piece drawn whole in the one-device order)."""
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.parallel.sharding import shard_tree
    from test_torch_parallel_sharding import fake_ctx
    _, tc = cfg_pair(**LLAMA_TP)
    whole = init_gpt_params(tc, torch.Generator().manual_seed(3), "cpu")
    for r in range(2):
        ctx = fake_ctx(2, r)
        mine = dict(init_gpt_params(tc, torch.Generator().manual_seed(3),
                                    "cpu", ctx).named_parameters())
        want = dict(shard_tree(whole, ctx).named_parameters())
        assert mine.keys() == want.keys()
        for n in want:
            assert torch.equal(mine[n], want[n]), n
