"""FSDP in the port (ParallelConfig(fsdp=True): parallel/sharding.py's
FSDP_RULES, parallel/collectives.py's fsdp_gather, the optimizer side in
training/distributed_optimizer.py) against the JAX package's, fp32 on
the CPU. One spawn of four gloo ranks (tests/torch_parallel_worker.py).

- At dp 2 and dp 2 × tp 2 a rank's shards hold 1/dp of every leaf with
  an 'embed' axis (the word embedding's H split over dp, on top of its
  vocab split over tp), the rest whole, and gather back bitwise; the
  rank's resident params are about half of a ZeRO-1 rank's.
- Six steps within 2e-5 of the port's ZeRO-1 run on the same grid and
  within 2e-3 of JAX's pretrain_gpt with ParallelConfig(fsdp=True) (JAX
  tests/test_training.py:147-201).
- pp 2 × dp 2 and cp 2 × dp 2 with FSDP, and dp 2 with an MTP depth,
  within 1e-5 of the same runs without it.
- A checkpoint written under FSDP restores under ZeRO-1, and one written
  under ZeRO-1 under FSDP, bit for bit.
- ep, MoE layers, MegaFBD and MegaDPP beside FSDP raise, naming their
  ROADMAP.md item.
"""

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
from megatronapp_tpu.training.train import pretrain_gpt as j_pretrain
from megatronapp_tpu_torch.config.parallel_config import (
    FSDP_UNPORTED_ITEM, ParallelConfig,
)
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)

MODEL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=64)
STEPS = 6
# name: (world, tp)
GRIDS = {"dp2": (2, 1), "dp2tp2": (4, 2)}


def _cfg(**kw):
    return TransformerConfig(**{**MODEL, "compute_dtype": torch.float32,
                                **kw})


def _train(**kw):
    return TrainingConfig(**{**dict(micro_batch_size=1, global_batch_size=4,
                                    seq_length=32, train_iters=STEPS,
                                    log_interval=1), **kw})


def _cases(tmp):
    params = _golden_init(JConfig(compute_dtype=jnp.float32, **MODEL))
    cases = []
    for grid, (world, tp) in GRIDS.items():
        for fsdp in (True, False):
            cases.append(dict(name=f"steps-{grid}-{fsdp}", kind="train",
                              world=world, tp=tp, par=dict(fsdp=fsdp),
                              cfg=_cfg(), params=params, train=_train(),
                              opt=OptimizerConfig(lr=1e-3)))
        cases.append(dict(name=f"shards-{grid}", kind="roundtrip",
                          world=world, tp=tp, par=dict(fsdp=True),
                          cfg=_cfg(), params=params))
    for axis in ("pipeline_parallel", "context_parallel"):
        for fsdp in (True, False):
            cases.append(dict(name=f"{axis}-{fsdp}", kind="train", world=4,
                              tp=1, par={axis: 2, "fsdp": fsdp},
                              cfg=_cfg(), train=_train(),
                              opt=OptimizerConfig(lr=1e-3)))
    for fsdp in (True, False):
        cases.append(dict(name=f"mtp-{fsdp}", kind="train", world=2, tp=1,
                          par=dict(fsdp=fsdp), cfg=_cfg(mtp_num_layers=1),
                          train=_train(train_iters=3),
                          opt=OptimizerConfig(lr=1e-3)))
    a, b, c = (os.path.join(tmp, n) for n in "abc")
    cases += [
        dict(name="ckpt-fsdp", kind="train", world=4, tp=2,
             par=dict(fsdp=True), cfg=_cfg(),
             train=_train(train_iters=2, save_dir=a, save_interval=2),
             opt=OptimizerConfig(lr=1e-3)),
        dict(name="ckpt-zero1", kind="train", world=4, tp=2, cfg=_cfg(),
             train=_train(train_iters=2, load_dir=a, save_dir=b,
                          save_interval=2), opt=OptimizerConfig(lr=1e-3)),
        dict(name="ckpt-back", kind="train", world=4, tp=2,
             par=dict(fsdp=True), cfg=_cfg(),
             train=_train(train_iters=2, load_dir=b, save_dir=c,
                          save_interval=2), opt=OptimizerConfig(lr=1e-3))]
    return cases, (a, b, c)


_JAX = {}


def _jax_runs():
    """JAX's pretrain_gpt with ParallelConfig(fsdp=True) on each grid."""
    for grid, (world, tp) in GRIDS.items():
        par = JPC(tensor_parallel=tp, data_parallel=world // tp, fsdp=True)
        ctx = j_build_mesh(par, devices=jax.devices()[:world])
        res = j_pretrain(JConfig(compute_dtype=jnp.float32, **MODEL), par,
                         JTrain(micro_batch_size=1, global_batch_size=4,
                                seq_length=32, train_iters=STEPS,
                                log_interval=1),
                         JOpt(lr=1e-3), ctx=ctx, log_fn=lambda *_: None)
        _JAX[grid] = [float(x) for x in res.losses]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    cases, dirs = _cases(str(tmp))
    started = W.start_ranks(4, str(tmp / "store"), cases)
    _jax_runs()
    reps = W.collect(started)
    reps[0]["_dirs"] = dirs
    return reps


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_shards_hold_a_dp_share_of_each_embed_leaf(ranks, grid):
    world, tp = GRIDS[grid]
    for r in range(world):
        rep = ranks[r][f"shards-{grid}"]
        assert all(rep["same"].values())
        shapes = rep["local_shapes"]
        # word [V, H]: V over tp, H over dp.
        assert shapes["embedding.word"] == (128 // tp, 64 // 2)
        assert shapes["layers.0.attention.q_kernel"] == (32, 64 // tp)
        assert shapes["layers.0.attention.out_kernel"] == (64 // tp, 32)
        assert shapes["layers.0.ln1_scale"] == (32,)
        assert shapes["layers.0.mlp.fc1_bias"] == (256 // tp,)
    fsdp = ranks[0][f"steps-{grid}-True"]["local_params"]
    zero1 = ranks[0][f"steps-{grid}-False"]["local_params"]
    assert 0.45 * zero1 < fsdp < 0.55 * zero1


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_fsdp_matches_zero1_and_jaxs_fsdp(ranks, grid):
    world, _ = GRIDS[grid]
    fsdp = ranks[0][f"steps-{grid}-True"]
    zero1 = ranks[0][f"steps-{grid}-False"]
    np.testing.assert_allclose(fsdp["losses"], zero1["losses"], atol=2e-5)
    np.testing.assert_allclose(fsdp["grad_norms"], zero1["grad_norms"],
                               rtol=2e-5)
    np.testing.assert_allclose(fsdp["losses"], _JAX[grid], rtol=2e-3)
    for r in range(1, world):
        assert ranks[r][f"steps-{grid}-True"]["losses"] == fsdp["losses"]


@pytest.mark.parametrize("axis", ["pipeline_parallel", "context_parallel"])
def test_fsdp_under_pp_and_cp_matches_the_run_without_it(ranks, axis):
    on, off = ranks[0][f"{axis}-True"], ranks[0][f"{axis}-False"]
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
    np.testing.assert_allclose(on["grad_norms"], off["grad_norms"],
                               rtol=1e-5)


def test_fsdp_with_mtp_depths_matches_zero1(ranks):
    """dp 2 with an MTP depth: its leaves, and the embedding and head it
    reuses, gathered as the main stack's are."""
    on, off = ranks[0]["mtp-True"], ranks[0]["mtp-False"]
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
    np.testing.assert_allclose(on["mtp_losses"], off["mtp_losses"],
                               rtol=1e-5)
    assert on["local_params"] < 0.55 * off["local_params"]


def test_checkpoints_cross_between_fsdp_and_zero1_bitwise(ranks):
    from megatronapp_tpu_torch.training.checkpointing import (
        CheckpointManager,
    )
    states = []
    for d in ranks[0]["_dirs"]:
        mngr = CheckpointManager(d)
        states.append(mngr.restore(None, step=2))
        mngr.close()
    a, b, c = states
    assert set(a) == set(b) == set(c)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]) and torch.equal(b[k], c[k]), k
        else:
            assert a[k] == b[k] == c[k], k
    assert ranks[0]["ckpt-zero1"]["step"] == 2


@pytest.mark.parametrize("field", ["expert_parallel",
                                   "forward_backward_disaggregating",
                                   "use_dpp"])
def test_fsdp_refuses_ep_fbd_and_dpp(field):
    value = 2 if field == "expert_parallel" else True
    extra = {} if field == "expert_parallel" else dict(pipeline_parallel=2)
    with pytest.raises(NotImplementedError,
                       match=FSDP_UNPORTED_ITEM.replace("(", r"\(")
                       .replace(")", r"\)")):
        ParallelConfig(fsdp=True, **{field: value}, **extra)


def test_fsdp_refuses_moe_layers():
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    with pytest.raises(NotImplementedError, match="FSDP under ep, MoE"):
        pretrain_gpt(_cfg(num_moe_experts=4), _train(), OptimizerConfig(),
                     device="cpu", parallel=ParallelConfig(fsdp=True))
    assert ParallelConfig(fsdp=True, tensor_parallel=2, pipeline_parallel=2,
                          context_parallel=2).fsdp
