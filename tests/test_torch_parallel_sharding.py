"""The port's tensor-parallel shards and the refusals of the training
grid, on the CPU in this process (no ranks: nothing here runs a
collective).

- The rule table is JAX's (megatronapp_tpu/parallel/sharding.py
  DEFAULT_RULES and each leaf's logical axes): every JAX leaf's
  tp-split dimension is the port's.
- shard_leaf then unshard_leaf (gather_tree's arithmetic; gather_tree
  itself runs on spawned ranks in tests/test_torch_parallel_ckpt.py)
  reproduces JAX's leaves bitwise, for the fused kv_kernel, the gated
  fc1 and its bias among all; a rank's kv shard is its K heads then its
  V heads, and its gated fc1 shard its gate then its value columns.
- shard_tree of a JAX tree equals params_from_jax(..., ctx=).
- Every refused axis, field and flag raises or exits with a message
  naming its ROADMAP.md item; the pipeline, MegaFBD and MegaDPP fields
  and flags, refused until they were ported, now pass and refuse only
  what JAX's config and parser refuse; the heads that do not split over tp,
  MTP and MLA under tp, local checkpoints on a grid are refused.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_layers import cfg_pair

from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.parallel import sharding as jsharding
from megatronapp_tpu_torch import pretrain_gpt as entry
from megatronapp_tpu_torch.config.parallel_config import (
    UNPORTED_PARALLEL_FIELDS, ParallelConfig,
)
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.parallel import sharding
from megatronapp_tpu_torch.parallel.mesh import MeshContext

GATED = dict(num_layers=1, hidden_size=64, num_attention_heads=8,
             num_query_groups=4, ffn_hidden_size=96, vocab_size=128,
             max_position_embeddings=64, normalization="rmsnorm",
             activation="swiglu", position_embedding="rope",
             add_qkv_bias=True, qk_layernorm=True,
             untie_embeddings_and_output_weights=True)


def fake_ctx(tp, rank, dp=1):
    """A grid rank's view without groups (shards only; no collective)."""
    return MeshContext(group=None,
                       parallel=ParallelConfig(tensor_parallel=tp,
                                               data_parallel=dp),
                       rank=rank, device=torch.device("cpu"),
                       backend="gloo")


def _jax_tree():
    jc, tc = cfg_pair(**GATED)
    jp, ax = jgpt.init_gpt_params(jax.random.PRNGKey(0), jc)
    return tc, jax.tree.map(np.asarray, jp), ax


def test_rule_table_and_leaf_axes_are_jaxs():
    assert sharding.DEFAULT_RULES == tuple(
        (n, a if not isinstance(a, tuple) else tuple(a))
        for n, a in jsharding.DEFAULT_RULES)
    _, jp, ax = _jax_tree()
    flat = jax.tree_util.tree_flatten_with_path(
        ax, is_leaf=jsharding.is_logical_axes)[0]
    for path, axes in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        stacked = str(getattr(path[0], "key", path[0])) == "block"
        own = axes[1:] if stacked else axes
        assert sharding.LOGICAL_AXES[name] == own, name
        spec = tuple(jsharding.logical_to_spec(own))
        assert sharding.logical_to_spec(own) == spec, name
        want = spec.index("tp") if "tp" in spec else None
        assert sharding.tp_dim(name) == want, name


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_gather_back_to_jaxs_leaves_bitwise(tp):
    tc, jp, _ = _jax_tree()
    full = dict(params_from_jax(jp, tc).named_parameters())
    locals_ = [dict(sharding.shard_tree(params_from_jax(jp, tc),
                                        fake_ctx(tp, r)).named_parameters())
               for r in range(tp)]
    segs = {"layers.0.attention.kv_kernel": 2,
            "layers.0.attention.kv_bias": 2,
            "layers.0.mlp.fc1_kernel": 2, "layers.0.mlp.fc1_bias": 2}
    for n, t in full.items():
        dim = sharding.tp_dim(n)
        back = sharding.unshard_leaf([loc[n] for loc in locals_], dim,
                                     segs.get(n, 1))
        assert torch.equal(back, t), n
        if dim is not None:
            assert locals_[0][n].shape[dim] * tp == t.shape[dim], n
    d, nkv, f = tc.head_dim, tc.num_query_groups, tc.ffn_hidden_size
    kv = full["layers.0.attention.kv_kernel"]
    fc1 = full["layers.0.mlp.fc1_bias"]
    k_l, f_l = nkv * d // tp, f // tp
    for r, loc in enumerate(locals_):
        mine = loc["layers.0.attention.kv_kernel"]
        assert torch.equal(mine[:, :k_l], kv[:, r * k_l:(r + 1) * k_l])
        assert torch.equal(mine[:, k_l:],
                           kv[:, nkv * d + r * k_l:nkv * d + (r + 1) * k_l])
        mine = loc["layers.0.mlp.fc1_bias"]
        assert torch.equal(mine[:f_l], fc1[r * f_l:(r + 1) * f_l])
        assert torch.equal(mine[f_l:], fc1[f + r * f_l:f + (r + 1) * f_l])


def test_shard_tree_of_a_jax_tree_is_params_from_jax_with_ctx():
    tc, jp, _ = _jax_tree()
    for r in range(2):
        ctx = fake_ctx(2, r)
        a = dict(sharding.shard_tree(params_from_jax(jp, tc),
                                     ctx).named_parameters())
        b = dict(params_from_jax(jp, tc, ctx=ctx).named_parameters())
        assert a.keys() == b.keys()
        assert all(torch.equal(a[n], b[n]) for n in a)


def test_mesh_context_axes():
    """rank = dp_index · tp + tp_index (tp innermost, JAX's axis order)."""
    got = [(c.dp_rank, c.tp_rank, c.tp_ranks, c.dp_ranks)
           for c in (fake_ctx(2, r, dp=2) for r in range(4))]
    assert got == [(0, 0, [0, 1], [0, 2]), (0, 1, [0, 1], [1, 3]),
                   (1, 0, [2, 3], [0, 2]), (1, 1, [2, 3], [1, 3])]
    assert fake_ctx(2, 3, dp=2).shard(8) == slice(4, 8)


# The pipeline fields, refused until pipelines were ported: each is now
# accepted, and raises only on what JAX's ParallelConfig refuses.
PP_FIELDS = {"pipeline_parallel": (2, 0, "must be >= 1"),
             "virtual_pipeline_parallel": (2, 0, "must be >= 1"),
             "pp_schedule": ("zero-bubble", "gpipe", "must be one of")}


# MegaFBD's and MegaDPP's fields, refused until they were ported: each
# now passes, and raises only beside what JAX refuses with it.
FBD_DPP_FIELDS = {
    "forward_backward_disaggregating": (
        dict(pipeline_parallel=2), dict(pp_schedule="zero-bubble"),
        "do not compose with --forward-backward-disaggregating"),
    "use_dpp": (dict(pipeline_parallel=2), dict(pp_plan_from_trace=True),
                "does not compose with --use-dpp"),
}


# FSDP, refused until it was ported: it now composes with tp, pp and cp
# and raises beside ep, naming its own item (tests/test_torch_fsdp.py
# holds MoE, FBD and DPP).
FSDP_FIELDS = {"fsdp": (dict(tensor_parallel=2, pipeline_parallel=2,
                             context_parallel=2),
                        dict(expert_parallel=2),
                        "Queue 1 item 4 (FSDP under ep, MoE, FBD and DPP)")}


@pytest.mark.parametrize("field", sorted(UNPORTED_PARALLEL_FIELDS)
                         + sorted(PP_FIELDS) + sorted(FBD_DPP_FIELDS)
                         + sorted(FSDP_FIELDS))
def test_unported_parallel_fields_raise(field):
    if field in FSDP_FIELDS:
        good, bad, item = FSDP_FIELDS[field]
        assert ParallelConfig(**{field: True}, **good).fsdp
        with pytest.raises(NotImplementedError, match=item.replace(
                "(", r"\(").replace(")", r"\)")):
            ParallelConfig(**{field: True}, **bad)
        return
    if field in FBD_DPP_FIELDS:
        good, bad, msg = FBD_DPP_FIELDS[field]
        assert getattr(ParallelConfig(**{field: True}, **good), field)
        with pytest.raises(ValueError, match=msg):
            ParallelConfig(**{field: True}, **good, **bad)
        return
    if field in PP_FIELDS:
        good, bad, msg = PP_FIELDS[field]
        assert getattr(ParallelConfig(**{field: good}), field) == good
        with pytest.raises(ValueError, match=msg):
            ParallelConfig(**{field: bad})
        return
    value = {"fsdp": True}.get(field, 2)
    flag, item = UNPORTED_PARALLEL_FIELDS[field]
    with pytest.raises(ValueError, match=f"ROADMAP.md {item}".replace(
            "(", r"\(").replace(")", r"\)")):
        ParallelConfig(**{field: value})


@pytest.mark.parametrize("field,item", [
    ("fp8", "--fp8-amax-history-len must be >= 1, got 0"),
    ("tp_comm_overlap", "--hidden-size (64) is not divisible by "
                        "--tensor-model-parallel-size (3)")])
def test_unported_transformer_fields_raise(field, item):
    """fp8 and the TP overlap rings, refused until they were ported: the
    config now takes them, off by default, and raises only what JAX's
    parser raises beside them (its history length; the rings'
    divisibility, config/transformer_config.py check_tp_comm_overlap)."""
    from megatronapp_tpu_torch.config.transformer_config import (
        TransformerConfig, check_tp_comm_overlap,
    )
    cfg = TransformerConfig(hidden_size=64, num_attention_heads=4,
                            **{field: True})
    assert getattr(cfg, field) and not getattr(TransformerConfig(), field)
    with pytest.raises(ValueError, match=item.replace("(", r"\(")
                       .replace(")", r"\)")):
        if field == "fp8":
            TransformerConfig(fp8=True, fp8_amax_history_len=0)
        check_tp_comm_overlap(cfg, 3)
    check_tp_comm_overlap(cfg, 2)


def test_parallel_config_follows_jax():
    from megatronapp_tpu.config.parallel_config import ParallelConfig as J
    assert not ParallelConfig(sequence_parallel=True).sequence_parallel
    assert ParallelConfig(tensor_parallel=2,
                          sequence_parallel=True).sequence_parallel
    assert ParallelConfig().distributed_optimizer == J().distributed_optimizer
    for ranks, tp in ((4, 2), (8, 4), (2, 2)):
        assert ParallelConfig(tensor_parallel=tp).infer_data_parallel(
            ranks) == J(tensor_parallel=tp).infer_data_parallel(ranks)
    with pytest.raises(ValueError, match="not divisible"):
        ParallelConfig(tensor_parallel=2).infer_data_parallel(3)
    with pytest.raises(ValueError, match="inconsistent"):
        ParallelConfig(data_parallel=4).infer_data_parallel(2)


# The pipeline flags, refused until pipelines were ported: each now
# parses, and exits only on what JAX's parser refuses.
PP_FLAGS = {
    "--pipeline-model-parallel-size": (["2"], ["0"], "must be >= 1"),
    "--num-layers-per-virtual-pipeline-stage": (
        ["3", "--pipeline-model-parallel-size", "2"],
        ["4", "--pipeline-model-parallel-size", "2"],
        "must divide layers-per-stage"),
    "--pp-schedule": (["zero-bubble"], ["gpipe"], "invalid choice"),
}


# MegaFBD's and MegaDPP's flags, refused until they were ported: each now
# parses, and refuses what JAX's parser refuses beside it.
FBD_DPP_FLAGS = {
    "--forward-backward-disaggregating": (
        ["--exp-avg-dtype", "bf16"],
        "not supported with --forward-backward-disaggregating"),
    "--use-dpp": (["--pp-schedule", "zero-bubble"],
                  "does not compose with --use-dpp"),
}


# The TP overlap flags, refused until the rings were ported: each now
# parses into its field, and exits on what JAX's parser refuses.
OVERLAP_FLAGS = {
    "--tp-comm-overlap": (["--tp-comm-overlap"], "tp_comm_overlap", True),
    "--dist-opt-comm": (["--dist-opt-comm", "ring"], "dist_opt_comm",
                        "ring"),
}


@pytest.mark.parametrize("flag", sorted(entry.UNPORTED_FLAGS)
                         + sorted(PP_FLAGS) + sorted(FBD_DPP_FLAGS)
                         + sorted(OVERLAP_FLAGS)
                         + sorted(entry.NOT_JAX_FLAGS))
def test_entry_point_refuses_unported_axes(flag, capsys):
    if flag in FBD_DPP_FLAGS:
        bad, msg = FBD_DPP_FLAGS[flag]
        base = ["--num-layers", "12", "--pipeline-model-parallel-size", "2"]
        par = entry.parallel_from_args(entry.parse_args(base + [flag]))
        assert (par.forward_backward_disaggregating, par.use_dpp,
                par.pipeline_order_policy) == (
            (True, False, "dfc") if flag != "--use-dpp"
            else (False, True, "bfc"))
        with pytest.raises(ValueError, match=msg):
            entry.parallel_from_args(entry.parse_args(base + [flag] + bad))
        return
    if flag in PP_FLAGS:
        good, bad, msg = PP_FLAGS[flag]
        base = ["--num-layers", "12"]
        args = entry.parse_args(base + [flag] + good)
        par = entry.parallel_from_args(args)
        assert (par.pipeline_parallel, par.virtual_pipeline_parallel,
                par.pp_schedule) == {
            "--pipeline-model-parallel-size": (2, 1, "1f1b"),
            "--num-layers-per-virtual-pipeline-stage": (2, 2, "1f1b"),
            "--pp-schedule": (1, 1, "zero-bubble")}[flag]
        with pytest.raises((SystemExit, ValueError), match=None) as e:
            entry.parallel_from_args(entry.parse_args(base + [flag] + bad))
        got = str(e.value) if e.type is ValueError \
            else capsys.readouterr().err
        assert msg in got
        return
    if flag in OVERLAP_FLAGS:
        argv, field, value = OVERLAP_FLAGS[flag]
        base = ["--tensor-model-parallel-size", "2"]
        model, _, opt = entry.configs_from_args(entry.parse_args(base +
                                                                 argv))
        assert getattr(model if field == "tp_comm_overlap" else opt,
                       field) == value
        with pytest.raises(SystemExit):
            entry.parse_args(base + [flag, "allgather"] if value == "ring"
                             else base + [flag, "x"])
        return
    with pytest.raises(SystemExit):
        entry.parse_args([flag])
    err = capsys.readouterr().err
    assert flag in err and entry.NOT_JAX_FLAGS[flag] in err
    assert "ParallelConfig(fsdp=True)" in err


def test_entry_point_parses_the_grid_flags(capsys):
    args = entry.parse_args(["--tensor-model-parallel-size", "2",
                             "--sequence-parallel", "--exp-avg-dtype",
                             "bf16", "--exp-avg-sq-dtype", "bf16"])
    par = entry.parallel_from_args(args)
    assert (par.tensor_parallel, par.sequence_parallel,
            par.distributed_optimizer) == (2, True, True)
    _, _, opt = entry.configs_from_args(args)
    assert (opt.exp_avg_dtype, opt.exp_avg_sq_dtype) == ("bf16", "bf16")
    args = entry.parse_args(["--no-use-distributed-optimizer"])
    assert not entry.parallel_from_args(args).distributed_optimizer
    with pytest.raises(SystemExit):
        entry.parse_args(["--no-use-distributed-optimizer",
                          "--exp-avg-dtype", "bf16"])
    assert "require --use-distributed-optimizer" in capsys.readouterr().err
    assert entry.launch_env({}) is None
    assert entry.launch_env({"RANK": "3", "WORLD_SIZE": "4",
                             "LOCAL_RANK": "1", "MASTER_ADDR": "h",
                             "MASTER_PORT": "29500"}) == {
        "rank": 3, "world_size": 4, "local_rank": 1,
        "init_method": "tcp://h:29500"}
    assert entry.rank_device("cpu", 3) == torch.device("cpu")
    assert entry.build_grid(entry.parse_args([]), 0, 1, "unused") is None


def test_optimizer_refusals_name_their_items():
    """bf16 params still refuse (Queue 1 item 3); dist_opt_comm, refused
    until the ring ZeRO-1 return was ported, takes JAX's three modes and
    refuses any other."""
    with pytest.raises(ValueError, match="Queue 1 item 3"):
        OptimizerConfig(main_params_dtype="bf16")
    for comm in ("gspmd", "ring", "bulk"):
        assert OptimizerConfig(dist_opt_comm=comm).dist_opt_comm == comm
    with pytest.raises(ValueError, match="takes"):
        OptimizerConfig(dist_opt_comm="allgather")


def test_grid_refusals():
    from megatronapp_tpu_torch.models.gpt import gpt_loss, init_gpt_params
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    from megatronapp_tpu_torch.transformer.attention import (
        attention_forward,
    )
    _, tc = cfg_pair(**dict(GATED, num_attention_heads=6,
                            num_query_groups=3))
    ctx = fake_ctx(2, 0)
    p = init_gpt_params(tc, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="split over tp 2"):
        attention_forward(p["layers"][0]["attention"],
                          torch.zeros(1, 4, 64), tc, ctx=ctx)
    _, tc = cfg_pair(**dict(GATED, mtp_num_layers=1))
    p = init_gpt_params(tc, torch.Generator().manual_seed(0), "cpu", ctx)
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="MTP under tp"):
        gpt_loss(p, toks, toks, None, tc, ctx=ctx)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        pretrain_gpt(dataclasses.replace(tc, mtp_num_layers=None),
                     TrainingConfig(global_batch_size=2, seq_length=8,
                                    train_iters=1,
                                    non_persistent_save_interval=1,
                                    non_persistent_ckpt_dir="/nonexistent"),
                     OptimizerConfig(), ctx=ctx, log_fn=lambda s: None)
    with pytest.raises(NotImplementedError, match="gloo"):
        build_mesh(ParallelConfig(tensor_parallel=2), rank=0,
                   init_method="file:///nonexistent", device="cpu",
                   backend="nccl")
