"""The port's layers against the JAX package on the same numpy inputs:
norms, rope (plain and YaRN), activations, the MLP and one paged layer
(decode and ragged). Everything runs in fp32 on the CPU; atol 1e-5 for
the elementwise ops and 1e-4 for the layer (different matmul summation
orders over widths of 64-128, with values of order 1-10)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.config import transformer_config as jcfg
from megatronapp_tpu.ops import activations as jact
from megatronapp_tpu.ops import normalization as jnorm
from megatronapp_tpu.ops import rotary as jrot
from megatronapp_tpu.transformer.block import layer_forward as j_layer
from megatronapp_tpu.transformer.mlp import mlp_forward as j_mlp
from megatronapp_tpu_torch.config import transformer_config as tcfg
from megatronapp_tpu_torch.ops import activations as tact
from megatronapp_tpu_torch.ops import normalization as tnorm
from megatronapp_tpu_torch.ops.paged_attention import paged_write_index
from megatronapp_tpu_torch.ops import rotary as trot
from megatronapp_tpu_torch.transformer.block import layer_forward as t_layer
from megatronapp_tpu_torch.transformer.mlp import mlp_forward as t_mlp
from megatronapp_tpu_torch.utils.params import ParamTree

ATOL = 1e-5
LAYER_TOL = 1e-4

_ENUMS = ("normalization", "activation", "position_embedding")

LLAMA_SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                   num_query_groups=2, ffn_hidden_size=128, vocab_size=128,
                   max_position_embeddings=64, normalization="rmsnorm",
                   activation="swiglu", position_embedding="rope",
                   add_bias_linear=False,
                   untie_embeddings_and_output_weights=True,
                   rotary_base=500000.0, init_method_std=0.4)
GPT2_SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                  ffn_hidden_size=128, vocab_size=128,
                  max_position_embeddings=64, normalization="layernorm",
                  activation="gelu", position_embedding="learned_absolute",
                  add_qkv_bias=True, init_method_std=0.4)


def cfg_pair(**kw):
    """The same architecture as a JAX and a port TransformerConfig, fp32
    params and compute on both sides. Enum fields are given by name."""
    j, t = dict(kw), dict(kw)
    for f in _ENUMS:
        if f in kw:
            j[f] = getattr(getattr(jcfg, _enum_cls(f)), kw[f])
            t[f] = getattr(getattr(tcfg, _enum_cls(f)), kw[f])
    j.update(params_dtype=jnp.float32, compute_dtype=jnp.float32,
             remat_policy="none")
    t.update(params_dtype=torch.float32, compute_dtype=torch.float32)
    return jcfg.TransformerConfig(**j), tcfg.TransformerConfig(**t)


def _enum_cls(field):
    return {"normalization": "NormKind", "activation": "ActivationKind",
            "position_embedding": "PositionEmbeddingKind"}[field]


def tree(np_dict):
    """A nested dict of numpy leaves → the port's ParamTree."""
    leaves = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in np_dict.items() if not isinstance(v, dict)}
    children = {k: tree(v) for k, v in np_dict.items()
                if isinstance(v, dict)}
    return ParamTree(leaves, **children)


def random_layer(cfg_t, seed):
    """One layer's params as numpy: every leaf random (biases and norm
    scales included, so nothing tests as zeros or ones)."""
    rng = np.random.default_rng(seed)
    from megatronapp_tpu_torch.transformer.block import init_layer_params
    shapes = init_layer_params(cfg_t, torch.Generator().manual_seed(0),
                               "cpu")

    def walk(m):
        out = {}
        for name, p in m._parameters.items():
            base = 1.0 if "scale" in name else 0.0
            out[name] = (base + 0.4 * rng.normal(size=tuple(p.shape))
                         ).astype(np.float32)
        for name, child in m._modules.items():
            out[name] = walk(child)
        return out
    return walk(shapes)


def _jtree(d):
    return {k: (_jtree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in d.items()}


# ---------------------------------------------------------------------------
# norms, activations, rope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    s = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    jk = getattr(jcfg.NormKind, kind)
    tk = getattr(tcfg.NormKind, kind)
    want = np.asarray(jnorm.apply_norm(jk, jnp.asarray(x), jnp.asarray(s),
                                       jnp.asarray(b), 1e-5))
    got = tnorm.apply_norm(tk, torch.from_numpy(x), torch.from_numpy(s),
                           torch.from_numpy(b), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_norms_compute_in_fp32_and_cast_back():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    s = torch.ones(64)
    out = tnorm.rms_norm(x.to(torch.bfloat16), s)
    assert out.dtype == torch.bfloat16
    ref = tnorm.rms_norm(x.to(torch.bfloat16).float(), s)
    torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float())


@pytest.mark.parametrize("kind", ["gelu", "swiglu", "geglu", "relu",
                                  "squared_relu"])
def test_activations_match(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 32)).astype(np.float32) * 2
    g = rng.normal(size=(4, 32)).astype(np.float32) * 2
    gated = kind in ("swiglu", "geglu")
    jk = getattr(jcfg.ActivationKind, kind)
    tk = getattr(tcfg.ActivationKind, kind)
    want = np.asarray(jact.apply_activation(
        jk, jnp.asarray(x), jnp.asarray(g) if gated else None))
    got = tact.apply_activation(
        tk, torch.from_numpy(x),
        torch.from_numpy(g) if gated else None).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("percent,per_row", [(1.0, False), (0.5, False),
                                             (1.0, True)])
def test_rope_matches(percent, per_row):
    """Half-rotation layout; partial rotary (pass-through tail); per-row
    [B, S, half] tables as the paged steps use them."""
    rng = np.random.default_rng(2)
    d, b, s = 32, 2, 6
    x = rng.normal(size=(b, s, 3, d)).astype(np.float32)
    pos = (rng.integers(0, 500, (b, s)) if per_row
           else np.arange(s)).astype(np.int32)
    jf = jrot.rope_frequencies(d, 500000.0, percent)
    tf = trot.rope_frequencies(d, 500000.0, percent)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    jc, js = jrot.rope_cos_sin(jnp.asarray(pos), jf)
    tc, ts = trot.rope_cos_sin(torch.from_numpy(pos), tf)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    want = np.asarray(jrot.apply_rope(jnp.asarray(x), jc, js))
    got = trot.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_yarn_matches():
    args = dict(head_dim=64, base=10000.0, scaling_factor=4.0,
                original_max_position=256, beta_fast=32.0, beta_slow=1.0)
    jf = jrot.yarn_frequencies(**args)
    tf = trot.yarn_frequencies(**args)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    assert trot.yarn_mscale(4.0, 0.1) == pytest.approx(
        jrot.yarn_mscale(4.0, 0.1))
    assert trot.yarn_mscale(1.0) == 1.0


def test_gpt_rope_tables_yarn_match():
    from megatronapp_tpu.models.gpt import gpt_rope_tables as j_tables
    from megatronapp_tpu_torch.models.gpt import gpt_rope_tables as t_tables
    jc, tc = cfg_pair(**dict(LLAMA_SMALL, position_embedding="yarn",
                             rope_scaling_factor=4.0,
                             yarn_original_max_position=32))
    jcos, jsin = j_tables(jc, 40)
    tcos, tsin = t_tables(tc, 40)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=ATOL)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=ATOL)


# ---------------------------------------------------------------------------
# MLP and one paged layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_mlp_matches(arch):
    """Gated (swiglu, gate = first half of fc1, no bias) and dense (tanh
    gelu, biased)."""
    jc, tc = cfg_pair(**(LLAMA_SMALL if arch == "llama" else GPT2_SMALL))
    p = random_layer(tc, 3)["mlp"]
    x = np.random.default_rng(4).normal(size=(2, 5, 64)).astype(np.float32)
    want = np.asarray(j_mlp(_jtree(p), jnp.asarray(x), jc))
    got = t_mlp(tree(p), torch.from_numpy(x), tc).numpy()
    np.testing.assert_allclose(got, want, atol=LAYER_TOL, rtol=LAYER_TOL)


def _paged_inputs(cfg_t, seed, b, s, bs=4, mb=6):
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    hkv, d = cfg_t.num_query_groups, cfg_t.head_dim
    pools = [rng.normal(size=(nb, bs, hkv, d)).astype(np.float32)
             for _ in range(2)]
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    x = rng.normal(size=(b, s, cfg_t.hidden_size)).astype(np.float32)
    return pools, table, x


@pytest.mark.parametrize("arch,ragged", [("llama", False), ("llama", True),
                                         ("gpt2", False), ("gpt2", True)])
def test_paged_layer_matches(arch, ragged):
    """One paged layer: output and both updated pools, decode (one token
    per slot, one slot inactive) and ragged (chunk rows with padding)."""
    from megatronapp_tpu.models.gpt import gpt_rope_tables as j_tables
    from megatronapp_tpu_torch.models.gpt import gpt_rope_tables as t_tables
    jc, tc = cfg_pair(**(LLAMA_SMALL if arch == "llama" else GPT2_SMALL))
    p = random_layer(tc, 5)
    b, s = 3, (5 if ragged else 1)
    (kp, vp), table, x = _paged_inputs(tc, 6, b, s)
    starts = np.asarray([3, 9, 0], np.int32)
    counts = np.asarray([5, 2, 4], np.int32) if ragged else None
    active = np.asarray([True, True, ragged])
    pos = np.minimum(starts[:, None] + np.arange(s)[None, :], 63)
    jcos, jsin = j_tables(jc, 64)
    if jcos is not None:
        jcos, jsin = jcos[pos], jsin[pos]
    tcos, tsin = t_tables(tc, 64)
    if tcos is not None:
        tcos = tcos[torch.from_numpy(pos).long()]
        tsin = tsin[torch.from_numpy(pos).long()]
    (j_out, j_cache), _ = j_layer(
        _jtree(p), jnp.asarray(x), jc, jcos, jsin, None,
        kv_cache=(jnp.asarray(kp), jnp.asarray(vp)),
        cache_positions=jnp.asarray(starts), page_table=jnp.asarray(table),
        active=jnp.asarray(active),
        chunk_counts=None if counts is None else jnp.asarray(counts))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    index = paged_write_index(
        torch.from_numpy(table), torch.from_numpy(starts),
        torch.from_numpy(np.full(b, s, np.int32) if counts is None
                         else counts),
        torch.from_numpy(active), tk.shape[1], s)
    (t_out, t_cache), _ = t_layer(
        tree(p), torch.from_numpy(x), tc, tcos, tsin,
        kv_cache=(tk, tv), cache_positions=torch.from_numpy(starts),
        page_table=torch.from_numpy(table),
        chunk_counts=None if counts is None else torch.from_numpy(counts),
        write_index=index)
    assert t_cache[0] is tk and t_cache[1] is tv      # written in place
    out_j, out_t = np.asarray(j_out), t_out.numpy()
    if ragged:
        # Padding rows are garbage on both sides: compare the real rows.
        real = np.arange(s)[None, :] < counts[:, None]
        out_j, out_t = out_j[real], out_t[real]
    else:
        out_j, out_t = out_j[active], out_t[active]
    np.testing.assert_allclose(out_t, out_j, atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(j_cache[0]),
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(j_cache[1]),
                               atol=LAYER_TOL, rtol=LAYER_TOL)


def test_unported_branches_raise():
    """The branches still to port: MLA's dense cache, context- and
    tensor-parallel attention and MoE; fused decode without the paged
    pools it is built around. (The dense training branch is ported:
    tests/test_torch_training.py; fused decode:
    tests/test_torch_fused_decode.py; the GQA dense-cache branches a draft
    model runs: tests/test_torch_speculative.py.)"""
    _, tc = cfg_pair(**LLAMA_SMALL)
    p = tree(random_layer(tc, 7))
    x = torch.zeros(1, 4, 64)
    cache = (torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    _, mla = cfg_pair(**{**LLAMA_SMALL, "multi_latent_attention": True,
                         "kv_lora_rank": 32, "qk_head_dim": 16,
                         "qk_pos_emb_head_dim": 8, "v_head_dim": 16})
    with pytest.raises(NotImplementedError, match="dense slot cache"):
        t_layer(tree(random_layer(mla, 7)), x, mla, kv_cache=cache,
                cache_index=0)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        t_layer(p, x, tc, ctx=object())
    with pytest.raises(ValueError, match="paged decode/multiquery"):
        t_layer(p, x, tc, fused_decode=True)
    moe = dataclasses.replace(tc, num_moe_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        t_layer(p, x, moe)
