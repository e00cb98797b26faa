"""The port's MoE layer (megatronapp_tpu_torch/transformer/moe.py) against
the JAX package's transformer/moe.py on the same numpy inputs and
converted params, fp32 on the CPU.

- ``moe_forward``: dropless, capacity with drops, a shared expert, the
  z-loss, gated and ungated activations: the output within 1e-5 of its
  RMS, the aux loss within 1e-6 relative, and the grads of sum(out · dout)
  + aux (every leaf and the input) within 1e-4 normwise of ``jax.grad``.
- Top-1: the renormalised weight is p / p = 1, whose gradient cancels,
  so the router's gradient is the z-loss's plus the rounding of that
  cancellation (JAX's is 4.0e-4 normwise from the exact float64 z-loss
  gradient, the port's 1.1e-4): the output and the other grads are held
  to JAX's, the router's to the float64 gradient at 2e-4.
- The router's top-k indices and the capacity dispatch's positions (so
  its drop set) equal JAX's exactly; the inputs hold no near-tie of the
  k-th and the next probability (asserted), where torch.topk and
  lax.top_k may order equal values apart.
- The whole model at moe_layer_freq 2 (JAX's grouped stack converted):
  loss, aux and grads against JAX's gpt_loss.
- Resident int8 expert stacks: PTQ bytes and scales equal JAX's, and the
  layer on them matches JAX's on its resident tree.
- The dropless combine repeats bit for bit; an expert without rows runs
  no product.
- JAX's config checks with JAX's words, the mixtral-8x7b preset's
  fields, the flop count, and the refusals (LoRA on a MoE layer, MTP
  depths with MoE, MoE under pp / cp, experts that do not split over ep).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import cfg_pair, tree

from megatronapp_tpu.inference import quantization as jq
from megatronapp_tpu.models import gpt as jgpt
from megatronapp_tpu.models import presets as jpresets
from megatronapp_tpu.transformer import moe as jmoe
from megatronapp_tpu.utils.flops import flops_per_token as j_flops
from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.config.transformer_config import (
    TransformerConfig,
)
from megatronapp_tpu_torch.inference import quantization as tq
from megatronapp_tpu_torch.models import presets as tpresets
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.models.gpt import gpt_loss, init_gpt_params
from megatronapp_tpu_torch.parallel.mesh import MeshContext
from megatronapp_tpu_torch.transformer import moe as tmoe
from megatronapp_tpu_torch.utils.flops import flops_per_token as t_flops

OUT_TOL = 1e-5          # of the output's RMS
GRAD_TOL = 1e-4         # normwise
TIE_GAP = 1e-4          # least gap between the k-th and next probability

BASE = dict(num_layers=1, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, num_moe_experts=4,
            moe_router_topk=2, moe_aux_loss_coeff=0.01, init_method_std=0.2)
CASES = {
    "dropless-gelu": {},
    "dropless-swiglu": dict(activation="swiglu", num_moe_experts=8),
    "capacity-drops": dict(moe_capacity_factor=0.5),
    "capacity-swiglu-zloss": dict(activation="swiglu",
                                  moe_capacity_factor=1.0,
                                  moe_z_loss_coeff=1e-3),
    "shared-expert": dict(moe_shared_expert_intermediate_size=32),
    "zloss-only": dict(moe_z_loss_coeff=1e-2, moe_aux_loss_coeff=0.0),
}


def _pair(**kw):
    return cfg_pair(**{**BASE, **kw})


def _inputs(jc, seed=0, b=2, s=16):
    """JAX's init_moe_params from a key, and x / dout from numpy."""
    p, _ = jmoe.init_moe_params(jax.random.PRNGKey(seed), jc, out_std=0.1)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(b, s, jc.hidden_size)).astype(np.float32)
    dout = rng.normal(size=(b, s, jc.hidden_size)).astype(np.float32)
    return p, x, dout


def _assert_no_near_ties(p, x, jc):
    logits = x.reshape(-1, x.shape[-1]) @ p["router_kernel"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    srt = -np.sort(-probs, axis=-1)
    k = jc.moe_router_topk
    if k < probs.shape[-1]:
        assert np.min(srt[:, k - 1] - srt[:, k]) > TIE_GAP


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                    1e-30))


def _jax_moe(p, x, dout, jc):
    def f(q, y):
        out, aux = jmoe.moe_forward(q, y, jc)
        return jnp.sum(out * dout) + aux, (out, aux)
    (_, (out, aux)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(p, x)
    return (np.asarray(out), float(aux),
            jax.tree.map(np.asarray, grads[0]), np.asarray(grads[1]))


def _port_moe(p, x, dout, tc):
    pt = tree(p)
    pt.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_forward(pt, xt, tc)
    ((out * torch.from_numpy(dout)).sum() + aux).backward()
    grads = {n: q.grad.numpy() for n, q in pt.named_parameters()}
    return out.detach().numpy(), float(aux), grads, xt.grad.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_and_grads_match_jax(case):
    jc, tc = _pair(**CASES[case])
    p, x, dout = _inputs(jc)
    _assert_no_near_ties(p, x, jc)
    j_out, j_aux, j_gp, j_gx = _jax_moe(p, x, dout, jc)
    t_out, t_aux, t_gp, t_gx = _port_moe(p, x, dout, tc)
    rms = float(np.sqrt(np.mean(j_out ** 2)))
    assert np.max(np.abs(t_out - j_out)) <= OUT_TOL * rms
    assert t_aux == pytest.approx(j_aux, rel=1e-6, abs=1e-12)
    assert set(t_gp) == set(j_gp)
    for name in j_gp:
        assert _normwise(t_gp[name], j_gp[name]) <= GRAD_TOL, name
    assert _normwise(t_gx, j_gx) <= GRAD_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_topk_and_positions_are_jaxs_exactly(case):
    jc, tc = _pair(**CASES[case])
    p, x, _ = _inputs(jc)
    xf = x.reshape(-1, x.shape[-1])
    j_idx, j_probs, j_aux = jmoe._router(p, jnp.asarray(xf), jc)
    t_idx, t_probs, t_aux = tmoe._router(tree(p), torch.from_numpy(xf), tc)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs),
                               rtol=1e-6, atol=1e-7)
    flat = np.asarray(j_idx).reshape(-1)
    j_pos = np.asarray(jmoe._position_in_expert(jnp.asarray(flat),
                                                jc.num_moe_experts))
    t_pos = tmoe._position_in_expert(torch.from_numpy(flat).long(),
                                     tc.num_moe_experts).numpy()
    np.testing.assert_array_equal(t_pos, j_pos)
    if jc.moe_capacity_factor is not None:
        t = xf.shape[0]
        cap = max(int(jc.moe_capacity_factor * t * jc.moe_router_topk
                      / jc.num_moe_experts), 1)
        # The drop set: copies at or past the capacity; some drop here.
        dropped = t_pos >= cap
        if case == "capacity-drops":
            assert dropped.any() and not dropped.all()


def test_top1_matches_jax_and_the_exact_router_gradient():
    jc, tc = _pair(moe_router_topk=1, moe_z_loss_coeff=1e-2,
                   moe_aux_loss_coeff=0.0)
    p, x, dout = _inputs(jc)
    _assert_no_near_ties(p, x, jc)
    j_out, j_aux, j_gp, j_gx = _jax_moe(p, x, dout, jc)
    t_out, t_aux, t_gp, t_gx = _port_moe(p, x, dout, tc)
    rms = float(np.sqrt(np.mean(j_out ** 2)))
    assert np.max(np.abs(t_out - j_out)) <= OUT_TOL * rms
    assert t_aux == pytest.approx(j_aux, rel=1e-6)
    for name in ("fc1_kernel", "fc2_kernel"):
        assert _normwise(t_gp[name], j_gp[name]) <= GRAD_TOL, name
    assert _normwise(t_gx, j_gx) <= GRAD_TOL
    # The exact router gradient: only the z-loss's, in float64.
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xf @ p["router_kernel"].astype(np.float64)
    top = logits.max(axis=1, keepdims=True)
    e = np.exp(logits - top)
    total = e.sum(axis=1, keepdims=True)
    z = (np.log(total) + top)[:, 0]
    exact = 1e-2 * xf.T @ (2 * z[:, None] * e / total) / xf.shape[0]
    assert _normwise(t_gp["router_kernel"], exact) <= 2e-4


def test_capacity_drops_where_dropless_does_not():
    jc, tc = _pair(moe_capacity_factor=0.25)
    jd, td = _pair()
    p, x, _ = _inputs(jc)
    drop, _ = tmoe.moe_forward(tree(p), torch.from_numpy(x), tc)
    free, _ = tmoe.moe_forward(tree(p), torch.from_numpy(x), td)
    want, _ = jmoe.moe_forward(p, jnp.asarray(x), jd)
    assert not np.allclose(drop.numpy(), free.numpy(), atol=1e-3)
    np.testing.assert_allclose(free.numpy(), np.asarray(want), atol=1e-5)


def _jax_gpt(jc, seed=0):
    p, _ = jgpt.init_gpt_params(jax.random.PRNGKey(seed), jc)
    return jax.tree.map(np.asarray, p)


def test_layer_freq_2_model_matches_jax():
    """moe_layer_freq 2: JAX's grouped {moe, dense} stack converted; layer
    0 and 2 are MoE, 1 and 3 dense; loss, aux and grads vs gpt_loss."""
    jc, tc = cfg_pair(**{**BASE, "num_layers": 4, "moe_layer_freq": 2,
                         "moe_z_loss_coeff": 1e-3})
    jp = _jax_gpt(jc)
    assert set(jp["block"]) == {"moe", "dense"}
    pt = params_from_jax(jp, tc)
    assert ["moe" in layer for layer in pt["layers"]] == [True, False,
                                                         True, False]
    toks = np.random.default_rng(3).integers(0, 128, (2, 16)).astype(
        np.int32)

    def jloss(q):
        loss, m = jgpt.gpt_loss(q, jnp.asarray(toks), jnp.asarray(toks),
                                None, jc)
        return loss, m["moe_aux_loss"]
    (j_loss, j_aux), j_g = jax.value_and_grad(jloss, has_aux=True)(jp)
    pt.requires_grad_(True)
    t = torch.from_numpy(toks).long()
    loss, m = gpt_loss(pt, t, t, None, tc)
    loss.backward()
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    assert float(m["moe_aux_loss"]) == pytest.approx(float(j_aux),
                                                     rel=1e-5)
    got = {n: q.grad.numpy() for n, q in pt.named_parameters()}
    for g in range(2):
        for name in ("router_kernel", "fc1_kernel", "fc2_kernel"):
            want = np.asarray(j_g["block"]["moe"]["moe"][name])[g]
            assert _normwise(got[f"layers.{2 * g}.moe.{name}"],
                             want) <= GRAD_TOL
        want = np.asarray(j_g["block"]["dense"]["mlp"]["fc1_kernel"])[g, 0]
        assert _normwise(got[f"layers.{2 * g + 1}.mlp.fc1_kernel"],
                         want) <= GRAD_TOL


def test_seeded_port_init_builds_the_layer_pattern():
    cfg = TransformerConfig(num_layers=4, hidden_size=32,
                            num_attention_heads=4, vocab_size=64,
                            num_moe_experts=4, moe_layer_freq=2,
                            moe_shared_expert_intermediate_size=16,
                            ffn_hidden_size=128,
                            activation=tpresets.ActivationKind.swiglu)
    p = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    moe = p["layers"][0]["moe"]
    assert moe["router_kernel"].dtype == torch.float32
    assert tuple(moe["fc1_kernel"].shape) == (4, 32, 2 * 128)
    assert tuple(moe["fc2_kernel"].shape) == (4, 128, 32)
    assert tuple(moe["shared_fc1"].shape) == (32, 32)
    assert ["moe" in layer for layer in p["layers"]] == [True, False,
                                                        True, False]


def test_resident_int8_expert_stacks_match_jax():
    """PTQ of the expert stacks (per channel on the last axis, leading
    axes stacks) gives JAX's bytes and scales; the layer on the resident
    stacks matches JAX's on its resident tree."""
    jc, tc = cfg_pair(**{**BASE, "num_layers": 2, "activation": "swiglu"})
    jp = _jax_gpt(jc)
    jres = jq.residentize_params(jq.quantize_params(
        jp, resident_only=True)[0])
    tres = tq.quantize_for_serving(params_from_jax(jp, tc))[0]
    for i, layer in enumerate(tres["layers"]):
        for kernel in ("fc1_kernel", "fc2_kernel"):
            got = layer["moe"][kernel]
            want = jres["block"]["moe"][kernel]
            assert tq.is_resident_leaf(got)
            np.testing.assert_array_equal(got["qint8"].numpy(),
                                          np.asarray(want["qint8"])[i])
            np.testing.assert_array_equal(got["qscale"].numpy(),
                                          np.asarray(want["qscale"])[i])
        # The router is not quantized, and stays fp32.
        assert isinstance(layer["moe"]["router_kernel"], torch.Tensor)
        assert layer["moe"]["router_kernel"].dtype == torch.float32
    x = np.random.default_rng(5).normal(size=(2, 8, 64)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: np.asarray(a)[0], jres["block"]["moe"])
    want, _ = jmoe.moe_forward(jlayer, jnp.asarray(x), jc)
    got, _ = tmoe.moe_forward(tres["layers"][0]["moe"], torch.from_numpy(x),
                              tc)
    rms = float(np.sqrt(np.mean(np.asarray(want) ** 2)))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= OUT_TOL * rms


def test_dropless_combine_repeats_and_skips_idle_experts(monkeypatch):
    jc, tc = _pair(num_moe_experts=8)
    p, x, _ = _inputs(jc, b=1, s=2)
    pt, xt = tree(p), torch.from_numpy(x)
    a, _ = tmoe.moe_forward(pt, xt, tc)
    b, _ = tmoe.moe_forward(pt, xt, tc)
    assert torch.equal(a, b)
    calls = []
    orig = tmoe._expert_weight
    monkeypatch.setattr(tmoe, "_expert_weight", lambda w, i, dt: (
        calls.append(i), orig(w, i, dt))[1])
    tmoe.moe_forward(pt, xt, tc)
    # Two tokens, top-2: at most 4 of 8 experts run (fc1 and fc2 each).
    used = sorted(set(calls))
    assert len(calls) == 2 * len(used) and len(used) <= 4


def test_config_checks_raise_jax_words():
    with pytest.raises(ValueError, match=r"moe_capacity_factor must be > 0 "
                       r"\(got 0.0\); omit it \(None\) for dropless"):
        TransformerConfig(num_moe_experts=4, moe_capacity_factor=0.0)
    with pytest.raises(ValueError, match="num_layers=3 not divisible by "
                       "moe_layer_freq=2"):
        TransformerConfig(num_layers=3, num_moe_experts=4, moe_layer_freq=2)
    cfg = TransformerConfig(num_moe_experts=4, ffn_hidden_size=96)
    assert cfg.moe_ffn_hidden_size == 96


def test_mixtral_preset_and_flops_are_jaxs():
    j, t = jpresets.mixtral_8x7b(), tpresets.mixtral_8x7b()
    for f in dataclasses.fields(t):
        if f.name in ("params_dtype", "compute_dtype"):
            continue
        want = getattr(j, f.name)
        got = getattr(t, f.name)
        if hasattr(want, "value"):
            want, got = want.value, got.value
        assert got == want, f.name
    assert tpresets.PRESETS["mixtral-8x7b"] is tpresets.mixtral_8x7b
    for cfg_kw in ({}, {"moe_shared_expert_intermediate_size": 2048}):
        assert t_flops(tpresets.mixtral_8x7b(**cfg_kw), 4096) == j_flops(
            jpresets.mixtral_8x7b(**cfg_kw), 4096)


def _ctx(**par):
    return MeshContext(group=None, parallel=ParallelConfig(**par), rank=0,
                       device=torch.device("cpu"), backend="gloo")


def test_refusals_name_their_item(monkeypatch):
    jc, tc = _pair()
    p, x, _ = _inputs(jc)
    from megatronapp_tpu_torch.transformer import block
    from megatronapp_tpu_torch.transformer.block import layer_forward
    # The layer's LoRA refusal sits in its MoE branch, after attention
    # (which takes lora on the paged branches only): a stand-in attention.
    monkeypatch.setattr(block, "attention_forward",
                        lambda p, h, *a, **k: (h, None))
    layer = init_gpt_params(tc, torch.Generator().manual_seed(0),
                            "cpu")["layers"][0]
    with pytest.raises(ValueError, match="lora serving targets the dense "
                       "fc1/fc2 kernels — MoE layers are unsupported"):
        layer_forward(layer, torch.from_numpy(x), tc,
                      lora={"row_adapter": None, "banks": {}})
    item = r"Queue 1 item 4 \(MoE under pp, cp, FBD, DPP, MTP and serve-tp\)"
    with pytest.raises(NotImplementedError, match=item):
        init_gpt_params(dataclasses.replace(tc, mtp_num_layers=1),
                        torch.Generator().manual_seed(0), "cpu")
    for par in (dict(pipeline_parallel=2, data_parallel=1),
                dict(context_parallel=2, data_parallel=1)):
        with pytest.raises(NotImplementedError, match=item):
            tmoe.moe_forward(tree(p), torch.from_numpy(x), tc,
                             ctx=_ctx(**par))
    for par in (dict(expert_parallel=2, pipeline_parallel=2),
                dict(expert_parallel=2, context_parallel=2),
                dict(expert_parallel=2,
                     forward_backward_disaggregating=True),
                dict(expert_parallel=2, use_dpp=True)):
        with pytest.raises(NotImplementedError, match=item):
            ParallelConfig(**par)
    with pytest.raises(ValueError, match="num_moe_experts % ep == 0"):
        tmoe.check_expert_parallel(
            dataclasses.replace(tc, num_moe_experts=3),
            _ctx(expert_parallel=2, data_parallel=1))
