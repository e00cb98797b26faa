"""The port's flash attention and dense attention against the JAX package.

- The plain flash forward (out, LSE) and backward (dq, dk, dv for a
  given cotangent) against JAX's Pallas flash_attention in interpret
  mode through jax.vjp, with 32-row tiles so the JAX side walks several
  tiles: fp32, atol 1e-5 (values of order 1; the two sides sum in other
  orders), across D 64 (JAX's transposed kernels) and 128, MHA and GQA,
  causal and bidirectional, S = 96, packed segments and head_fold.
- The dense path against JAX's dot_product_attention.
- The attention_impl rule, and that a CUDA-less tensor never reaches the
  plain versions from the kernel path.
The kernels themselves run only on the card: their test is
``tests/test_torch_isolation.py::test_flash_kernels_match_plain_versions``
(jax-free, ``cuda`` marker), and chip_smoke.py holds them at the training
shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.config import transformer_config as jcfg
from megatronapp_tpu.ops import attention as jattn
from megatronapp_tpu.ops.pallas import flash_attention as jflash
from megatronapp_tpu_torch.config import transformer_config as tcfg
from megatronapp_tpu_torch.ops import attention as tattn
from megatronapp_tpu_torch.ops import flash_attention as tflash
from megatronapp_tpu_torch.ops.cuda import flash_attention as cuda_fa
from megatronapp_tpu_torch.transformer.attention import attention_impl

ATOL = 1e-5


def _inputs(seed, b, s, hq, hkv, d, segments=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    g = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    seg = (np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32)
           if segments else None)
    return q, k, v, g, seg


CASES = {
    # name: (b, s, hq, hkv, d, causal, segments, head_fold)
    "d64-mha-causal": (2, 96, 4, 4, 64, True, False, False),
    "d64-gqa-bidir": (1, 96, 4, 2, 64, False, False, False),
    "d128-gqa-causal": (1, 96, 4, 2, 128, True, False, False),
    "d128-mha-bidir": (1, 64, 2, 2, 128, False, False, False),
    "d64-gqa-segments": (2, 96, 4, 1, 64, True, True, False),
    "d128-segments-bidir": (1, 96, 2, 1, 128, False, True, False),
    "d64-head-fold-gqa": (1, 96, 4, 2, 64, True, False, True),
    "d64-head-fold-mha": (1, 64, 4, 4, 64, True, False, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_matches_jax_kernel(name):
    b, s, hq, hkv, d, causal, segments, fold = CASES[name]
    q, k, v, g, seg = _inputs(sum(map(ord, name)), b, s, hq, hkv, d,
                              segments)
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q_, k_, v_):
        return jflash.flash_attention(q_, k_, v_, causal=causal, block_q=32,
                                      block_kv=32, segment_ids=jseg,
                                      head_fold=fold)

    out_j, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(g))
    tseg = None if seg is None else torch.from_numpy(seg)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_t = tflash.flash_attention(tq, tk, tv, causal=causal,
                                   segment_ids=tseg, head_fold=fold)
    out_t.backward(torch.from_numpy(g))
    for got, want in ((out_t.detach(), out_j), (tq.grad, dq_j),
                      (tk.grad, dk_j), (tv.grad, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=ATOL)
    # The LSE of the plain forward against the TPU forward's.
    qt = jnp.swapaxes(jnp.asarray(q), 1, 2)
    kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (k, v))
    segs = None if seg is None else (jseg[:, :, None], jseg[:, None, :])
    _, lse_j = jflash._flash_forward(qt, kt, vt, 1.0 / d ** 0.5, causal,
                                     32, 32, segs=segs)
    _, lse_t = tflash.flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, segment_ids=tseg)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=ATOL, rtol=ATOL)


def test_plain_backward_is_the_gradient_of_dense_attention():
    """The autograd Function's backward (FA2 recipe from the LSE) equals
    torch autograd through dense attention, GQA, causal, with segments."""
    q, k, v, g, seg = _inputs(3, 2, 40, 6, 2, 64, segments=True)
    seg_t = torch.from_numpy(seg)
    grads = []
    for use_flash in (True, False):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                      for x in (q, k, v))
        if use_flash:
            out = tflash.flash_attention(tq, tk, tv, causal=True,
                                         segment_ids=seg_t)
        else:
            mask = seg_t[:, None, :, None] == seg_t[:, None, None, :]
            out = tattn.dot_product_attention(tq, tk, tv,
                                              attention_mask=mask)
        out.backward(torch.from_numpy(g))
        grads.append([out.detach(), tq.grad, tk.grad, tv.grad])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                   rtol=ATOL)


def test_bf16_plain_rounds_like_the_kernel():
    """On bf16 inputs the plain forward rounds the scaled q and P to bf16
    (as the kernels do): it differs from the fp32 computation by bf16
    rounding only, and its outputs are bf16 / fp32 LSE."""
    q, k, v, _, _ = _inputs(4, 1, 48, 4, 2, 64)
    tb = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    out_b, lse_b = tflash.flash_forward_plain(*tb, causal=True)
    out_f, lse_f = tflash.flash_forward_plain(*(t.float() for t in tb),
                                              causal=True)
    assert out_b.dtype == torch.bfloat16 and lse_b.dtype == torch.float32
    assert float((out_b.float() - out_f).abs().max()) < 0.05
    assert float((lse_b - lse_f).abs().max()) < 0.05


def test_bf16_plain_backward_rounds_like_the_kernel():
    """The plain dk/dv rounds p and ds to the input dtype before dv and dk,
    as the kernel rounds its tensor-core operands: on bf16 inputs dk and dv
    are the fp32 products of the bf16-rounded p and ds, and differ from the
    computation on fp32 copies of the inputs by bf16 rounding only; on fp32
    inputs the rounding is a no-op, so dk and dv are bit-identical to the
    fp32 products of p and ds (the TPU kernel's, flash_attention.py:965)."""
    b, s, hq, hkv, d = 1, 48, 4, 2, 64
    q, k, v, g, _ = _inputs(7, b, s, hq, hkv, d)

    def group_sum(x, y):   # [B, Hq, Sq, Skv] . [B, Sq, Hq, D] → [B, Skv, Hkv, D]
        out = torch.einsum("bhqk,bqhd->bkhd", x, y)
        return out.reshape(b, s, hkv, hq // hkv, d).sum(dim=3)

    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        tq, tk, tv, tg = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
        if dtype == torch.float32:   # the bf16 inputs' values, in fp32
            tq, tk, tv, tg = (x.bfloat16().float() for x in (tq, tk, tv, tg))
        out, lse = cuda_fa.flash_forward_plain(tq, tk, tv, causal=True)
        args = (tq, tk, tv, tg, lse, cuda_fa.attention_delta(out, tg), True)
        dk, dv = cuda_fa.flash_bwd_dkv_plain(*args)
        p, ds, qs, _ = cuda_fa._plain_ds(*args, None, None)
        assert dk.dtype == dv.dtype == dtype
        if dtype == torch.bfloat16:
            assert torch.equal(dk, group_sum(ds.bfloat16().float(),
                                             qs).bfloat16())
            assert torch.equal(dv, group_sum(p.bfloat16().float(),
                                             tg.float()).bfloat16())
        else:
            assert torch.equal(dk, group_sum(ds, qs))
            assert torch.equal(dv, group_sum(p, tg))
        grads[dtype] = (dk, dv)
    for got, want in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert float((got.float() - want).norm() / want.norm()) < 0.02


@pytest.mark.parametrize("masked", [False, True])
def test_dense_attention_matches_jax(masked):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 12, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 12, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 12, 2, 32)).astype(np.float32)
    mask = rng.random((2, 1, 12, 12)) > 0.3 if masked else None
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attention_mask=None if mask is None else jnp.asarray(mask),
        q_offset=0)
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attention_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    bidir = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask_type=jcfg.AttnMaskType.bidirectional)
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask_type=tcfg.AttnMaskType.bidirectional)
    np.testing.assert_allclose(got.numpy(), np.asarray(bidir), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("impl,dev,s,heads,want", [
    ("auto", "cuda", 2048, 12, "pallas"),        # s >= flash_min_seq
    ("auto", "cuda", 1024, 12, "reference"),     # short, 0.38 GiB dense
    ("auto", "cuda", 1024, 192, "pallas"),       # dense scores > 1 GiB
    ("auto", "cpu", 4096, 32, "reference"),      # no card: dense
    ("pallas", "cpu", 64, 4, "pallas"),
    ("reference", "cuda", 8192, 32, "reference"),
])
def test_attention_impl_rule(impl, dev, s, heads, want):
    cfg = tcfg.TransformerConfig(hidden_size=64 * heads,
                                 num_attention_heads=heads,
                                 attention_impl=impl)
    assert attention_impl(cfg, 1, heads, s, dev) == want


def test_bad_attention_impl_raises():
    cfg = tcfg.TransformerConfig(attention_impl="cudnn")
    with pytest.raises(ValueError, match="attention_impl"):
        attention_impl(cfg, 1, 8, 128, "cuda")


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(cuda_fa, "flash_forward_plain", no_plain)
    monkeypatch.setattr(cuda_fa, "flash_backward_plain", no_plain)
    q = torch.empty(1, 64, 4, 64, device="meta")
    kv = torch.empty(1, 64, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fa.flash_forward(q, kv, kv)
    lse = torch.empty(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fa.flash_backward(q, kv, kv, q, lse, q)
