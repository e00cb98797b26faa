"""The segmented LoRA delta as the port's kernels split it, shrink t = x @ A
then expand t @ B, against the JAX package's, on the CPU.

- ``lora_shrink_plain``, ``lora_expand_plain`` and
  ``lora_shrink_split_plain`` (the shrink kernel's order of summation: k
  splits of a size read from din and the rank alone, ring stages, the
  parts of a stage, added in order) against
  ``kernel_gen.lora_segmented_delta``
  (Pallas in interpret mode, as tests/test_lora.py runs it) and
  ``lora_delta_reference``: every element within 1e-5 of max(|element|,
  its row's RMS), over ranks 1, 8 and 32, mixed segments with NULL rows
  (exactly 0), one adapter, no adapter, a ragged chunk's slot ids repeated
  over S, and k ranges that are not a multiple of the split or the stage;
- the mirror gives a row's t the same bits alone as in a mixed batch;
- the normalised shrink input (``shrink_input_plain`` with the fused
  wrappers' ``lora_norm``) is bit for bit the input that
  ``fused_qkv_plain`` and ``fused_mlp_fc1_plain`` feed their product;
- the shared shrink of q and kv (``apply_lora_deltas``) leaves the CPU
  numbers of one delta a target unchanged;
- the new entry points refuse tensors off the CPU instead of reaching the
  plain versions, and the kernels' alignment limit is named.

Inputs are made with numpy from seeds and handed to both sides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_decode import _weights
from test_torch_lora import _lora_pair

from megatronapp_tpu.ops.pallas import kernel_gen as kg
from megatronapp_tpu_torch.config.transformer_config import NormKind
from megatronapp_tpu_torch.ops import lora as tlo
from megatronapp_tpu_torch.ops.cuda import fused_decode as cuda_fd
from megatronapp_tpu_torch.ops.cuda import lora as cl

TOL = 1e-5
SLOTS, DOUT = 5, 96
MIXES = {
    "mixed_with_null": ([1, 1, 2, 3, 4, 2, 0, 1], 1),
    "one_adapter": ([3] * 8, 1),
    "all_null": ([0] * 8, 1),
    "ragged_repeat_over_s": ([2, 0, 1], 4),     # 3 slots x S 4 token rows
}


def _rel_err(got, want):
    """Max of |got - want| over max(|want element|, its row's RMS)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt((want ** 2).mean(axis=-1, keepdims=True))
    scale = np.maximum(np.maximum(np.abs(want), rms), 1e-30)
    return float((np.abs(got - want) / scale).max())


def _banks(rng, din, rank):
    a = (rng.standard_normal((SLOTS, din, rank)) / np.sqrt(din)
         ).astype(np.float32)
    b = (rng.standard_normal((SLOTS, rank, DOUT)) * 0.2).astype(np.float32)
    a[0] = b[0] = 0.0                              # the NULL slot
    return a, b


@pytest.mark.parametrize("rank", [1, 8, 32])
@pytest.mark.parametrize("din,kper", [(200, None), (400, None), (72, 16)])
def test_shrink_expand_and_split_order_match_jax(rank, din, kper):
    rng = np.random.default_rng(rank * 100 + din)
    a, b = _banks(rng, din, rank)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert kg.lora_kernel_ineligible_reason(din, DOUT, rank, 12) is None
    assert tlo.lora_kernel_ineligible_reason(din, DOUT, rank, 12) is None
    for name, (slots, s) in MIXES.items():
        x = rng.standard_normal((len(slots), s, din)).astype(np.float32)
        ra = jnp.asarray(slots, jnp.int32)
        want_seg = kg._lora_rows_delta(jnp.asarray(x), (jnp.asarray(a),
                                                        jnp.asarray(b)), ra)
        want_seg = np.asarray(want_seg).reshape(-1, DOUT)
        ids = np.repeat(slots, s)
        flat = x.reshape(-1, din)
        want_ref = np.asarray(kg.lora_delta_reference(
            jnp.asarray(flat), jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(ids, jnp.int32)))
        rows = tlo.LoraRows(slots, "cpu", repeat=s)
        tx = torch.from_numpy(flat)
        t = tlo.lora_shrink_plain(tx, ta, rows)
        t_split = cl.lora_shrink_split_plain(tx, ta, ids, kper)
        assert t.shape == t_split.shape == (len(ids), rank)
        assert _rel_err(t_split, t) <= TOL, name
        for tt in (t, t_split):
            got = tlo.lora_expand_plain(tt, tb, rows)
            assert got.dtype == torch.float32
            for want in (want_seg, want_ref):
                assert _rel_err(got, want) <= TOL, name
            null = ids == 0
            assert not tt[null].any() and not got[null].any(), name
        assert torch.equal(tlo.lora_expand_plain(t, tb, rows),
                           tlo.lora_delta_plain(tx, ta, tb, rows))


@pytest.mark.parametrize("rank", [1, 8, 32])
def test_split_order_gives_a_row_the_same_bits_alone(rank):
    """The mirror sums each row from its own input and factors, on bf16
    inputs as the kernel takes them, with and without the layer norm
    (layernorm with a bias)."""
    rng = np.random.default_rng(rank)
    din = 136                                    # splits of 16: 8.5
    a, _ = _banks(rng, din, rank)
    ta = torch.from_numpy(a)
    ids = [1, 0, 2, 3, 4, 2, 0, 1, 3, 3]
    x = torch.from_numpy(rng.standard_normal((len(ids), din)).astype(
        np.float32)).to(torch.bfloat16)
    norm = (NormKind.layernorm,
            torch.from_numpy(1 + 0.1 * rng.standard_normal(din)).float(),
            torch.from_numpy(0.1 * rng.standard_normal(din)).float(), 1e-5)
    for nm in (None, norm):
        batch = cl.lora_shrink_split_plain(x, ta, ids, 16, nm)
        for r in range(len(ids)):
            alone = cl.lora_shrink_split_plain(x[r:r + 1], ta, ids[r:r + 1],
                                               16, nm)
            assert torch.equal(alone[0], batch[r])
        assert _rel_err(batch, tlo.lora_shrink_plain(
            cl.shrink_input_plain(x, nm), ta, torch.tensor(ids))) <= TOL


@pytest.mark.parametrize("config", ["llama", "gpt2"])
@pytest.mark.parametrize("kernel", ["qkv", "mlp_fc1"])
def test_shrink_input_is_the_fused_products_input(kernel, config,
                                                  monkeypatch):
    """What the fused plain versions feed their LoRA delta (the normed
    bf16 input of their product) equals the shrink's input with the norm
    the wrappers hand the shrink kernel, bit for bit (rmsnorm; layernorm
    with a bias)."""
    _, tc, _, tp = _weights(config)
    tc = dataclasses.replace(tc, compute_dtype=torch.bfloat16)
    p = tp["layers"][0]
    port, _ = _lora_pair(tc, 13)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(5, tc.hidden_size)).astype(np.float32)).to(torch.bfloat16)
    seen = []
    real = cuda_fd._lora_epilogue

    def spy(xv, lora, target, dtype):
        seen.append(xv)
        return real(xv, lora, target, dtype)

    monkeypatch.setattr(cuda_fd, "_lora_epilogue", spy)
    if kernel == "qkv":
        cuda_fd.fused_qkv_plain(x, p, tc, lora=port)
    else:
        cuda_fd.fused_mlp_fc1_plain(x, p, tc, lora=port)
    xin = cl.shrink_input_plain(x, cuda_fd.lora_norm(kernel, p, tc))
    assert seen and all(v.dtype == torch.bfloat16 and torch.equal(v, xin)
                        for v in seen)
    targets = cuda_fd.LORA_TARGETS[kernel][0]
    assert len(seen) == len(targets)


def test_shared_shrink_deltas_equal_per_target_on_cpu():
    _, tc, _, _ = _weights("llama")
    port, _ = _lora_pair(tc, 14)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, tc.hidden_size)).astype(
        np.float32))
    q, kv = (torch.from_numpy(rng.normal(
        size=(5, port["banks"][t][1].shape[-1])).astype(np.float32))
        for t in ("q_kernel", "kv_kernel"))
    got = tlo.apply_lora_deltas((q, kv), x, port, ("q_kernel", "kv_kernel"))
    want = (tlo.apply_lora_delta(q, x, port, "q_kernel"),
            tlo.apply_lora_delta(kv, x, port, "kv_kernel"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], q)
    # A target the dict does not carry leaves its output as it was.
    only_q = {**port, "banks": {"q_kernel": port["banks"]["q_kernel"]}}
    got = tlo.apply_lora_deltas((q, kv), x, only_q,
                                ("q_kernel", "kv_kernel"))
    assert torch.equal(got[0], want[0]) and got[1] is kv
    assert tlo.apply_lora_deltas((q, kv), x, None, ("q_kernel",)) == (q, kv)


def test_lora_rows_count_the_largest_segment():
    assert tlo.LoraRows([1, 1, 2, 0, 1], "cpu").max_seg_rows == 3
    assert tlo.LoraRows([4, 0], "cpu", repeat=32).max_seg_rows == 32
    assert tlo.LoraRows([0] * 9, "cpu").max_seg_rows == 9


def test_shrink_and_expand_refuse_tensors_off_the_cpu(monkeypatch):
    """Meta tensors go to the kernels' wrappers, which raise, never to the
    plain versions."""
    def no_plain(*a, **k):
        raise AssertionError("plain version reached")

    for fn in ("lora_delta_plain", "lora_shrink_plain", "lora_expand_plain"):
        monkeypatch.setattr(tlo, fn, no_plain)
    x = torch.empty(4, 64, dtype=torch.bfloat16, device="meta")
    bank = torch.empty(3, 64, 4, device="meta")
    segs = tlo.LoraRows(np.zeros(4, np.int32), "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlo.lora_deltas(x, [(bank, bank), (bank, bank)], segs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cl.lora_shrink(x, (bank,), segs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cl.lora_expand(torch.empty(4, 4, device="meta"), bank, segs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlo.apply_lora_deltas((x, x), x, {"row_adapter": segs, "banks": {
            "q_kernel": (bank, bank)}}, ("q_kernel", "kv_kernel"))


def test_kernel_limits_name_the_alignment():
    assert "alignment" in tlo.lora_kernel_ineligible_reason(4100, 4096, 8, 8)
    assert "alignment" in tlo.lora_kernel_ineligible_reason(4096, 4098, 8, 8)
    assert tlo.lora_kernel_ineligible_reason(4096, 14336, 8, 8) is None
    # The split reads din and the rank alone: llama3-8b's din 4096 and
    # fc2's 14336 at rank 8, at most MAX_SPLITS splits.
    assert cl.shrink_k_per_split(8, 4096) == 256
    assert cl.shrink_k_per_split(8, 14336) == 512
    assert cl.shrink_k_per_split(32, 200) == 64
    for rank in (1, 3, 8, 32):
        for din in (72, 4096, 14336, 28680):
            kper = cl.shrink_k_per_split(rank, din)
            assert kper % 8 == 0 and -(-din // kper) <= cl.MAX_SPLITS
