"""The K-split plans of the fused decode kernels (ops/cuda/fused_decode.py),
on the CPU: pure functions of the shapes and the card's SM count.

- tile_split_plan (every fused kernel, csrc/fused_decode.cu mma_tile):
  every split a whole number of ring stages, none empty, the grid filling
  the card's SMs wherever the K split allows it, and the same plan for a
  row alone as in a batch of up to 8 rows (a row's bits never depend on
  its batch);
- a CPU mirror of the core's sum order for fc2 at llama3-8b's K (fp32
  sums over each split's whole stages, the partials added in split order,
  bf16 rounding at the kernel's points) within chip_smoke.py's FUSED_TOL
  of the plain version;
- the plan's stage size and the row block that shares norm statistics
  are the kernel's.
"""

import math
import re

import numpy as np
import pytest
import torch

from megatronapp_tpu_torch.models.presets import gpt2_125m, llama3_8b
from megatronapp_tpu_torch.ops.cuda import build as kbuild
from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
from megatronapp_tpu_torch.tools.flash_probe import fused_shape as _shape

H100_SMS = 132
CFGS = {"llama3_8b": llama3_8b(num_layers=1),
        "gpt2_125m": gpt2_125m(num_layers=1)}


def _check_tile_plan(k, tiles, rows, sms):
    rb, chunks, ksplit = fd.tile_split_plan(rows, k, tiles, sms)
    assert (rb, chunks) == ((8, 1) if rows <= 8 else (32, math.ceil(rows / 32)))
    per = fd.split_k(k, ksplit)
    stages = math.ceil(k / fd.STAGE_K)
    assert per % fd.STAGE_K == 0, "a split holds whole ring stages"
    assert (ksplit - 1) * per < k <= ksplit * per, "no empty split, all of K"
    assert 1 <= ksplit <= stages
    return tiles * chunks * ksplit, ksplit == stages


@pytest.mark.parametrize("rows", [1, 5, 8, 32, 40])
@pytest.mark.parametrize("kernel", fd.KERNELS)
@pytest.mark.parametrize("model", sorted(CFGS))
def test_tile_split_plan_fills_the_card_in_whole_stages(model, kernel, rows):
    k, tiles = _shape(CFGS[model], kernel)
    blocks, one_stage_each = _check_tile_plan(k, tiles, rows, H100_SMS)
    if model == "llama3_8b":
        assert blocks >= H100_SMS
    else:   # gpt2-125m's out-projection: 6 tiles over K 768
        assert blocks >= H100_SMS or one_stage_each


@pytest.mark.parametrize("sms", [1, 8, 78, 114, 132, 264])
def test_tile_split_plan_holds_for_any_sm_count(sms):
    for cfg in CFGS.values():
        for kernel in fd.KERNELS:
            k, tiles = _shape(cfg, kernel)
            for rows in (1, 8, 32, 64):
                blocks, one_stage_each = _check_tile_plan(k, tiles, rows, sms)
                assert blocks >= sms or one_stage_each


def test_tile_split_plan_is_the_same_for_a_row_alone():
    for cfg in CFGS.values():
        for kernel in fd.KERNELS:
            k, tiles = _shape(cfg, kernel)
            plans = {fd.tile_split_plan(r, k, tiles, H100_SMS)
                     for r in range(1, 9)}
            assert len(plans) == 1


# chip_smoke.py's FUSED_TOL: a kernel element against its plain version,
# over max(|plain element|, the RMS of its plain row).
FUSED_TOL = 0.06


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


def _fc2_mirror(y, w, bias, res, ksplit):
    """fused_mlp_fc2_kernel's arithmetic on the CPU: each split sums its
    whole ring stages in fp32 (stage by stage, in k order), the partials
    are added in split order 0..ksplit-1, then bf16(sum), + bf16(bias)
    rounded, + the residual rounded (residual_epilogue)."""
    k = y.shape[1]
    per = fd.split_k(k, ksplit)
    y32, w32 = y.float().numpy(), w.float().numpy()
    total = None
    for sp in range(ksplit):
        acc = np.zeros((y.shape[0], w.shape[1]), np.float32)
        for k0 in range(sp * per, min(k, (sp + 1) * per), fd.STAGE_K):
            k1 = min(k, k0 + fd.STAGE_K)
            acc += y32[:, k0:k1] @ w32[k0:k1]
        total = acc if total is None else total + acc
    v = torch.from_numpy(total).to(torch.bfloat16)
    v = (v.float() + bias.float()).to(torch.bfloat16)
    return (res.float() + v.float()).to(torch.bfloat16)


@pytest.mark.parametrize("plan_tiles", [2, 32])
@pytest.mark.parametrize("rows", [8, 32])
def test_fc2_split_sum_order_mirror_holds_to_the_plain_version(rows,
                                                              plan_tiles):
    """K 14336 (llama3-8b's ffn), 256 output columns; the split plan of a
    256-column launch (2 tiles: 112 one-stage splits) and of llama3-8b's
    4096 columns (32 tiles: 8 splits of 14 stages)."""
    k, n = llama3_8b().ffn_hidden_size, 256
    cfg = llama3_8b(num_layers=1, hidden_size=n, num_attention_heads=2,
                    num_query_groups=2, ffn_hidden_size=k,
                    add_bias_linear=True)
    rng = np.random.default_rng(1300 + rows + plan_tiles)
    y = _bf16(rng.standard_normal((rows, k)))
    w = _bf16(rng.standard_normal((k, n)) / math.sqrt(k))
    bias = _bf16(0.1 * rng.standard_normal(n))
    res = _bf16(rng.standard_normal((rows, n)))
    p = {"mlp": {"fc2_kernel": w, "fc2_bias": bias}}
    _, _, ksplit = fd.tile_split_plan(rows, k, plan_tiles, H100_SMS)
    assert ksplit == {2: 112, 32: 8}[plan_tiles]
    got = _fc2_mirror(y, w, bias, res, ksplit).float()
    want = fd.fused_mlp_fc2_plain(y, res, p, cfg).float()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rel = ((got - want).abs() / torch.maximum(want.abs(), rms)).max()
    assert float(rel) <= FUSED_TOL


def test_stage_size_is_the_kernels():
    with open(kbuild.source("fused_decode.cu")) as f:
        text = f.read()
    m = re.search(r"^constexpr int kStageK = (\d+);", text, re.M)
    assert m and int(m.group(1)) == fd.STAGE_K


def test_shared_statistics_row_block_is_the_kernels():
    with open(kbuild.source("fused_decode.cu")) as f:
        text = f.read()
    m = re.search(r"^constexpr int kSharedStatsRb = (\d+);", text, re.M)
    assert m and int(m.group(1)) == fd.SHARED_STATS_RB
