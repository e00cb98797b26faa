"""The K-split plans of the fused decode kernels (ops/cuda/fused_decode.py),
on the CPU: pure functions of the shapes and the card's SM count.

- tile_split_plan (QKV and out-projection, csrc/fused_decode.cu mma_tile):
  every split a whole number of ring stages, none empty, the grid filling
  the card's SMs wherever the K split allows it, and the same plan for a
  row alone as in a batch of up to 8 rows (a row's bits never depend on
  its batch);
- fc_split_plan (fc1 and fc2, accumulate_tile) pinned at its values;
- the plan's stage size is the kernel's.
"""

import math
import re

import pytest

from megatronapp_tpu_torch.models.presets import gpt2_125m, llama3_8b
from megatronapp_tpu_torch.ops.cuda import build as kbuild
from megatronapp_tpu_torch.ops.cuda import fused_decode as fd

H100_SMS = 132
CFGS = {"llama3_8b": llama3_8b(num_layers=1),
        "gpt2_125m": gpt2_125m(num_layers=1)}


def _shape(cfg, kernel):
    """(K, tiles) of a fused kernel: its contraction and 128-column tiles."""
    h, d, ffn = cfg.hidden_size, cfg.head_dim, cfg.ffn_hidden_size
    nq, nkv = cfg.num_attention_heads, cfg.num_query_groups
    gated = cfg.activation.value in ("swiglu", "geglu")
    return {"qkv": (h, (nq + 2 * nkv) * d // fd.TILE),
            "out_proj": (nq * d, h // fd.TILE),
            "mlp_fc1": (h, ffn // (fd.TILE // 2 if gated else fd.TILE)),
            "mlp_fc2": (ffn, h // fd.TILE)}[kernel]


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
@pytest.mark.parametrize("kernel", ["qkv", "out_proj"])
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
        for kernel in ("qkv", "out_proj"):
            k, tiles = _shape(cfg, kernel)
            for rows in (1, 8, 32, 64):
                blocks, one_stage_each = _check_tile_plan(k, tiles, rows, sms)
                assert blocks >= sms or one_stage_each


def test_tile_split_plan_is_the_same_for_a_row_alone():
    for cfg in CFGS.values():
        for kernel in ("qkv", "out_proj"):
            k, tiles = _shape(cfg, kernel)
            plans = {fd.tile_split_plan(r, k, tiles, H100_SMS)
                     for r in range(1, 9)}
            assert len(plans) == 1


# fc1 / fc2 keep their plan: (row block, row chunks, ksplit) at 132 SMs.
FC_PLANS = {
    ("llama3_8b", "mlp_fc1", 8): (8, 1, 2),
    ("llama3_8b", "mlp_fc1", 32): (32, 1, 2),
    ("llama3_8b", "mlp_fc1", 40): (32, 2, 1),
    ("llama3_8b", "mlp_fc2", 8): (8, 1, 9),
    ("llama3_8b", "mlp_fc2", 32): (32, 1, 9),
    ("llama3_8b", "mlp_fc2", 40): (32, 2, 5),
    ("gpt2_125m", "mlp_fc1", 8): (8, 1, 3),
    ("gpt2_125m", "mlp_fc1", 32): (32, 1, 3),
    ("gpt2_125m", "mlp_fc2", 8): (8, 1, 12),
    ("gpt2_125m", "mlp_fc2", 32): (32, 1, 12),
}


@pytest.mark.parametrize("model,kernel,rows", sorted(FC_PLANS))
def test_fc_split_plan_is_pinned(model, kernel, rows):
    k, tiles = _shape(CFGS[model], kernel)
    assert fd.fc_split_plan(rows, k, tiles, H100_SMS) \
        == FC_PLANS[(model, kernel, rows)]


def test_stage_size_is_the_kernels():
    with open(kbuild.source("fused_decode.cu")) as f:
        text = f.read()
    m = re.search(r"^constexpr int kStageK = (\d+);", text, re.M)
    assert m and int(m.group(1)) == fd.STAGE_K
