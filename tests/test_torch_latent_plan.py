"""The weighted-sum kernel's split plan (row 9 of the tensor-parallel MLA
path, ``ops/cuda/latent_tp.py:wsum_split_plan``) on the CPU:

- the splits cover every token of the table exactly once, in whole
  16-token mma steps (whole 32-token ring stages);
- at the shapes ``chip_smoke.py``'s tp_times launches (one rank's 256
  latent columns: decode B 8 × 32 rows, a chunk B 1 × 1024 rows, 1024- and
  2048-position tables) the blocks come to at most one wave of 132 SMs;
- the plan reads shapes alone;
- the split kernel's arithmetic, mirrored here (a slot's live splits
  min(splits, ceil(tv / split_tokens)), split s summing tokens [s0,
  min(s0 + split_tokens, tv)) with tv the tokens of its valid blocks, the
  expansion adding the live splits' partials in split order), equals the
  unsplit ``latent_block_wsum_plain`` (1e-6 of the max |element|: fp32
  sums of the same terms in another order) on bf16, int8 and fp8 pools, at
  the kv lengths ``chip_smoke.py``'s tp_kernels takes at the plan's edges:
  splitting the tokens keeps the function, and a live split dropped or a
  token counted twice would not.
"""

import inspect

import numpy as np
import pytest
import torch

from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
from megatronapp_tpu_torch.ops.paged_attention import quantize_kv_rows

SMS = 132   # an H100 SXM's SMs

# (batch, rows, tokens = MB·bs, latent columns)
PLAN_SHAPES = {
    "decode_b8_kv1024": (8, 32, 1024, 256),
    "chunk_b1_sq32_kv1024": (1, 1024, 1024, 256),
    "decode_b8_table2048": (8, 32, 2048, 256),
    "chunk_b1_table2048": (1, 1024, 2048, 256),
    "chunk_b3_table2048": (3, 1024, 2048, 256),
    "rows96_table2048": (1, 96, 2048, 256),
    "whole_latent_768": (2, 32, 1000, 768),
    "short_table": (3, 64, 128, 256),
    "odd_tokens": (2, 8, 12, 16),
    "many_units": (64, 1024, 512, 256),
}
TP_TIMES_SHAPES = ("decode_b8_kv1024", "chunk_b1_sq32_kv1024",
                   "decode_b8_table2048", "chunk_b1_table2048")


def _blocks(plan, batch, rows, dl):
    return plan.splits * batch * -(-rows // plan.row_tile) \
        * -(-dl // lt.WSUM_COLS)


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_split_plan_covers_every_token_once(name):
    batch, rows, tokens, dl = PLAN_SHAPES[name]
    plan = lt.wsum_split_plan(batch, rows, tokens, dl, SMS)
    assert plan.row_tile in lt.WSUM_ROW_TILES
    assert plan.split_tokens % lt.WSUM_STAGE == 0
    assert plan.split_tokens % 16 == 0
    assert plan.splits >= 1
    owner = np.full(tokens, -1)
    for s in range(plan.splits):
        lo, hi = s * plan.split_tokens, min(tokens, (s + 1) *
                                            plan.split_tokens)
        assert lo < hi, f"split {s} holds no token of the table"
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()
    # Every split is one or more whole 16-token steps, the last one cut
    # only by the end of the table.
    assert (np.diff(owner) >= 0).all()


@pytest.mark.parametrize("name", TP_TIMES_SHAPES)
def test_split_plan_fills_one_wave(name):
    batch, rows, tokens, dl = PLAN_SHAPES[name]
    plan = lt.wsum_split_plan(batch, rows, tokens, dl, SMS)
    blocks = _blocks(plan, batch, rows, dl)
    assert SMS // 2 < blocks <= SMS, (plan, blocks)
    # A wave's worth of units is never split.
    many = lt.wsum_split_plan(*PLAN_SHAPES["many_units"], SMS)
    assert many.splits == 1 and many.split_tokens >= 512


def test_split_plan_reads_shapes_alone():
    params = list(inspect.signature(lt.wsum_split_plan).parameters)
    assert params == ["batch", "rows", "tokens", "dl", "sms"]
    for shape in PLAN_SHAPES.values():
        plan = lt.wsum_split_plan(*shape, SMS)
        assert plan == lt.wsum_split_plan(*shape, SMS)
        assert all(isinstance(v, int) for v in plan)
        assert plan.splits <= lt.MAX_SPLITS
    # Decode's 32 rows take one row tile; chunks take 64-row tiles.
    assert lt.wsum_split_plan(8, 32, 1024, 256, SMS).row_tile == 32
    assert lt.wsum_split_plan(1, 1024, 1024, 256, SMS).row_tile == 64


def _wsum_inputs(kind, seed, b, nq, s_q, tokens, lens, dl=256, dv=16,
                 bs=16):
    """Random inputs of row 9 for `b` slots at kv `lens`: nq heads, s_q
    query positions, `dl` latent columns, block `bs`, a table of `tokens`
    positions drawn without repeats from a pool with spare blocks."""
    gen = torch.Generator().manual_seed(seed)
    rows, mb = nq * s_q, tokens // bs
    nb = b * mb + 3
    table = torch.randperm(nb, generator=gen)[:b * mb].reshape(b, mb).to(
        torch.int32)
    rows_f = torch.randn(nb, bs, dl, generator=gen)
    if kind == "bf16":
        pages, scales = rows_f.to(torch.bfloat16), None
    else:
        dt = torch.int8 if kind == "int8" else torch.float8_e4m3fn
        pages, scales = quantize_kv_rows(rows_f, dt)
    p = torch.softmax(torch.randn(b, rows, tokens, generator=gen), -1)
    w_v = (torch.randn(dl, nq, dv, generator=gen) / 16).to(torch.bfloat16)
    lens = torch.tensor(lens, dtype=torch.int32)
    return p, pages, table, lens, w_v, scales


def _kernel_splits(plan, kv_len, bs, mb):
    """The token ranges the split kernel sums for a slot at `kv_len`, in
    split order (csrc/latent_tp.cu: valid_tokens, live_splits, s1)."""
    tv = min(-(-max(kv_len, 0) // bs), mb) * bs
    live = min(plan.splits, -(-tv // plan.split_tokens))
    out = []
    for split in range(live):
        s0 = split * plan.split_tokens
        out.append((s0, min(s0 + plan.split_tokens, tv)))
    return out


def _wsum_by_kernel_splits(plan, p, pages, table, lens, w_v, scales):
    """Row 9 as the two launches compute it: each live split's fp32
    partial u over its token range, the partials added in split order,
    then one expansion through w_v."""
    b, rows, tokens = p.shape
    bs, mb = pages.shape[1], table.shape[1]
    nq, dv = w_v.shape[1], w_v.shape[2]
    lat = lt._gather_rows(pages, table, scales)
    u = torch.zeros(b, rows, pages.shape[2])
    for slot in range(b):
        ranges = _kernel_splits(plan, int(lens[slot]), bs, mb)
        for (s0, s1), nxt in zip(ranges, ranges[1:] + [(None, None)]):
            assert s0 < s1, "a live split holds no token"
            assert nxt[0] is None or nxt[0] == s1, "splits not contiguous"
            u[slot] = u[slot] + p[slot, :, s0:s1] @ lat[slot, s0:s1]
    out = torch.einsum("bsnk,knd->bsnd", u.reshape(b, rows // nq, nq, -1),
                       w_v.float())
    return out.reshape(b, rows, dv)


def _edge_lens(mode, st, tokens):
    """tp_kernels' kv lengths at the plan's edges (chip_smoke.py)."""
    return {"decode_split_edges": [st + 1, st, 2 * st, 2 * st - 1,
                                   3 * st + 1, 4 * st, tokens, 16],
            "decode_kv1_beside_full": [1, 1024, 1, 1, 1024, 1, tokens, 1],
            "chunk_split_edges": [st + 1, 2 * st]}[mode]


# mode: (batch, heads, query positions, table positions)
EDGE_CASES = {"decode_split_edges": (8, 32, 1, 2048),
              "decode_kv1_beside_full": (8, 32, 1, 2048),
              "chunk_split_edges": (2, 32, 32, 2048)}


@pytest.mark.parametrize("mode", list(EDGE_CASES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_kernel_split_arithmetic_at_smoke_edges(kind, mode):
    b, nq, s_q, tokens = EDGE_CASES[mode]
    plan = lt.wsum_split_plan(b, nq * s_q, tokens, 256, SMS)
    assert plan.splits > 2
    lens = _edge_lens(mode, plan.split_tokens, tokens)
    p, pages, table, lens, w_v, scales = _wsum_inputs(
        kind, 15, b, nq, s_q, tokens, lens)
    want = lt.latent_block_wsum_plain(p, pages, table, lens, w_v, scales)
    got = _wsum_by_kernel_splits(plan, p, pages, table, lens, w_v, scales)
    scale = want.abs().max()
    assert scale > 0
    assert float((got - want).abs().max() / scale) <= 1e-6


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_plain_split_by_split_equals_unsplit(kind):
    """A slot at kv 1, one ending one token into a split, one ending on a
    split's edge, one at the table's end; 64 rows, a 512-position table."""
    b, nq, s_q, tokens = 4, 32, 2, 512
    plan = lt.wsum_split_plan(b, nq * s_q, tokens, 256, SMS)
    assert plan.splits > 2
    st = plan.split_tokens
    p, pages, table, lens, w_v, scales = _wsum_inputs(
        kind, 14, b, nq, s_q, tokens, [1, st + 1, 2 * st, tokens])
    want = lt.latent_block_wsum_plain(p, pages, table, lens, w_v, scales)
    got = _wsum_by_kernel_splits(plan, p, pages, table, lens, w_v, scales)
    scale = want.abs().max()
    assert scale > 0
    assert float((got - want).abs().max() / scale) <= 1e-6
    # The plain version itself, split by split in the plan's order.
    pos = torch.arange(tokens)
    summed = torch.zeros_like(want)
    for s in range(plan.splits):
        mine = (pos >= s * st) & (pos < (s + 1) * st)
        summed = summed + lt.latent_block_wsum_plain(
            torch.where(mine, p, torch.zeros(())), pages, table, lens, w_v,
            scales)
    assert float((summed - want).abs().max() / scale) <= 1e-6


def test_plan_constants_are_the_sources():
    with open(lt.SOURCE) as f:
        src = f.read()
    assert f"constexpr int kWsumTK = {lt.WSUM_STAGE};" in src
    assert f"constexpr int kWsumCols = {lt.WSUM_COLS};" in src
    assert f"constexpr int kMaxWidth = {lt.MAX_WIDTH};" in src
    rows = " ".join(f"X({r})" for r in lt.WSUM_ROW_TILES)
    assert f"#define LATENT_WSUM_ROW_TILES(X) {rows}" in src
