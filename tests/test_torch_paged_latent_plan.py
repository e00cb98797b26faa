"""The MLA latent kernel's split plan (row 7,
``ops/cuda/paged_latent.py:latent_split_plan``) and its split arithmetic
on the CPU:

- the splits cover every position of the table exactly once, in whole
  ring stages;
- at the shapes ``chip_smoke.py`` times (decode B 8 × 32 rows, a chunk B 1
  × 1024 rows; 1024- and 2048-position tables) the blocks come to about
  one wave of 132 SMs, with at most 16 splits;
- the plan reads shapes alone, and its constants (and the combine's
  workspace shape) are the source's;
- ``paged_latent_split_partials_plain`` (the split kernel's arithmetic:
  per-split (acc, m, l) by an online softmax over ring stages, Q rounded
  as the kernel rounds it, P in the kernel's bf16 terms with the latent
  row scale folded in), merged in split order
  (``merge_split_partials``) and expanded through w_v, equals
  ``paged_attention_latent_plain`` within 1e-5 of the max |element| on
  bf16, int8 and fp8 pools (fp32 sums of the same terms in another order,
  ~1e-7, beside P's terms, ~1e-6), and JAX's
  ``kernel_gen.paged_attention_latent`` in interpret mode within
  ``tests/test_torch_mla.py``'s fp32 tolerance (2e-5): at kv lengths on
  the plan's edges (1, one position past a split, a split's end, the
  table's end, kv 1 beside a full slot) and in ragged mode with a ragged
  tail and rows past q_lens. Splitting the positions keeps the function,
  and a live split dropped or a position counted twice would not.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatronapp_tpu.ops.pallas import kernel_gen as jkg
from megatronapp_tpu.ops.pallas import paged_attention as jpa
from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
from megatronapp_tpu_torch.ops.cuda.paged_attention import (
    merge_split_partials,
)

SMS = 132   # an H100 SXM's SMs
SCALE = 1.0 / (16 + 16) ** 0.5
JAX_TOL = dict(atol=2e-5, rtol=2e-5)   # tests/test_torch_mla.py TOL["fp32"]
MIRROR_TOL = 1e-5

# (batch, rows = S_q × nq, tokens = MB·bs, klat)
PLAN_SHAPES = {
    "decode_b8_kv1024": (8, 32, 1024, 512),
    "chunk_b1_sq32_kv1024": (1, 1024, 1024, 512),
    "decode_b8_table2048": (8, 32, 2048, 512),
    "chunk_b1_table2048": (1, 1024, 2048, 512),
    "chunk_b3_table2048": (3, 1024, 2048, 512),
    "wide_latent_624": (2, 64, 1000, 624),
    "reference_model": (2, 4, 48, 128),
    "short_table": (3, 64, 128, 512),
    "odd_tokens": (2, 8, 12, 16),
    "many_units": (200, 32, 512, 512),
}
TIMED_SHAPES = ("decode_b8_kv1024", "chunk_b1_sq32_kv1024",
                "decode_b8_table2048", "chunk_b1_table2048")


def _blocks(plan, batch, rows):
    return plan.splits * batch * -(-rows // plan.row_tile)


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_split_plan_covers_every_position_once(name):
    batch, rows, tokens, klat = PLAN_SHAPES[name]
    plan = pl.latent_split_plan(batch, rows, tokens, klat, SMS)
    assert plan.row_tile in pl.STAGE_TOKENS
    assert plan.split_tokens % pl.STAGE_TOKENS[plan.row_tile] == 0
    assert 1 <= plan.splits <= pl.MAX_SPLITS
    owner = np.full(tokens, -1)
    for s in range(plan.splits):
        lo = s * plan.split_tokens
        hi = min(tokens, lo + plan.split_tokens)
        assert lo < hi, f"split {s} holds no position of the table"
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all() and (np.diff(owner) >= 0).all()
    if klat > pl.WIDE_TILE_MAX_LATENT:
        assert plan.row_tile == 32


@pytest.mark.parametrize("name", TIMED_SHAPES)
def test_split_plan_fills_one_wave(name):
    batch, rows, tokens, klat = PLAN_SHAPES[name]
    plan = pl.latent_split_plan(batch, rows, tokens, klat, SMS)
    assert SMS // 2 < _blocks(plan, batch, rows) <= SMS, plan
    assert plan.splits <= pl.MAX_SPLITS
    # Decode: a slot's 32 heads are one tile, 16 splits; chunks: 64-row
    # tiles, 8 splits.
    assert (plan.row_tile, plan.splits) == (
        (32, 16) if rows == 32 else (64, 8))
    # A wave's worth of tiles is never split.
    many = pl.latent_split_plan(*PLAN_SHAPES["many_units"], SMS)
    assert many.splits == 1 and many.split_tokens >= 512


def test_split_plan_reads_shapes_alone():
    params = list(inspect.signature(pl.latent_split_plan).parameters)
    assert params == ["batch", "rows", "tokens", "klat", "sms"]
    for shape in PLAN_SHAPES.values():
        plan = pl.latent_split_plan(*shape, SMS)
        assert plan == pl.latent_split_plan(*shape, SMS)
        assert all(isinstance(v, int) for v in plan)


def test_plan_constants_are_the_sources():
    with open(pl.SOURCE) as f:
        src = f.read()
    assert f"constexpr int kMaxWidth = {pl.MAX_WIDTH};" in src
    assert f"constexpr int kMaxSplits = {pl.MAX_SPLITS};" in src
    assert f"constexpr int kPTerms = {pl.P_TERMS};" in src
    tiles = re.search(r"constexpr Tile kTiles\[3\] = \{(.*)\};", src)
    assert tiles, "kTiles not found"
    rows = [tuple(int(v) for v in t.split(","))
            for t in re.findall(r"\{([\d, ]+)\}", tiles.group(1))]
    # rows, stage tokens, warps, most latent columns a warp (8 warps a
    # row group), ring stages: [0] 32 rows to klat 512, [1] 32 rows past
    # it, [2] 64 rows.
    assert [r for r, *_ in rows] == [32, 32, 64]
    assert rows[0][1] == pl.STAGE_TOKENS[32]
    assert pl.STAGE_TOKENS[32] % rows[1][1] == 0
    assert rows[2][1] == pl.STAGE_TOKENS[64]
    assert rows[0][3] * 8 == rows[2][3] * 8 == pl.WIDE_TILE_MAX_LATENT
    assert rows[1][3] * 8 >= pl.MAX_WIDTH - 16
    assert f"constexpr int kCombK = {pl.COMB_K};" in src
    assert f"constexpr int kCombRows = {pl.COMB_ROWS};" in src
    assert f"constexpr int kCombCols = {pl.COMB_COLS};" in src


def test_kernel_limits_admit_the_served_widths():
    from types import SimpleNamespace as NS

    def cfg(klat, dpe, dv):
        return NS(kv_lora_rank=klat, qk_pos_emb_head_dim=dpe, v_head_dim=dv)
    for widths in ((512, 64, 128), (128, 64, 64), (576, 64, 8), (32, 16, 16),
                   (512, 64, 256), (512, 64, 2)):
        assert pl.kernel_limits(cfg(*widths)) is None, widths
    for widths in ((520, 64, 128), (512, 72, 128), (608, 64, 128)):
        assert "kv_lora_rank" in pl.kernel_limits(cfg(*widths)), widths


# ---------------------------------------------------------------------------
# the split arithmetic against the plain version and JAX's kernel
# ---------------------------------------------------------------------------

KLAT, DPE, DV, NQ, BS = 32, 16, 16, 4, 16
QUANT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _to_torch(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _inputs(seed, kind, b, s_q, tokens):
    """numpy-made inputs as JAX arrays: q and w_v fp32 holding bf16 values
    (the kernel takes bf16 q and w_v), pools bf16 or quantized by JAX's
    quantize_kv_rows, a table of `tokens` positions a slot drawn without
    repeats from a pool with spare blocks."""
    rng = np.random.default_rng(seed)
    mb = tokens // BS
    nb = b * mb + 3
    qs = (b, NQ) if s_q is None else (b, s_q, NQ)

    def bf16(a):
        return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(
            jnp.float32)
    q_lat, q_pe = bf16(rng.normal(size=qs + (KLAT,))), bf16(
        rng.normal(size=qs + (DPE,)))
    w_v = bf16(rng.normal(size=(KLAT, NQ, DV)) / 4)
    lat = jnp.asarray(rng.normal(size=(nb, BS, KLAT)), jnp.float32)
    pe = jnp.asarray(rng.normal(size=(nb, BS, DPE)), jnp.float32)
    if kind == "bf16":
        lat, pe, ls, ps = lat.astype(jnp.bfloat16), pe.astype(
            jnp.bfloat16), None, None
    else:
        lat, ls = jpa.quantize_kv_rows(lat, dtype=QUANT[kind])
        pe, ps = jpa.quantize_kv_rows(pe, dtype=QUANT[kind])
    table = jnp.asarray(rng.permutation(nb)[:b * mb].reshape(b, mb),
                        jnp.int32)
    return q_lat, q_pe, lat, pe, table, w_v, ls, ps


def _edge_lens(edge, st, tokens, s_q):
    """(kv_lens, q_lens) of six slots at the plan's edges for splits of
    `st` positions: decode at kv 1, one past a split, a split's end, two
    splits, the table's end and one short of two splits, or kv 1 beside
    full slots; chunks of S_q rows a slot, every row full, at the same
    edges (the first at kv S_q), or a ragged tail with rows past q_lens."""
    ends = [1, st + 1, st, 2 * st, tokens, 2 * st - 1]
    if s_q is None:
        return (ends if edge == "split_edges"
                else [1, tokens, 1, tokens - 1, 1, tokens]), None
    if edge == "split_edges":
        return [s_q] + ends[1:], [s_q] * 6
    return [5, st + 3, 2 * st, tokens, 1, st], [5, 3, 1, s_q, 1, 7]


# shape: (S_q, table positions): decode; chunks of 32 rows (a 32-row tile)
# and of 48 rows (a 64-row tile)
SHAPES = {"decode": (None, 256), "chunk_rows32": (8, 256),
          "chunk_rows64": (12, 512)}
CASES = [(shape, edge, kind)
         for shape in SHAPES
         for edge in (("split_edges", "kv1_beside_full") if shape == "decode"
                      else ("split_edges", "ragged_tail_and_padding"))
         for kind in ("bf16", "int8", "fp8")]


@pytest.mark.parametrize("shape,edge,kind", CASES,
                         ids=["-".join(c) for c in CASES])
def test_split_mirror_merged_equals_plain_and_jax(shape, edge, kind):
    s_q, tokens = SHAPES[shape]
    plan = pl.latent_split_plan(6, (s_q or 1) * NQ, tokens, KLAT, SMS)
    assert plan.splits > 2, plan
    assert plan.row_tile == (64 if shape == "chunk_rows64" else 32)
    lens, q_lens = _edge_lens(edge, plan.split_tokens, tokens, s_q)
    q_lat, q_pe, lat, pe, table, w_v, ls, ps = _inputs(
        CASES.index((shape, edge, kind)), kind, 6, s_q, tokens)
    jl = jnp.asarray(lens, jnp.int32)
    jql = None if q_lens is None else jnp.asarray(q_lens, jnp.int32)
    t = [_to_torch(a) for a in (q_lat, q_pe, lat, pe, table, w_v, ls, ps)]
    tl, tql = _to_torch(jl), _to_torch(jql)
    kw = dict(softmax_scale=SCALE, lat_scales=t[6], pe_scales=t[7])

    acc, m, l = pl.paged_latent_split_partials_plain(
        t[0], t[1], t[2], t[3], t[4], tl, tql, plan=plan, **kw)
    assert acc.shape[-2] == plan.splits and m.shape[-1] == plan.splits
    got = torch.einsum("bqnk,knd->bqnd", merge_split_partials(acc, m, l),
                       t[5])
    if tql is None:
        got = got[:, 0]
    want = pl.paged_attention_latent_plain(t[0], t[1], t[2], t[3], t[4], tl,
                                           t[5], tql, **kw)
    jax_out = np.asarray(jkg.paged_attention_latent(
        q_lat, q_pe, lat, pe, table, jl, w_v, q_lens=jql,
        softmax_scale=SCALE, lat_scales=ls, pe_scales=ps), np.float32)
    got, want = got.numpy(), want.numpy()
    if tql is not None:     # rows past q_lens: finite garbage by contract
        real = np.arange(s_q)[None, :] < np.asarray(q_lens)[:, None]
        got, want, jax_out = got[real], want[real], jax_out[real]
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= MIRROR_TOL * scale
    np.testing.assert_allclose(got, jax_out, **JAX_TOL)


def test_split_mirror_drops_no_split():
    """Merging the partials without one live split, or with a split's
    positions counted twice, leaves the plain version: the test above
    would see a split the arithmetic lost."""
    tokens = 256
    plan = pl.latent_split_plan(2, NQ, tokens, KLAT, SMS)
    st = plan.split_tokens
    q_lat, q_pe, lat, pe, table, w_v, ls, ps = _inputs(99, "bf16", 2, None,
                                                       tokens)
    t = [_to_torch(a) for a in (q_lat, q_pe, lat, pe, table, w_v)]
    lens = torch.tensor([2 * st + 5, tokens], dtype=torch.int32)
    acc, m, l = pl.paged_latent_split_partials_plain(
        t[0], t[1], t[2], t[3], t[4], lens, softmax_scale=SCALE, plan=plan)
    want = pl.paged_attention_latent_plain(t[0], t[1], t[2], t[3], t[4],
                                           lens, t[5], softmax_scale=SCALE)
    scale = float(want.abs().max())

    def out(a, mm, ll):
        return torch.einsum("bqnk,knd->bqnd", merge_split_partials(a, mm, ll),
                            t[5])[:, 0]
    assert float((out(acc, m, l) - want).abs().max()) <= MIRROR_TOL * scale
    dropped = l.clone()
    dropped[..., 1] = 0
    assert float((out(acc, m, dropped) - want).abs().max()) \
        > 100 * MIRROR_TOL * scale
    twice = (torch.cat([acc, acc[..., 1:2, :]], dim=-2),
             torch.cat([m, m[..., 1:2]], dim=-1),
             torch.cat([l, l[..., 1:2]], dim=-1))
    assert float((out(*twice) - want).abs().max()) \
        > 100 * MIRROR_TOL * scale
