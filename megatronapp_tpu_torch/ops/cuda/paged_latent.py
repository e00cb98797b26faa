"""MLA latent-space ragged paged attention: the CUDA kernels' wrapper,
their plain version, their CPU mirror, their split plan, their launch
counter and their build.

The kernels (csrc/paged_latent.cu) replace the TPU kernel
``megatronapp_tpu/ops/pallas/kernel_gen.py:paged_attention_latent``
(emit_latent_kernel) in its decode and ragged modes, for bf16 pools and for
int8 / fp8 (e4m3) pools with one fp32 scale per row. Where the TPU body
re-expands every block's values through ``w_v``, the kernels sum P·latent
in latent space and expand once: the same function up to the order of the
fp32 sums, ~57x fewer operations at decode (the source note says what
bounds it). A call is two launches, counted once: a split kernel whose
blocks take (token split, row tile, slot), the slot's table positions
split by ``latent_split_plan`` (from shapes alone), scores and P·latent on
the tensor cores, each block writing its unnormalised partial and (m, l) a
row to a workspace (``split_workspace``: splits × B × S_q × nq × (klat + 2)
fp32, then the combine's partial tiles; kept beyond the call); then a
combine kernel, launched as a programmatic dependent, whose blocks add a
row's live splits in split order for a quarter of the latent columns and
expand it through ``w_v``, the last of a tile's four blocks (a counter in
a zeroed int32 buffer that it resets) adding the quarters in order.
``paged_latent_split_partials_plain`` mirrors the split kernel's
arithmetic on the CPU.

``paged_attention_latent`` takes the plain version only for tensors that
lie on the CPU. For CUDA tensors it launches the kernels or raises: there
is no fallback. The kernels build at first use through
``ops/cuda/build.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from megatronapp_tpu_torch.ops.cuda import build as kbuild
from megatronapp_tpu_torch.ops.cuda.paged_attention import (
    NEG_INF, split_bf16_terms, storage_view,
)

_PAGE_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}

# Calls that launch the kernels (two launches a call), by mode and, for
# quantized pools, page dtype. Incremented only where the wrapper launches
# them (never by the plain version).
launches: Dict[str, int] = {f"{mode}{sfx}": 0
                            for sfx in ("", "_int8", "_fp8")
                            for mode in ("decode", "ragged")}

SOURCE = kbuild.source("paged_latent.cu")
# csrc/paged_latent.cu's constants: kMaxWidth (klat + dpe); kMaxSplits;
# kPTerms, the bf16 terms of P in P·latent; kTiles, the split kernel's
# row tiles with their ring stages' tokens (32 rows: 64 tokens, or 32
# past klat 512, which divides it) and the widest latent that 64-row
# tiles take (8 warps of 64 columns).
MAX_WIDTH = 640
MAX_SPLITS = 16
P_TERMS = 2
STAGE_TOKENS = {32: 64, 64: 32}
WIDE_TILE_MAX_LATENT = 512
# The combine's blocks: kCombK blocks a (head, value tile, kCombRows rows)
# unit, each expanding a quarter of the latent columns into a partial of
# kCombRows x kCombCols fp32.
COMB_K, COMB_ROWS, COMB_COLS = 4, 16, 128
_SCALE_REQUIRED = (
    "paged_attention_latent requires softmax_scale: the MLA scale is "
    "1/sqrt(qk_head_dim + qk_pos_emb_head_dim), which cannot be derived "
    "from the latent width")
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_P] * 13 + [_I] * 8 + [ctypes.c_longlong] * 2
             + [_I, ctypes.c_float] + [_I] * 3 + [_P])
_counters: Dict[object, torch.Tensor] = {}


class LatentPlan(NamedTuple):
    row_tile: int        # rows a split block
    split_tokens: int    # table positions a split (whole ring stages)
    splits: int          # splits covering the table's positions


def latent_split_plan(batch: int, rows: int, tokens: int, klat: int,
                      sms: int) -> LatentPlan:
    """The split kernel's plan from the launch's shapes alone (never
    kv_lens, which lie on the device): a slot's `rows` (S_q × nq) in tiles
    of 32 at decode (at most 32 rows) or where klat exceeds
    WIDE_TILE_MAX_LATENT, else of 64; the table's `tokens` (MB·bs) split
    into whole ring stages (STAGE_TOKENS of the row tile) so that the
    blocks (splits × B × row tiles) come to about one wave of `sms`, each
    split at least one stage and at most MAX_SPLITS splits. Splits wholly
    past what a row tile sees exit at once, and the combine adds each
    row's live splits."""
    row_tile = 32 if rows <= 32 or klat > WIDE_TILE_MAX_LATENT else 64
    stage = STAGE_TOKENS[row_tile]
    units = batch * -(-rows // row_tile)
    stages = -(-tokens // stage)
    want = max(1, min(stages, sms // units, MAX_SPLITS))
    per = -(-stages // want)
    return LatentPlan(row_tile, per * stage, -(-stages // per))


def _kernel():
    """The bound C launcher (built and loaded on first use)."""
    return kbuild.load(SOURCE, "paged_latent_launch", _ARGTYPES)


def dequantize_latent_pages(pages: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """A quantized latent (or roped-key) pool [NB, bs, d] with its per-row
    scales [NB, bs] → fp32 float(page) × scale (JAX ops/pallas/
    paged_attention.py:242)."""
    return pages.float() * scales[..., None]


def _gather(pages: torch.Tensor, table: torch.Tensor,
            scales: Optional[torch.Tensor]) -> torch.Tensor:
    """pages[table] as fp32, dequantized with its per-row scales."""
    rows = storage_view(pages)[table].view(pages.dtype)
    if scales is None:
        return rows.float()
    return dequantize_latent_pages(rows, scales[table])


def paged_attention_latent_plain(q_lat: torch.Tensor, q_pe: torch.Tensor,
                                 lat_pages: torch.Tensor,
                                 pe_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_lens: torch.Tensor, w_v: torch.Tensor,
                                 q_lens: Optional[torch.Tensor] = None,
                                 softmax_scale: Optional[float] = None,
                                 lat_scales: Optional[torch.Tensor] = None,
                                 pe_scales: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (and the port's
    paged_attention_latent_reference): gathers every slot's latent and
    roped-key rows densely (dequantized with their row scales), masks
    (kv length, and the causal tail in ragged mode), takes the softmax in
    fp32, sums P·latent and expands through w_v. q is scaled in fp32 and
    rounded to the page dtype before the dot on unquantized pools, as the
    TPU body does (kernel_gen.py:390-402). Same signature and shapes as
    ``paged_attention_latent``."""
    if softmax_scale is None:
        raise ValueError(_SCALE_REQUIRED)
    decode = q_lens is None
    if decode:
        q_lat, q_pe = q_lat[:, None], q_pe[:, None]
        q_lens = torch.ones_like(kv_lens)
    b, s_q, nq, klat = q_lat.shape
    bs = lat_pages.shape[1]
    mb = page_table.shape[1]
    table = page_table.long()
    lat = _gather(lat_pages, table, lat_scales).reshape(b, mb * bs, klat)
    pe = _gather(pe_pages, table, pe_scales).reshape(b, mb * bs, -1)
    ql = q_lat.float() * softmax_scale
    qp = q_pe.float() * softmax_scale
    if lat_scales is None:
        ql, qp = ql.to(lat_pages.dtype).float(), qp.to(pe_pages.dtype).float()
    s = (torch.einsum("bqnk,bsk->bqns", ql, lat)
         + torch.einsum("bqnp,bsp->bqns", qp, pe))
    dev = q_lat.device
    pos = torch.arange(mb * bs, device=dev)
    kv_lens, q_lens = kv_lens.to(dev).long(), q_lens.to(dev).long()
    abs_q = (kv_lens - q_lens)[:, None] + torch.arange(s_q, device=dev)
    mask = ((pos[None, None, :] <= abs_q[:, :, None])
            & (pos[None, None, :] < kv_lens[:, None, None]))
    s = s.masked_fill(~mask[:, :, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    acc = torch.einsum("bqns,bsk->bqnk", p, lat)
    out = torch.einsum("bqnk,knd->bqnd", acc, w_v.float()).to(q_lat.dtype)
    return out[:, 0] if decode else out


def paged_latent_split_partials_plain(q_lat: torch.Tensor,
                                      q_pe: torch.Tensor,
                                      lat_pages: torch.Tensor,
                                      pe_pages: torch.Tensor,
                                      page_table: torch.Tensor,
                                      kv_lens: torch.Tensor,
                                      q_lens: Optional[torch.Tensor] = None,
                                      softmax_scale: Optional[float] = None,
                                      lat_scales: Optional[torch.Tensor] = None,
                                      pe_scales: Optional[torch.Tensor] = None,
                                      *, plan: LatentPlan):
    """The split kernel's partials in plain PyTorch, with its conventions:
    (acc [B, S_q, nq, S, klat], m, l [B, S_q, nq, S]) of the S splits of
    `plan` (a ``latent_split_plan``). Split i holds
    table positions [i·split_tokens, (i + 1)·split_tokens), walked in ring
    stages (STAGE_TOKENS of the row tile) by an online softmax: m the
    running max of the row's visible scores (-1e30 where none), l = Σ
    exp(s - max(m, -5e29)), acc the unnormalised Σ P·latent, rescaled by
    each stage's correction. A row sees positions below min(kv_len, q_start
    + s + 1). Scores: bf16 pools take bf16(q × scale) · bf16 rows;
    quantized pools (lat_scales / pe_scales) take (q_lat · codes) × ls and
    (q_pe · codes) × ps apart, times the scale. P·latent: P (× the
    token's latent row scale on quantized pools) in P_TERMS bf16 terms,
    times the bf16 rows or the codes. ``merge_split_partials`` of the
    result, expanded through w_v, is the function. q_lat [B, nq, klat] in
    decode mode (q_lens None; S_q is then 1)."""
    if softmax_scale is None:
        raise ValueError(_SCALE_REQUIRED)
    if q_lens is None:
        q_lat, q_pe = q_lat[:, None], q_pe[:, None]
        q_lens = torch.ones_like(kv_lens)
    b, s_q, nq, klat = q_lat.shape
    bs, mb = lat_pages.shape[1], page_table.shape[1]
    tokens = mb * bs
    stage = STAGE_TOKENS[plan.row_tile]
    table = page_table.long()

    def rows(pages):
        return storage_view(pages)[table].view(pages.dtype).float().reshape(
            b, tokens, pages.shape[-1])
    lat, pe = rows(lat_pages), rows(pe_pages)
    quant = lat_scales is not None
    ql, qp = q_lat.float(), q_pe.float()
    if quant:
        ls = lat_scales[table].reshape(b, 1, 1, tokens)
        ps = pe_scales[table].reshape(b, 1, 1, tokens)
        s = (torch.einsum("bqnk,btk->bqnt", ql, lat) * ls
             + torch.einsum("bqnk,btk->bqnt", qp, pe) * ps) * softmax_scale
    else:
        ql = (ql * softmax_scale).to(torch.bfloat16).float()
        qp = (qp * softmax_scale).to(torch.bfloat16).float()
        s = (torch.einsum("bqnk,btk->bqnt", ql, lat)
             + torch.einsum("bqnk,btk->bqnt", qp, pe))
    kv, ql_ = kv_lens.long(), q_lens.long()
    end = torch.minimum(kv.clamp(max=tokens)[:, None],
                        (kv - ql_)[:, None] + torch.arange(s_q) + 1)
    pos = torch.arange(tokens)
    accs, ms, lsums = [], [], []
    for i in range(plan.splits):
        s0 = i * plan.split_tokens
        m = torch.full((b, s_q, nq), NEG_INF)
        lsum = torch.zeros(b, s_q, nq)
        acc = torch.zeros(b, s_q, nq, klat)
        for tb in range(s0, min(s0 + plan.split_tokens, tokens), stage):
            cols = pos[tb:tb + stage]
            ok = (cols[None, None, :] < end[:, :, None])[:, :, None, :]
            sc = s[..., tb:tb + stage].masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            pr = torch.exp(sc - m_new.clamp(min=NEG_INF / 2)[..., None]) \
                .masked_fill(~ok, 0.0)
            corr = torch.where(m <= NEG_INF / 2, torch.zeros(()),
                               torch.exp((m - m_new).clamp(max=0.0)))
            lsum = lsum * corr + pr.sum(dim=-1)
            w = pr * ls[..., tb:tb + stage] if quant else pr
            w = sum(split_bf16_terms(w, P_TERMS)[::-1])
            acc = acc * corr[..., None] + torch.einsum(
                "bqnt,btk->bqnk", w, lat[:, tb:tb + stage])
            m = m_new
        accs.append(acc)
        ms.append(m)
        lsums.append(lsum)
    return (torch.stack(accs, dim=3), torch.stack(ms, dim=-1),
            torch.stack(lsums, dim=-1))


def kernel_limits(cfg) -> Optional[str]:
    """What of an MLA config's widths the kernels do not take, by name
    (None: they take them)."""
    klat, dpe = cfg.kv_lora_rank, cfg.qk_pos_emb_head_dim
    if klat % 16 or dpe % 16 or klat + dpe > MAX_WIDTH:
        return (f"latent paged attention: kv_lora_rank {klat} and "
                f"qk_pos_emb_head_dim {dpe} (multiples of 16, together at "
                f"most {MAX_WIDTH}: the split kernel's Q and ring stages in "
                "shared memory); any v_head_dim")
    return None


def _check(q_lat, q_pe, lat_pages, pe_pages, page_table, kv_lens, w_v,
           q_lens, lat_scales, pe_scales):
    dev = q_lat.device
    if dev.type != "cuda":
        raise ValueError(
            f"paged_attention_latent: tensors on {dev} — the kernel takes "
            "CUDA tensors and the plain version CPU tensors")
    named = {"q_lat": q_lat, "q_pe": q_pe, "lat_pages": lat_pages,
             "pe_pages": pe_pages, "page_table": page_table,
             "kv_lens": kv_lens}
    if q_lens is not None:
        named["q_lens"] = q_lens
    quantized = lat_scales is not None
    if quantized:
        named.update(lat_scales=lat_scales, pe_scales=pe_scales)
    for name, t in {**named, "w_v": w_v}.items():
        if t.device != dev:
            raise ValueError(f"paged_attention_latent: {name} on "
                             f"{t.device}, q_lat on {dev}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_latent: {name} is not "
                             "contiguous")
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe), ("w_v", w_v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"paged_attention_latent: {name} is {t.dtype};"
                             " the kernel takes bf16")
    if w_v.dim() != 3 or w_v.stride(-1) != 1:
        raise ValueError("paged_attention_latent: w_v must be [klat, nq, "
                         "dv] with unit stride along dv")
    kind = _PAGE_KIND.get(lat_pages.dtype)
    if kind is None or pe_pages.dtype != lat_pages.dtype \
            or quantized != (kind > 0) or (pe_scales is None) == quantized:
        raise ValueError(
            f"paged_attention_latent: pools {lat_pages.dtype}/"
            f"{pe_pages.dtype} with{'' if quantized else 'out'} scale "
            "pools; the kernel takes bf16 pools without scales, or int8 / "
            "fp8 (e4m3) pools with both fp32 scale pools")
    for name in ("q_lat", "q_pe", "lat_pages", "pe_pages"):
        if named[name].data_ptr() % 16:
            raise ValueError(f"paged_attention_latent: {name} is not "
                             "16-byte aligned")
    if lat_pages.dim() != 3 or pe_pages.dim() != 3 \
            or lat_pages.shape[:2] != pe_pages.shape[:2]:
        raise ValueError("paged_attention_latent: pools must be [NB, bs, "
                         f"klat] and [NB, bs, dpe], got "
                         f"{tuple(lat_pages.shape)} and "
                         f"{tuple(pe_pages.shape)}")
    if quantized:
        want = tuple(lat_pages.shape[:2])
        for name in ("lat_scales", "pe_scales"):
            t = named[name]
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"paged_attention_latent: {name} must be "
                                 f"fp32 {want}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    for name in ("page_table", "kv_lens", "q_lens"):
        if name in named and named[name].dtype != torch.int32:
            raise ValueError(f"paged_attention_latent: {name} must be "
                             f"int32, got {named[name].dtype}")
    ragged = q_lens is not None
    klat, dpe = lat_pages.shape[2], pe_pages.shape[2]
    nd = 4 if ragged else 3
    if q_lat.dim() != nd or q_pe.shape[:-1] != q_lat.shape[:-1] \
            or q_lat.shape[-1] != klat or q_pe.shape[-1] != dpe:
        raise ValueError(f"paged_attention_latent: q_lat {tuple(q_lat.shape)}"
                         f" / q_pe {tuple(q_pe.shape)} do not fit pools "
                         f"{tuple(lat_pages.shape)} / "
                         f"{tuple(pe_pages.shape)} in "
                         f"{'ragged' if ragged else 'decode'} mode")
    b, nq = q_lat.shape[0], q_lat.shape[-2]
    if tuple(w_v.shape[:2]) != (klat, nq):
        raise ValueError(f"paged_attention_latent: w_v {tuple(w_v.shape)} "
                         f"is not [klat {klat}, nq {nq}, dv]")
    if klat < 16 or dpe < 16 or klat % 16 or dpe % 16 \
            or klat + dpe > MAX_WIDTH:
        raise ValueError(f"paged_attention_latent: klat {klat} and dpe {dpe}"
                         f" (multiples of 16, klat + dpe <= {MAX_WIDTH})")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(kv_lens.shape) != (b,) \
            or (ragged and tuple(q_lens.shape) != (b,)):
        raise ValueError("paged_attention_latent: page_table must be [B, MB]"
                         " and kv_lens/q_lens [B]")


def paged_attention_latent(q_lat: torch.Tensor, q_pe: torch.Tensor,
                           lat_pages: torch.Tensor, pe_pages: torch.Tensor,
                           page_table: torch.Tensor, kv_lens: torch.Tensor,
                           w_v: torch.Tensor,
                           q_lens: Optional[torch.Tensor] = None,
                           softmax_scale: Optional[float] = None,
                           lat_scales: Optional[torch.Tensor] = None,
                           pe_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """MLA latent-space ragged paged attention, the kernel_gen.
    paged_attention_latent contract.

    q_lat [B, nq, klat] (decode) or [B, S_q, nq, klat] with q_lens [B]
    (ragged: row s of slot b sits at absolute position kv_lens[b] -
    q_lens[b] + s; rows past q_lens[b] are padding with finite garbage
    outputs): the absorbed query. q_pe [..., nq, dpe]: the roped decoupled
    heads. lat_pages [NB, bs, klat] and pe_pages [NB, bs, dpe]: the
    compressed pool, no head axis. page_table [B, MB] int32; kv_lens [B]
    int32 valid positions including the new tail. w_v [klat, nq, dv]:
    kv_up's v columns (any strides with unit stride along dv). lat_scales /
    pe_scales [NB, bs] fp32 mark int8 or fp8 pools (float(page) × its row
    scale). softmax_scale is required. Returns [B(, S_q), nq, dv] in q_lat's
    dtype. CPU tensors run the plain version; CUDA tensors launch the two
    kernels (``latent_split_plan``; one count a call) or raise."""
    if softmax_scale is None:
        raise ValueError(_SCALE_REQUIRED)
    if q_lat.device.type == "cpu":
        return paged_attention_latent_plain(
            q_lat, q_pe, lat_pages, pe_pages, page_table, kv_lens, w_v,
            q_lens, softmax_scale, lat_scales, pe_scales)
    _check(q_lat, q_pe, lat_pages, pe_pages, page_table, kv_lens, w_v,
           q_lens, lat_scales, pe_scales)
    fn = _kernel()
    ragged = q_lens is not None
    b, nq, klat = q_lat.shape[0], q_lat.shape[-2], q_lat.shape[-1]
    s_q = q_lat.shape[1] if ragged else 1
    dpe, dv = q_pe.shape[-1], w_v.shape[-1]
    bs, mb = lat_pages.shape[1], page_table.shape[1]
    dev = q_lat.device
    plan = latent_split_plan(b, s_q * nq, mb * bs, klat,
                             kbuild.sm_count(dev))
    units = nq * -(-b * s_q // COMB_ROWS) * -(-dv // COMB_COLS)
    ws = kbuild.split_workspace(
        "paged_latent", dev, plan.splits * b * s_q * nq * (klat + 2)
        + units * COMB_K * COMB_ROWS * COMB_COLS)
    counters = _counters.get(dev)
    if counters is None or counters.numel() < units:
        # Zero once; the combine's last block of a unit resets its count.
        counters = torch.zeros(max(units, 1024), dtype=torch.int32,
                               device=dev)
        _counters[dev] = counters
    out = torch.empty(q_lat.shape[:-1] + (dv,), dtype=torch.bfloat16,
                      device=dev)
    kind = _PAGE_KIND[lat_pages.dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q_lat.data_ptr(), q_pe.data_ptr(), lat_pages.data_ptr(),
            pe_pages.data_ptr(), lat_scales.data_ptr() if kind else None,
            pe_scales.data_ptr() if kind else None, page_table.data_ptr(),
            kv_lens.data_ptr(), q_lens.data_ptr() if ragged else None,
            w_v.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), b, s_q, nq, klat,
            dpe, dv, bs, mb, w_v.stride(0), w_v.stride(1), kind,
            float(softmax_scale), plan.row_tile, plan.split_tokens,
            plan.splits, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_latent kernel launch failed: "
                           f"CUDA error {rc} (plan {tuple(plan)})")
    sfx = ("", "_int8", "_fp8")[kind]
    launches[f"{'ragged' if ragged else 'decode'}{sfx}"] += 1
    return out
