"""The fused decode-layer kernels: their wrappers, plain versions, launch
counters and build.

The four kernels (csrc/fused_decode.cu) replace the TPU kernels of
``megatronapp_tpu/ops/pallas/kernel_gen.py``:

- ``fused_qkv``      ← ``_fused_qkv`` (norm + QKV + biases + QK-norm + rope);
- ``fused_out_proj`` ← ``_fused_out_proj`` (out-projection + bias +
  residual);
- ``fused_mlp_fc1``  ← ``_fused_mlp_fc1`` and the fc1 half of ``_fused_mlp``
  (norm + fc1 + bias + activation, gated kinds too);
- ``fused_mlp_fc2``  ← ``_fused_mlp_fc2`` and the fc2 half of ``_fused_mlp``
  (fc2 + bias + residual).

Each is bound by the bytes of its weights at decode; the source note says
what the design does about that. Signatures follow the JAX functions: ``p``
is one layer's params (``ln1_*``/``ln2_*`` with the ``attention`` and
``mlp`` children), x [R, H] rows of the residual stream (R decode slots, or
B·S flattened ragged rows).

Each wrapper takes its plain version only for tensors that lie on the CPU.
For CUDA tensors it launches the kernel or raises: there is no fallback.
The kernels take bf16 activations and residual, bf16 compute, and a
weight kind per launch: bf16 weights, fp32 weights rounded to bf16 as they
load, or resident int8 leaves (inference/quantization.py: int8 [K, N] and
fp32 scales [1, N]) dequantized as they load, bf16(float(q) × scale), as
_dequant_weight and resolve_param do; ``kernel_limits`` names what else
they refuse (the engine checks it once, through
``ops.fused_decode.megakernel_ineligible_reason``). The plain versions
follow the JAX bodies' rounding points op for op in any dtype: norm then
cast to the compute dtype, ``xn @ resolve_param(w, cdt)`` and + bias in
the compute dtype, QK-RMSnorm, rope in fp32 cast back, the activation on
the compute dtype, ``r + out.to(r.dtype)``.

K-split launches (ksplit > 1) add their partial tiles through a workspace
the wrapper allocates and a per-device counter buffer the kernels leave at
zero; kernels sharing it run on one stream, as the engine's do. All four
kernels sum on one tensor-core tile core and split K in whole ring stages
by one plan (``tile_split_plan``), which reads the row count only through
the row block and the row chunks, so a row's bits are the same alone as
in any batch of up to 32 rows (one row chunk); a batch of more chunks may
split K otherwise.

``lora=``: one layer's batched adapter deltas (ops/lora.py: {"row_adapter":
LoraRows, "banks": {target: (A [slots, din, rank], B [slots, rank,
dout])}}). The plain versions add the delta as JAX's ``_lora_epilogue``
does (kernel_gen.py:1130; the bodies at :1242-1245, :1552-1554,
:1672-1683): fp32 (x @ A) @ B of each row's adapter, cast to the compute
dtype, added after the matmul's rounding and before the bias. On the card
each wrapper first launches the shrink kernel (ops/cuda/lora.py
``lora_shrink``, counted there) on the kernel's input, ``lora_shrink_for``:
t = bf16(norm(x)) @ A for QKV (q and kv in one launch) and fc1,
attn_flat @ A and y @ A for the out-projection and fc2; the fused kernel's
LoRA epilogue (a template flag of the same kernels) then expands t through
the fp32 B bank read in place by the rows' slot ids. The fused launches
count in ``lora_launches``, by the same keys.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from megatronapp_tpu_torch.config.transformer_config import (
    ActivationKind, TransformerConfig,
)
from megatronapp_tpu_torch.inference.quantization import (
    RESIDENT_KERNELS, is_resident_leaf, resolve_param,
)
from megatronapp_tpu_torch.ops import rotary
from megatronapp_tpu_torch.ops.activations import apply_activation, is_gated
from megatronapp_tpu_torch.ops.cuda import build as kbuild
from megatronapp_tpu_torch.ops.cuda import lora as cuda_lora
from megatronapp_tpu_torch.ops.lora import lora_delta_plain
from megatronapp_tpu_torch.ops.normalization import apply_norm, rms_norm

KERNELS = ("qkv", "out_proj", "mlp_fc1", "mlp_fc2")
# Launches of each kernel, by kernel and, for resident int8 weights, weight
# kind ("qkv_int8", ...). Incremented only where the wrappers launch them
# (never by the plain versions); launches with the LoRA epilogue count in
# lora_launches instead, by the same keys.
launches: Dict[str, int] = {f"{k}{sfx}": 0 for sfx in ("", "_int8")
                            for k in KERNELS}
lora_launches: Dict[str, int] = dict.fromkeys(launches, 0)

SOURCE = kbuild.source("fused_decode.cu")
TILE = 128                     # output columns a block
HEAD_DIMS = (64, 128)
# The weight kinds the kernels take (torch.int8: a resident leaf) and the
# code each launcher reads; norm scales and biases are bf16 or fp32.
WEIGHT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
VECTOR_DTYPES = (torch.bfloat16, torch.float32)
# The K-split plan of every kernel (mma_tile): whole ring stages of
# STAGE_K k's a split (csrc kStageK), as many splits as fit SPLIT_WAVES
# blocks an SM.
STAGE_K = 128
SPLIT_WAVES = 2
# Row blocks from which the normalising kernels (QKV, fc1) compute their
# rows' norm statistics once a launch and share them through the
# workspace (csrc kSharedStatsRb), with or without a K split (fc1 has
# none at llama3-8b: the wrapper then allocates the statistics and
# counters alone).
SHARED_STATS_RB = 32
_NORM = cuda_lora.NORM_CODES
_ACT = {ActivationKind.swiglu: 0, ActivationKind.geglu: 1,
        ActivationKind.gelu: 2, ActivationKind.relu: 3,
        ActivationKind.squared_relu: 4}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "fused_qkv_launch": [_P, _P, _P, _I, _F] + [_P] * 15 + [_I] * 9
                        + [_P] * 5 + [_I, _P],
    "fused_residual_gemm_launch": [_I] + [_P] * 8 + [_I] * 6 + [_P] * 3
                                  + [_I, _P],
    "fused_mlp_fc1_launch": [_P, _P, _P, _I, _F] + [_P] * 6 + [_I] * 7
                            + [_P] * 3 + [_I, _P],
}
# The LoRA targets of each kernel's epilogue and the norm of its input
# (the layer's ln1 / ln2 params; None: the input as given).
LORA_TARGETS = {"qkv": (("q_kernel", "kv_kernel"), "ln1"),
                "out_proj": (("out_kernel",), None),
                "mlp_fc1": (("fc1_kernel",), "ln2"),
                "mlp_fc2": (("fc2_kernel",), None)}
_counters: Dict[torch.device, torch.Tensor] = {}


def _kernel(symbol: str):
    """A bound C launcher (the source is built and loaded on first use)."""
    return kbuild.load(SOURCE, symbol, _ARGTYPES[symbol])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _lora_epilogue(xv, lora, target: str, dtype: torch.dtype):
    """The in-kernel delta of kernel_gen._lora_epilogue: each row's fp32
    (x @ A) @ B through its adapter's bank slot, cast to `dtype`."""
    a_bank, b_bank = lora["banks"][target]
    return lora_delta_plain(xv, a_bank, b_bank,
                            lora["row_adapter"]).to(dtype)


def fused_qkv_plain(x, p, cfg: TransformerConfig, cos=None, sin=None,
                    lora=None):
    """Plain version of ``fused_qkv`` (the _fused_qkv body): x [R, H] →
    (q [R, nq, D], k [R, nkv, D], v [R, nkv, D]) in the compute dtype."""
    a, cdt, eps = p["attention"], cfg.compute_dtype, cfg.layernorm_epsilon
    r = x.shape[0]
    nq, nkv, d = cfg.num_attention_heads, cfg.num_query_groups, cfg.head_dim
    xn = apply_norm(cfg.normalization, x, p["ln1_scale"], p.get("ln1_bias"),
                    eps).to(cdt)
    q = xn @ resolve_param(a["q_kernel"], cdt)
    kv = xn @ resolve_param(a["kv_kernel"], cdt)
    if lora is not None:
        q = q + _lora_epilogue(xn, lora, "q_kernel", cdt)
        kv = kv + _lora_epilogue(xn, lora, "kv_kernel", cdt)
    if "q_bias" in a:
        q = q + a["q_bias"].to(cdt)
        kv = kv + a["kv_bias"].to(cdt)
    q = q.reshape(r, nq, d)
    k, v = kv.reshape(r, 2 * nkv, d).split(nkv, dim=1)
    if cfg.qk_layernorm:
        q = rms_norm(q, a["q_ln_scale"], eps)
        k = rms_norm(k, a["k_ln_scale"], eps)
    if cos is not None:   # per-row tables [R, half]: the [R, 1] rope shape
        q = rotary.apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = rotary.apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    return q, k.contiguous(), v.contiguous()


def fused_out_proj_plain(attn_flat, p, cfg: TransformerConfig, residual,
                         lora=None):
    """Plain version of ``fused_out_proj``: attn_flat [R, nq·D] (compute
    dtype) → residual + (attn_flat @ W_o + bias) in the residual dtype."""
    a, cdt = p["attention"], cfg.compute_dtype
    out = attn_flat @ resolve_param(a["out_kernel"], cdt)
    if lora is not None:
        out = out + _lora_epilogue(attn_flat, lora, "out_kernel", cdt)
    if "out_bias" in a:
        out = out + a["out_bias"].to(cdt)
    return residual + out.to(residual.dtype)


def fused_mlp_fc1_plain(x, p, cfg: TransformerConfig, lora=None):
    """Plain version of ``fused_mlp_fc1``: x [R, H] → y [R, ffn] in the
    compute dtype (gated kinds: act(gate) * value of the packed fc1)."""
    m, cdt = p["mlp"], cfg.compute_dtype
    xn = apply_norm(cfg.normalization, x, p["ln2_scale"], p.get("ln2_bias"),
                    cfg.layernorm_epsilon).to(cdt)
    y = xn @ resolve_param(m["fc1_kernel"], cdt)
    if lora is not None:
        y = y + _lora_epilogue(xn, lora, "fc1_kernel", cdt)
    if "fc1_bias" in m:
        y = y + m["fc1_bias"].to(cdt)
    if is_gated(cfg.activation):
        gate, val = y.chunk(2, dim=-1)
        return apply_activation(cfg.activation, val, gate)
    return apply_activation(cfg.activation, y)


def fused_mlp_fc2_plain(y, x, p, cfg: TransformerConfig, lora=None):
    """Plain version of ``fused_mlp_fc2``: y [R, ffn] @ W2 + bias + the
    residual x [R, H] → [R, H] in the residual dtype; fc2's delta is from
    the activated y."""
    m, cdt = p["mlp"], cfg.compute_dtype
    out = y @ resolve_param(m["fc2_kernel"], cdt)
    if lora is not None:
        out = out + _lora_epilogue(y, lora, "fc2_kernel", cdt)
    if "fc2_bias" in m:
        out = out + m["fc2_bias"].to(cdt)
    return x + out.to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels' limits and argument checks
# ---------------------------------------------------------------------------


def weight_kind(leaf) -> torch.dtype:
    """The kind of a weight leaf as the kernels read it: torch.int8 for a
    resident leaf, else its dtype."""
    return torch.int8 if is_resident_leaf(leaf) else leaf.dtype


def _cfg_limits(cfg: TransformerConfig) -> Optional[str]:
    """The compute dtype, head_dim and alignment limits of the kernels (an
    MLA layer runs only the out-projection and MLP kernels here)."""
    h, ffn, d = cfg.hidden_size, cfg.ffn_hidden_size, cfg.head_dim
    cols = {"hidden_size": h, "ffn_hidden_size": ffn}
    if cfg.multi_latent_attention:
        cols["num_attention_heads * v_head_dim"] = (cfg.num_attention_heads
                                                    * cfg.v_head_dim)
    elif d not in HEAD_DIMS:
        return f"head_dim {d}: the fused CUDA kernels take {HEAD_DIMS}"
    else:
        cols["num_attention_heads * head_dim"] = cfg.num_attention_heads * d
        cols["num_query_groups * head_dim"] = cfg.num_query_groups * d
    for name, n in cols.items():
        if n % TILE:
            return (f"alignment: {name} = {n} is not a multiple of the "
                    f"fused CUDA kernels' {TILE}-column tile")
    return None


def kernel_limits(cfg: TransformerConfig, layer=None) -> Optional[str]:
    """What of `cfg` the CUDA kernels do not take, by name (None: they take
    it). `layer`: one layer's params, whose weight kinds are checked (by
    default every weight is in cfg.params_dtype)."""
    if cfg.compute_dtype != torch.bfloat16:
        return (f"compute dtype {cfg.compute_dtype}: the fused CUDA kernels "
                "compute in bf16, and the residual stream is in the compute "
                "dtype")
    vec = cfg.params_dtype
    # An MLA layer's q/kv path runs the fused MLA prologue (its own limits,
    # ops/cuda/fused_mla.py); its out_kernel and MLP run these kernels.
    names = [k for k in RESIDENT_KERNELS if not (
        cfg.multi_latent_attention and k in ("q_kernel", "kv_kernel"))]
    kinds = dict.fromkeys(names, vec)
    if layer is not None:
        vec = layer["ln1_scale"].dtype
        kinds = {k: weight_kind(layer["mlp" if k.startswith("fc")
                                      else "attention"][k])
                 for k in names}
    if vec not in VECTOR_DTYPES:
        return (f"weight dtype {vec}: the fused CUDA kernels take bf16 or "
                "fp32 weights (or resident int8 beside bf16 or fp32 norm "
                "scales and biases)")
    for name, kind in kinds.items():
        if kind != torch.int8 and kind != vec:
            return (f"weight dtype {kind} of {name}: the fused CUDA kernels "
                    f"take the params dtype {vec} or resident int8")
    if "q_kernel" in kinds and kinds["q_kernel"] != kinds["kv_kernel"]:
        return (f"mixed QKV weights: q_kernel {kinds['q_kernel']}, "
                f"kv_kernel {kinds['kv_kernel']} (the fused QKV kernel "
                "reads both as one weight kind: both resident int8 or "
                "neither)")
    return _cfg_limits(cfg)


def _tensors(name: str, leaf):
    """(name, tensor) pairs of a weight or vector leaf (a resident leaf
    holds two)."""
    if is_resident_leaf(leaf):
        return [(f"{name}.qint8", leaf["qint8"]),
                (f"{name}.qscale", leaf["qscale"])]
    return [] if leaf is None else [(name, leaf)]


def _check(name: str, cfg: TransformerConfig, acts: Dict[str, torch.Tensor],
           mats: Dict[str, object], vecs: Dict[str, Optional[torch.Tensor]]
           ) -> Tuple[int, int]:
    """Raise unless the kernel can take these tensors: one CUDA device,
    contiguous, bf16 activations, one weight kind for the matrices
    (`mats`: bf16, fp32 or resident int8 with fp32 [1, N] scales), bf16
    or fp32 vectors (norm scales, biases) of the matrices' dtype unless
    they are int8, 16-byte aligned matrices and the kernel limits of
    `cfg`. Returns the launcher's (weight kind, vector_f32)."""
    dev = acts["x"].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} — the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    given = [(k, t) for k, t in acts.items() if t is not None]
    for k, leaf in {**mats, **vecs}.items():
        given += _tensors(k, leaf)
    for k, t in given:
        if t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    for k, t in acts.items():
        if t is not None and t.dtype != torch.bfloat16 \
                and k not in ("cos", "sin"):
            raise ValueError(f"{name}: {k} is {t.dtype}; the kernel takes "
                             "bf16 activations")
    kinds = {weight_kind(w) for w in mats.values()}
    vdt = {t.dtype for t in vecs.values() if t is not None}
    if len(kinds) != 1 or not kinds <= set(WEIGHT_KINDS) or len(vdt) > 1 \
            or not vdt <= set(VECTOR_DTYPES):
        raise ValueError(f"{name}: weights {sorted(map(str, kinds))} and "
                         f"vectors {sorted(map(str, vdt))}; the kernel takes "
                         "one weight kind (bf16, fp32 or resident int8) and "
                         "bf16 or fp32 vectors")
    kind = kinds.pop()
    vec = vdt.pop() if vdt else (kind if kind != torch.int8
                                 else torch.bfloat16)
    if kind != torch.int8 and vec != kind:
        raise ValueError(f"{name}: {kind} weights with {vec} vectors; the "
                         "kernel takes vectors of the weights' dtype")
    for k, w in mats.items():
        if is_resident_leaf(w):
            q, sc = w["qint8"], w["qscale"]
            if q.dtype != torch.int8 or sc.dtype != torch.float32 \
                    or tuple(sc.shape) != (1, q.shape[-1]):
                raise ValueError(f"{name}: resident {k} must be int8 [K, N] "
                                 f"with fp32 scales [1, N], got {q.dtype} "
                                 f"{tuple(q.shape)} and {sc.dtype} "
                                 f"{tuple(sc.shape)}")
    if cfg.compute_dtype != torch.bfloat16:
        raise ValueError(f"{name}: {kernel_limits(cfg)}")
    reason = _cfg_limits(cfg)
    if reason:
        raise ValueError(f"{name}: {reason}")
    for k, t in given:
        if t.dim() == 2 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} is not 16-byte aligned")
    return WEIGHT_KINDS[kind], int(vec == torch.float32)


def _w(leaf):
    """(weight pointer, scale pointer) of a weight leaf."""
    if is_resident_leaf(leaf):
        return leaf["qint8"].data_ptr(), leaf["qscale"].data_ptr()
    return leaf.data_ptr(), None


def _shape(leaf) -> Tuple[int, ...]:
    return tuple((leaf["qint8"] if is_resident_leaf(leaf) else leaf).shape)


def _row_blocks(rows: int) -> Tuple[int, int]:
    """(row block, row chunks): 8-row blocks up to 8 rows, else 32."""
    rb = 8 if rows <= 8 else 32
    return rb, -(-rows // rb)


def split_k(k: int, ksplit: int) -> int:
    """The k's a split of a fused kernel owns (the last split the rest):
    whole ring stages, as mma_tile divides them."""
    stages = -(-k // STAGE_K)
    return -(-stages // ksplit) * STAGE_K


def tile_split_plan(rows: int, k: int, tiles: int, sms: int
                    ) -> Tuple[int, int, int]:
    """(row block, row chunks, ksplit) of every fused kernel: as many
    splits as fit SPLIT_WAVES blocks an SM in one wave (the blocks the
    card holds at once: a second wave would run alone, at a fraction of
    the card's bandwidth), each split a whole number of ring stages and
    none empty. It reads the row count only through the row block and
    chunks, so a row's sums are the same alone as in any batch of up to
    32 rows (one row chunk)."""
    rb, chunks = _row_blocks(rows)
    stages = -(-k // STAGE_K)
    want = min(stages, max(1, SPLIT_WAVES * sms // (tiles * chunks)))
    per = -(-stages // want)
    return rb, chunks, -(-stages // per)


def _split_buffers(rows: int, k: int, tiles: int, device: torch.device,
                   norm: bool = False):
    """(ksplit, workspace tensor, counters pointer) for one launch; the
    caller keeps the workspace alive until the launch is enqueued. The
    workspace holds the partial tiles (ksplit > 1), then each row chunk's
    shared norm statistics (2 rb floats; `norm`: QKV and fc1, which get
    them at SHARED_STATS_RB-row blocks without a K split too); the
    counters, one a tile and chunk, then two a chunk (the statistics'
    ready and reader counts)."""
    rb, chunks, ksplit = tile_split_plan(rows, k, tiles,
                                         kbuild.sm_count(device))
    stats = norm and rb >= SHARED_STATS_RB
    if ksplit == 1 and not stats:
        return 1, None, None
    units = tiles * chunks
    parts = units * ksplit * rb * TILE if ksplit > 1 else 0
    ws = torch.empty(parts + chunks * 2 * rb, dtype=torch.float32,
                     device=device)
    ctr = _counters.get(device)
    if ctr is None or ctr.numel() < units + 2 * chunks:
        ctr = torch.zeros(max(units + 2 * chunks, 1024), dtype=torch.int32,
                          device=device)
        _counters[device] = ctr
    return ksplit, ws, ctr.data_ptr()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def lora_norm(kernel: str, p, cfg: TransformerConfig):
    """The norm of `kernel`'s input as ``lora_shrink`` takes it: (NormKind,
    scale, bias or None, eps) of the layer's ln1 (QKV) or ln2 (fc1), None
    for the out-projection and fc2."""
    ln = LORA_TARGETS[kernel][1]
    if ln is None:
        return None
    return (cfg.normalization, p[f"{ln}_scale"], p.get(f"{ln}_bias"),
            cfg.layernorm_epsilon)


def lora_shrink_for(kernel: str, x, p, cfg: TransformerConfig, lora):
    """The shrink launch that `kernel`'s wrapper makes before the kernel:
    t [targets, R, rank] of its input x (QKV and fc1: bf16(norm(x)))
    through each of its targets' A bank."""
    targets = LORA_TARGETS[kernel][0]
    return cuda_lora.lora_shrink(x, [lora["banks"][t][0] for t in targets],
                                 lora["row_adapter"],
                                 lora_norm(kernel, p, cfg))


def _lora_args(kernel: str, lora, shapes: Dict[str, Tuple[int, int]],
               x, p, cfg: TransformerConfig):
    """The LoRA epilogue's launch arguments: (t and B pointers of each
    target in `shapes` order, the rows' slot ids pointer, rank), all None
    and 0 without `lora`, and t (kept alive by the caller until the launch
    is enqueued), from the shrink launched here. The fused kernel, a
    programmatic dependent of the shrink, writes its split workspace
    before it waits for the shrink, so the caller allocates that workspace
    and its outputs before this call (csrc/tensor_core.cuh's rule). Raises
    unless the banks
    are fp32, contiguous and 16-byte aligned, on the activations' device,
    A [slots, K, rank] and B [slots, rank, N] for the target's (K, N),
    1 <= rank <= MAX_RANK, with one slot id a row."""
    if lora is None:
        return [None] * (2 * len(shapes) + 1) + [0], None
    name, rows, device = f"fused_{kernel}", x.shape[0], x.device
    segs = lora["row_adapter"]
    if segs.rows != rows or segs.ids.device != device:
        raise ValueError(f"{name}: {segs.rows} row adapter ids on "
                         f"{segs.ids.device} for {rows} rows on {device}")
    bs, ranks = [], set()
    for target, (k, n) in shapes.items():
        a, b = lora["banks"][target]
        slots, rank = a.shape[0], a.shape[-1]
        ranks.add(rank)
        if tuple(a.shape) != (slots, k, rank) \
                or tuple(b.shape) != (slots, rank, n):
            raise ValueError(f"{name}: {target} banks {tuple(a.shape)} / "
                             f"{tuple(b.shape)}, expected [slots, {k}, rank] "
                             f"/ [slots, rank, {n}]")
        for t in (a, b):
            if t.dtype != torch.float32 or t.device != device \
                    or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name}: {target} banks must be "
                                 f"contiguous 16-byte aligned fp32 on "
                                 f"{device}, got {t.dtype} on {t.device}")
        bs.append(b.data_ptr())
    rank = ranks.pop()
    if ranks or not 1 <= rank <= cuda_lora.MAX_RANK:
        raise ValueError(f"{name}: LoRA rank {rank}: the epilogue takes one "
                         f"rank of 1..{cuda_lora.MAX_RANK}")
    t = lora_shrink_for(kernel, x, p, cfg, lora)
    ptrs = [v for i, b in enumerate(bs) for v in (t[i].data_ptr(), b)]
    return ptrs + [segs.ids.data_ptr(), rank], t


def _launch(symbol: str, name: str, kind: int, device: torch.device, *args,
            lora: bool = False):
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _kernel(symbol)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    counts = lora_launches if lora else launches
    counts[name + ("_int8" if kind == WEIGHT_KINDS[torch.int8] else "")] += 1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def fused_qkv(x, p, cfg: TransformerConfig, cos=None, sin=None, lora=None):
    """Norm + QKV projection + biases + QK-norm + rope, the _fused_qkv
    contract: x [R, H] (residual dtype), per-row rope tables cos/sin
    [R, half] fp32 (None without rope) → (q [R, nq, D], k, v [R, nkv, D])
    in the compute dtype; lora: the q and kv deltas (module docstring).
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return fused_qkv_plain(x, p, cfg, cos, sin, lora)
    a = p["attention"]
    mats = {"q_kernel": a["q_kernel"], "kv_kernel": a["kv_kernel"]}
    vecs = {"ln1_scale": p["ln1_scale"], "ln1_bias": p.get("ln1_bias"),
            "q_bias": a.get("q_bias"), "kv_bias": a.get("kv_bias"),
            "q_ln_scale": a.get("q_ln_scale") if cfg.qk_layernorm else None,
            "k_ln_scale": a.get("k_ln_scale") if cfg.qk_layernorm else None}
    kind, vec_f32 = _check("fused_qkv", cfg, {"x": x, "cos": cos, "sin": sin},
                           mats, vecs)
    for name in ("ln1_scale", "ln1_bias"):   # staged by 16-byte copies
        if vecs[name] is not None and vecs[name].data_ptr() % 16:
            raise ValueError(f"fused_qkv: {name} is not 16-byte aligned")
    rows, h = x.shape
    nq, nkv, d = cfg.num_attention_heads, cfg.num_query_groups, cfg.head_dim
    half = 0
    if cos is not None:
        half = cos.shape[-1]
        if cos.dtype != torch.float32 or sin.dtype != torch.float32 \
                or tuple(cos.shape) != (rows, half) \
                or tuple(sin.shape) != (rows, half) or 2 * half > d:
            raise ValueError("fused_qkv: cos/sin must be fp32 [R, half] with "
                             f"2 * half <= D {d}, got {tuple(cos.shape)}")
    shapes = {"x": (tuple(x.shape), (rows, h)),
              "q_kernel": (_shape(a["q_kernel"]), (h, nq * d)),
              "kv_kernel": (_shape(a["kv_kernel"]), (h, 2 * nkv * d))}
    for k, (got, want) in shapes.items():
        if got != want:
            raise ValueError(f"fused_qkv: {k} is {got}, expected {want}")
    q = torch.empty(rows, nq, d, dtype=torch.bfloat16, device=x.device)
    k = torch.empty(rows, nkv, d, dtype=torch.bfloat16, device=x.device)
    v = torch.empty_like(k)
    tiles = (nq + 2 * nkv) * d // TILE
    ksplit, ws, ctr = _split_buffers(rows, h, tiles, x.device, norm=True)
    (*lora_ptrs, rank), _t = _lora_args(
        "qkv", lora, {"q_kernel": (h, nq * d),
                      "kv_kernel": (h, 2 * nkv * d)}, x, p, cfg)
    (wq, sq), (wkv, skv), f = _w(a["q_kernel"]), _w(a["kv_kernel"]), vecs
    _launch("fused_qkv_launch", "qkv", kind, x.device,
            _ptr(x), _ptr(f["ln1_scale"]), _ptr(f["ln1_bias"]),
            _NORM[cfg.normalization], float(cfg.layernorm_epsilon),
            wq, wkv, sq, skv, _ptr(f["q_bias"]), _ptr(f["kv_bias"]),
            _ptr(f["q_ln_scale"]), _ptr(f["k_ln_scale"]), _ptr(cos),
            _ptr(sin), _ptr(q), _ptr(k), _ptr(v), _ptr(ws), ctr,
            rows, h, nq * d, nkv * d, d, half, kind, vec_f32, ksplit,
            *lora_ptrs, rank, lora=lora is not None)
    return q, k, v


def _residual_gemm(name: str, fc2: bool, x, w, bias, residual, p,
                   cfg: TransformerConfig, lora=None, target: str = ""):
    kind, vec_f32 = _check(f"fused_{name}", cfg,
                           {"x": x, "residual": residual}, {"kernel": w},
                           {"bias": bias})
    rows, k = x.shape
    n = _shape(w)[1]
    if _shape(w) != (k, n) or tuple(residual.shape) != (rows, n):
        raise ValueError(f"fused_{name}: x {tuple(x.shape)}, weight "
                         f"{_shape(w)} and residual "
                         f"{tuple(residual.shape)} do not fit")
    out = torch.empty_like(residual)
    ksplit, ws, ctr = _split_buffers(rows, k, n // TILE, x.device)
    (*lora_ptrs, rank), _t = _lora_args(name, lora, {target: (k, n)}, x, p,
                                        cfg)
    wp, sp = _w(w)
    _launch("fused_residual_gemm_launch", name, kind, x.device, int(fc2),
            _ptr(x), wp, sp, _ptr(bias), _ptr(residual), _ptr(out), _ptr(ws),
            ctr, rows, k, n, kind, vec_f32, ksplit, *lora_ptrs, rank,
            lora=lora is not None)
    return out


def fused_out_proj(attn_flat, p, cfg: TransformerConfig, residual,
                   lora=None):
    """Out-projection + bias + residual, the _fused_out_proj contract:
    attn_flat [R, nq·D] (compute dtype), residual [R, H] → [R, H] in the
    residual dtype; lora: the out delta from attn_flat. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if attn_flat.device.type == "cpu":
        return fused_out_proj_plain(attn_flat, p, cfg, residual, lora)
    a = p["attention"]
    return _residual_gemm("out_proj", False, attn_flat, a["out_kernel"],
                          a.get("out_bias"), residual, p, cfg, lora,
                          "out_kernel")


def fused_mlp_fc1(x, p, cfg: TransformerConfig, lora=None):
    """Pre-MLP norm + fc1 + bias + activation, the _fused_mlp_fc1
    contract: x [R, H] → y [R, ffn] in the compute dtype; lora: the fc1
    delta from the normed x, over the packed [gate | value] columns of a
    gated fc1. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if x.device.type == "cpu":
        return fused_mlp_fc1_plain(x, p, cfg, lora)
    m = p["mlp"]
    vecs = {"ln2_scale": p["ln2_scale"], "ln2_bias": p.get("ln2_bias"),
            "fc1_bias": m.get("fc1_bias")}
    kind, vec_f32 = _check("fused_mlp_fc1", cfg, {"x": x},
                           {"fc1_kernel": m["fc1_kernel"]}, vecs)
    for name in ("ln2_scale", "ln2_bias"):   # staged by 16-byte copies
        if vecs[name] is not None and vecs[name].data_ptr() % 16:
            raise ValueError(f"fused_mlp_fc1: {name} is not 16-byte aligned")
    rows, h = x.shape
    ffn = cfg.ffn_hidden_size
    gated = is_gated(cfg.activation)
    want = (h, (2 if gated else 1) * ffn)
    if _shape(m["fc1_kernel"]) != want:
        raise ValueError(f"fused_mlp_fc1: fc1_kernel is "
                         f"{_shape(m['fc1_kernel'])}, expected {want}")
    y = torch.empty(rows, ffn, dtype=torch.bfloat16, device=x.device)
    tiles = ffn // (TILE // 2 if gated else TILE)
    ksplit, ws, ctr = _split_buffers(rows, h, tiles, x.device, norm=True)
    (*lora_ptrs, rank), _t = _lora_args("mlp_fc1", lora,
                                        {"fc1_kernel": want}, x, p, cfg)
    wp, sp = _w(m["fc1_kernel"])
    _launch("fused_mlp_fc1_launch", "mlp_fc1", kind, x.device,
            _ptr(x), _ptr(vecs["ln2_scale"]), _ptr(vecs["ln2_bias"]),
            _NORM[cfg.normalization], float(cfg.layernorm_epsilon),
            wp, sp, _ptr(vecs["fc1_bias"]), _ptr(y), _ptr(ws), ctr, rows, h,
            ffn, _ACT[cfg.activation], kind, vec_f32, ksplit, *lora_ptrs,
            rank, lora=lora is not None)
    return y


def fused_mlp_fc2(y, x, p, cfg: TransformerConfig, lora=None):
    """fc2 + bias + residual, the _fused_mlp_fc2 contract: y [R, ffn]
    (compute dtype), x [R, H] the pre-norm residual → [R, H] in the
    residual dtype; lora: the fc2 delta from the activated y. CPU tensors
    run the plain version; CUDA tensors launch the kernel or raise."""
    if y.device.type == "cpu":
        return fused_mlp_fc2_plain(y, x, p, cfg, lora)
    m = p["mlp"]
    return _residual_gemm("mlp_fc2", True, y, m["fc2_kernel"],
                          m.get("fc2_bias"), x, p, cfg, lora, "fc2_kernel")
