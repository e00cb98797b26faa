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
The kernels take bf16 activations and residual, bf16 compute, and bf16
weights or fp32 weights rounded to bf16 as they load; ``kernel_limits``
names what else they refuse (the engine checks it once, through
``ops.fused_decode.megakernel_ineligible_reason``). The plain versions
follow the JAX bodies' rounding points op for op in any dtype: norm then
cast to the compute dtype, ``xn @ w`` and + bias in the compute dtype,
QK-RMSnorm, rope in fp32 cast back, the activation on the compute dtype,
``r + out.to(r.dtype)``.

K-split launches (ksplit > 1) add their partial tiles through a workspace
the wrapper allocates and a per-device counter buffer the kernels leave at
zero; kernels sharing it run on one stream, as the engine's do.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from megatronapp_tpu_torch.config.transformer_config import (
    ActivationKind, NormKind, TransformerConfig,
)
from megatronapp_tpu_torch.ops import rotary
from megatronapp_tpu_torch.ops.activations import apply_activation, is_gated
from megatronapp_tpu_torch.ops.cuda import build as kbuild
from megatronapp_tpu_torch.ops.normalization import apply_norm, rms_norm

# Launches of each kernel. Incremented only where the wrappers launch
# them (never by the plain versions).
launches: Dict[str, int] = {"qkv": 0, "out_proj": 0, "mlp_fc1": 0,
                            "mlp_fc2": 0}

SOURCE = kbuild.source("fused_decode.cu")
TILE = 128                     # output columns a block
HEAD_DIMS = (64, 128)
WEIGHT_DTYPES = (torch.bfloat16, torch.float32)
MIN_SPLIT_K = 256              # contraction rows a K-split block owns at least
MAX_SPLIT_K = 16
_NORM = {NormKind.rmsnorm: 1, NormKind.layernorm: 2}
_ACT = {ActivationKind.swiglu: 0, ActivationKind.geglu: 1,
        ActivationKind.gelu: 2, ActivationKind.relu: 3,
        ActivationKind.squared_relu: 4}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "fused_qkv_launch": [_P, _P, _P, _I, _F] + [_P] * 13 + [_I] * 8 + [_P],
    "fused_residual_gemm_launch": [_I] + [_P] * 7 + [_I] * 5 + [_P],
    "fused_mlp_fc1_launch": [_P, _P, _P, _I, _F] + [_P] * 5 + [_I] * 6
                            + [_P],
}
_counters: Dict[torch.device, torch.Tensor] = {}


def _kernel(symbol: str):
    """A bound C launcher (the source is built and loaded on first use)."""
    return kbuild.load(SOURCE, symbol, _ARGTYPES[symbol])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_qkv_plain(x, p, cfg: TransformerConfig, cos=None, sin=None):
    """Plain version of ``fused_qkv`` (the _fused_qkv body): x [R, H] →
    (q [R, nq, D], k [R, nkv, D], v [R, nkv, D]) in the compute dtype."""
    a, cdt, eps = p["attention"], cfg.compute_dtype, cfg.layernorm_epsilon
    r = x.shape[0]
    nq, nkv, d = cfg.num_attention_heads, cfg.num_query_groups, cfg.head_dim
    xn = apply_norm(cfg.normalization, x, p["ln1_scale"], p.get("ln1_bias"),
                    eps).to(cdt)
    q = xn @ a["q_kernel"].to(cdt)
    kv = xn @ a["kv_kernel"].to(cdt)
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


def fused_out_proj_plain(attn_flat, p, cfg: TransformerConfig, residual):
    """Plain version of ``fused_out_proj``: attn_flat [R, nq·D] (compute
    dtype) → residual + (attn_flat @ W_o + bias) in the residual dtype."""
    a, cdt = p["attention"], cfg.compute_dtype
    out = attn_flat @ a["out_kernel"].to(cdt)
    if "out_bias" in a:
        out = out + a["out_bias"].to(cdt)
    return residual + out.to(residual.dtype)


def fused_mlp_fc1_plain(x, p, cfg: TransformerConfig):
    """Plain version of ``fused_mlp_fc1``: x [R, H] → y [R, ffn] in the
    compute dtype (gated kinds: act(gate) * value of the packed fc1)."""
    m, cdt = p["mlp"], cfg.compute_dtype
    xn = apply_norm(cfg.normalization, x, p["ln2_scale"], p.get("ln2_bias"),
                    cfg.layernorm_epsilon).to(cdt)
    y = xn @ m["fc1_kernel"].to(cdt)
    if "fc1_bias" in m:
        y = y + m["fc1_bias"].to(cdt)
    if is_gated(cfg.activation):
        gate, val = y.chunk(2, dim=-1)
        return apply_activation(cfg.activation, val, gate)
    return apply_activation(cfg.activation, y)


def fused_mlp_fc2_plain(y, x, p, cfg: TransformerConfig):
    """Plain version of ``fused_mlp_fc2``: y [R, ffn] @ W2 + bias + the
    residual x [R, H] → [R, H] in the residual dtype."""
    m, cdt = p["mlp"], cfg.compute_dtype
    out = y @ m["fc2_kernel"].to(cdt)
    if "fc2_bias" in m:
        out = out + m["fc2_bias"].to(cdt)
    return x + out.to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels' limits and argument checks
# ---------------------------------------------------------------------------


def kernel_limits(cfg: TransformerConfig,
                  weight_dtype: Optional[torch.dtype] = None
                  ) -> Optional[str]:
    """What of `cfg` the CUDA kernels do not take, by name (None: they take
    it). weight_dtype defaults to cfg.params_dtype."""
    weight_dtype = weight_dtype or cfg.params_dtype
    h, ffn, d = cfg.hidden_size, cfg.ffn_hidden_size, cfg.head_dim
    if cfg.compute_dtype != torch.bfloat16:
        return (f"compute dtype {cfg.compute_dtype}: the fused CUDA kernels "
                "compute in bf16, and the residual stream is in the compute "
                "dtype")
    if weight_dtype not in WEIGHT_DTYPES:
        return (f"weight dtype {weight_dtype}: the fused CUDA kernels take "
                "bf16 or fp32 weights")
    if d not in HEAD_DIMS:
        return f"head_dim {d}: the fused CUDA kernels take {HEAD_DIMS}"
    cols = {"hidden_size": h, "ffn_hidden_size": ffn,
            "num_attention_heads * head_dim": cfg.num_attention_heads * d,
            "num_query_groups * head_dim": cfg.num_query_groups * d}
    for name, n in cols.items():
        if n % TILE:
            return (f"alignment: {name} = {n} is not a multiple of the "
                    f"fused CUDA kernels' {TILE}-column tile")
    return None


def _check(name: str, cfg: TransformerConfig, acts: Dict[str, torch.Tensor],
           weights: Dict[str, Optional[torch.Tensor]]):
    """Raise unless the kernel can take these tensors: one CUDA device,
    contiguous, bf16 activations, one weight dtype of WEIGHT_DTYPES, 16-byte
    aligned matrices and the kernel limits of `cfg`."""
    dev = acts["x"].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} — the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    given = {k: t for k, t in {**acts, **weights}.items() if t is not None}
    for k, t in given.items():
        if t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    for k, t in acts.items():
        if t is not None and t.dtype != torch.bfloat16 \
                and k not in ("cos", "sin"):
            raise ValueError(f"{name}: {k} is {t.dtype}; the kernel takes "
                             "bf16 activations")
    wdt = {t.dtype for k, t in weights.items() if t is not None}
    if len(wdt) != 1 or not wdt <= set(WEIGHT_DTYPES):
        raise ValueError(f"{name}: weights in {sorted(map(str, wdt))}; the "
                         "kernel takes one of bf16 or fp32 for all of them")
    reason = kernel_limits(cfg, wdt.pop())
    if reason:
        raise ValueError(f"{name}: {reason}")
    for k, t in given.items():
        if t.dim() == 2 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} is not 16-byte aligned")


def _plan(rows: int, k: int, tiles: int, device: torch.device):
    """(row block, row chunks, ksplit): K-split blocks enough that the
    grid holds about two blocks per SM, each owning at least MIN_SPLIT_K
    contraction rows."""
    rb = 8 if rows <= 8 else 32
    chunks = -(-rows // rb)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ksplit = max(1, min(-(-2 * sms // (tiles * chunks)), k // MIN_SPLIT_K,
                        MAX_SPLIT_K))
    return rb, chunks, ksplit


def _split_buffers(rows: int, k: int, tiles: int, device: torch.device):
    """(ksplit, workspace tensor, counters pointer) for one launch; the
    caller keeps the workspace alive until the launch is enqueued."""
    rb, chunks, ksplit = _plan(rows, k, tiles, device)
    if ksplit == 1:
        return 1, None, None
    units = tiles * chunks
    ws = torch.empty(units * ksplit * rb * TILE, dtype=torch.float32,
                     device=device)
    ctr = _counters.get(device)
    if ctr is None or ctr.numel() < units:
        ctr = torch.zeros(max(units, 1024), dtype=torch.int32, device=device)
        _counters[device] = ctr
    return ksplit, ws, ctr.data_ptr()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(symbol: str, name: str, device: torch.device, *args):
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _kernel(symbol)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def fused_qkv(x, p, cfg: TransformerConfig, cos=None, sin=None):
    """Norm + QKV projection + biases + QK-norm + rope, the _fused_qkv
    contract: x [R, H] (residual dtype), per-row rope tables cos/sin
    [R, half] fp32 (None without rope) → (q [R, nq, D], k, v [R, nkv, D])
    in the compute dtype. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    if x.device.type == "cpu":
        return fused_qkv_plain(x, p, cfg, cos, sin)
    a = p["attention"]
    weights = {"ln1_scale": p["ln1_scale"], "ln1_bias": p.get("ln1_bias"),
               "q_kernel": a["q_kernel"], "kv_kernel": a["kv_kernel"],
               "q_bias": a.get("q_bias"), "kv_bias": a.get("kv_bias"),
               "q_ln_scale": a.get("q_ln_scale") if cfg.qk_layernorm else None,
               "k_ln_scale": a.get("k_ln_scale") if cfg.qk_layernorm else None}
    _check("fused_qkv", cfg, {"x": x, "cos": cos, "sin": sin}, weights)
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
              "q_kernel": (tuple(a["q_kernel"].shape), (h, nq * d)),
              "kv_kernel": (tuple(a["kv_kernel"].shape), (h, 2 * nkv * d))}
    for k, (got, want) in shapes.items():
        if got != want:
            raise ValueError(f"fused_qkv: {k} is {got}, expected {want}")
    q = torch.empty(rows, nq, d, dtype=torch.bfloat16, device=x.device)
    k = torch.empty(rows, nkv, d, dtype=torch.bfloat16, device=x.device)
    v = torch.empty_like(k)
    tiles = (nq + 2 * nkv) * d // TILE
    ksplit, ws, ctr = _split_buffers(rows, h, tiles, x.device)
    w = weights
    _launch("fused_qkv_launch", "qkv", x.device,
            _ptr(x), _ptr(w["ln1_scale"]), _ptr(w["ln1_bias"]),
            _NORM[cfg.normalization], float(cfg.layernorm_epsilon),
            _ptr(w["q_kernel"]), _ptr(w["kv_kernel"]), _ptr(w["q_bias"]),
            _ptr(w["kv_bias"]), _ptr(w["q_ln_scale"]), _ptr(w["k_ln_scale"]),
            _ptr(cos), _ptr(sin), _ptr(q), _ptr(k), _ptr(v), _ptr(ws), ctr,
            rows, h, nq * d, nkv * d, d, half,
            int(w["q_kernel"].dtype == torch.float32), ksplit)
    return q, k, v


def _residual_gemm(name: str, fc2: bool, x, w, bias, residual,
                   cfg: TransformerConfig):
    _check(f"fused_{name}", cfg, {"x": x, "residual": residual},
           {"kernel": w, "bias": bias})
    rows, k = x.shape
    n = w.shape[1]
    if tuple(w.shape) != (k, n) or tuple(residual.shape) != (rows, n):
        raise ValueError(f"fused_{name}: x {tuple(x.shape)}, weight "
                         f"{tuple(w.shape)} and residual "
                         f"{tuple(residual.shape)} do not fit")
    out = torch.empty_like(residual)
    ksplit, ws, ctr = _split_buffers(rows, k, n // TILE, x.device)
    _launch("fused_residual_gemm_launch", name, x.device, int(fc2), _ptr(x),
            _ptr(w), _ptr(bias), _ptr(residual), _ptr(out), _ptr(ws), ctr,
            rows, k, n, int(w.dtype == torch.float32), ksplit)
    return out


def fused_out_proj(attn_flat, p, cfg: TransformerConfig, residual):
    """Out-projection + bias + residual, the _fused_out_proj contract:
    attn_flat [R, nq·D] (compute dtype), residual [R, H] → [R, H] in the
    residual dtype. CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    if attn_flat.device.type == "cpu":
        return fused_out_proj_plain(attn_flat, p, cfg, residual)
    a = p["attention"]
    return _residual_gemm("out_proj", False, attn_flat, a["out_kernel"],
                          a.get("out_bias"), residual, cfg)


def fused_mlp_fc1(x, p, cfg: TransformerConfig):
    """Pre-MLP norm + fc1 + bias + activation, the _fused_mlp_fc1
    contract: x [R, H] → y [R, ffn] in the compute dtype. CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return fused_mlp_fc1_plain(x, p, cfg)
    m = p["mlp"]
    weights = {"ln2_scale": p["ln2_scale"], "ln2_bias": p.get("ln2_bias"),
               "fc1_kernel": m["fc1_kernel"], "fc1_bias": m.get("fc1_bias")}
    _check("fused_mlp_fc1", cfg, {"x": x}, weights)
    rows, h = x.shape
    ffn = cfg.ffn_hidden_size
    gated = is_gated(cfg.activation)
    want = (h, (2 if gated else 1) * ffn)
    if tuple(m["fc1_kernel"].shape) != want:
        raise ValueError(f"fused_mlp_fc1: fc1_kernel is "
                         f"{tuple(m['fc1_kernel'].shape)}, expected {want}")
    y = torch.empty(rows, ffn, dtype=torch.bfloat16, device=x.device)
    tiles = ffn // (TILE // 2 if gated else TILE)
    ksplit, ws, ctr = _split_buffers(rows, h, tiles, x.device)
    _launch("fused_mlp_fc1_launch", "mlp_fc1", x.device,
            _ptr(x), _ptr(weights["ln2_scale"]), _ptr(weights["ln2_bias"]),
            _NORM[cfg.normalization], float(cfg.layernorm_epsilon),
            _ptr(m["fc1_kernel"]), _ptr(weights["fc1_bias"]), _ptr(y),
            _ptr(ws), ctr, rows, h, ffn, _ACT[cfg.activation],
            int(m["fc1_kernel"].dtype == torch.float32), ksplit)
    return y


def fused_mlp_fc2(y, x, p, cfg: TransformerConfig):
    """fc2 + bias + residual, the _fused_mlp_fc2 contract: y [R, ffn]
    (compute dtype), x [R, H] the pre-norm residual → [R, H] in the
    residual dtype. CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    if y.device.type == "cpu":
        return fused_mlp_fc2_plain(y, x, p, cfg)
    m = p["mlp"]
    return _residual_gemm("mlp_fc2", True, y, m["fc2_kernel"],
                          m.get("fc2_bias"), x, cfg)
