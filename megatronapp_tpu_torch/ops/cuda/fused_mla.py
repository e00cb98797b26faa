"""The fused MLA prologue: its CUDA wrapper, plain version, launch counters
and build.

``fused_mla_qkv`` replaces the TPU kernel
``megatronapp_tpu/ops/pallas/kernel_gen.py:_fused_mla_qkv``: the
pre-attention norm, the q path (q_proj, or q_down → RMSNorm → q_up), the
rope of the decoupled q_pe heads, the absorption of q_nope through kv_up's
k_nope columns (× YaRN's mscale²), then kv_down → the RMS-normed latent
row and the roped shared k_pe row. One CUDA kernel cannot hold the TPU
kernel's no-grid body at llama3-8b widths (~59 MB of weights at 8 rows),
so it runs as two launches of csrc/fused_mla.cu, ``mla_down`` (the
column-tiled products, q_pe and k_pe roped in their tiles) and ``mla_up``
(the absorption a (head, 64 latent columns) a block, or on the q_lora path
the head's q_up product and absorption a block; the latent norm a row a
block). Every product runs on the tensor cores (``mma.sync``, bf16
operands as the JAX body rounds them, fp32 sums), its weights streamed
through a ``cp.async`` ring; the source note says how the work splits and
what bounds it.

The plain version stops at the JAX body's rounding points
(kernel_gen.py:1468-1493): the norm cast to the compute dtype, each product
in the compute dtype, q_nope × m² before the einsum. The wrapper takes it
only for tensors on the CPU; for CUDA tensors it launches the kernels or
raises. The kernels take bf16 activations, weights and norm vectors, at
most ``MAX_ROWS`` rows, qk_head_dim and the latent width in multiples of 64
and a 64-wide qk_pos_emb_head_dim (``kernel_limits``), each tensor on a
16-byte boundary (the copies move 16 bytes).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from megatronapp_tpu_torch.config.transformer_config import (
    NormKind, TransformerConfig,
)
from megatronapp_tpu_torch.ops import rotary
from megatronapp_tpu_torch.ops.cuda import build as kbuild
from megatronapp_tpu_torch.ops.normalization import apply_norm, rms_norm
from megatronapp_tpu_torch.transformer.mla import kv_up_heads, yarn_m

# Launches of the two kernels. Incremented only where the wrapper launches
# them (never by the plain version).
launches: Dict[str, int] = {"mla_down": 0, "mla_up": 0}

SOURCE = kbuild.source("fused_mla.cu")
TILE = 64
MAX_ROWS = 32
_NORM = {NormKind.rmsnorm: 1, NormKind.layernorm: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I] + [_P] * 18 + [_I] * 10 + [_F, _F, _P]
_WEIGHTS = ("q_proj", "q_down", "q_ln_scale", "q_up", "kv_down",
            "kv_ln_scale", "kv_up")


def _kernel():
    """The bound C launcher (built and loaded on first use)."""
    return kbuild.load(SOURCE, "fused_mla_launch", _ARGTYPES)


def fused_mla_qkv_plain(x, p, cfg: TransformerConfig, cos=None, sin=None):
    """Plain version of ``fused_mla_qkv`` (the _fused_mla_qkv body): x [R,
    H] (residual dtype) → (q_lat [R, nq, klat], q_pe [R, nq, dpe], latent
    [R, klat], k_pe [R, dpe]) in the compute dtype."""
    a, cdt, eps = p["attention"], cfg.compute_dtype, cfg.layernorm_epsilon
    r = x.shape[0]
    nq, dqk = cfg.num_attention_heads, cfg.qk_head_dim
    klat = cfg.kv_lora_rank
    xn = apply_norm(cfg.normalization, x, p["ln1_scale"], p.get("ln1_bias"),
                    eps).to(cdt)
    if "q_down" in a:
        q = rms_norm(xn @ a["q_down"].to(cdt), a["q_ln_scale"], eps)
        q = q @ a["q_up"].to(cdt)
    else:
        q = xn @ a["q_proj"].to(cdt)
    q = q.reshape(r, nq, -1)
    q_nope, q_pe = q[..., :dqk], q[..., dqk:]
    kv = xn @ a["kv_down"].to(cdt)
    latent = rms_norm(kv[:, :klat], a["kv_ln_scale"], eps)
    k_pe = kv[:, klat:]
    if cos is not None:   # per-row tables [R, half]: the [R, 1] rope shape
        q_pe = rotary.apply_rope(q_pe[:, None], cos[:, None],
                                 sin[:, None])[:, 0]
        k_pe = rotary.apply_rope(k_pe[:, None, None], cos[:, None],
                                 sin[:, None])[:, 0, 0]
    m2 = yarn_m(cfg) ** 2
    q_abs = q_nope * m2 if m2 != 1.0 else q_nope
    q_lat = torch.einsum("bnd,knd->bnk", q_abs, kv_up_heads(a, cfg)[0])
    return q_lat, q_pe.contiguous(), latent.contiguous(), k_pe.contiguous()


def kernel_limits(cfg: TransformerConfig, rows: int = 1,
                  layer=None) -> Optional[str]:
    """What of `cfg` (and of `layer`'s dtypes) the prologue kernels do not
    take, by name; None when they take it."""
    if cfg.compute_dtype != torch.bfloat16:
        return (f"compute dtype {cfg.compute_dtype}: the fused MLA prologue "
                "computes in bf16")
    if rows > MAX_ROWS:
        return (f"{rows} rows: the fused MLA prologue takes at most "
                f"{MAX_ROWS} rows a launch")
    dqk, dpe = cfg.qk_head_dim, cfg.qk_pos_emb_head_dim
    widths = {"qk_head_dim": dqk, "kv_lora_rank": cfg.kv_lora_rank}
    if cfg.q_lora_rank:
        widths["q_lora_rank"] = cfg.q_lora_rank
    for name, n in widths.items():
        if n % TILE or n < TILE:
            return (f"alignment: {name} = {n} is not a multiple of the fused "
                    f"MLA prologue's {TILE}-column tile")
    if dqk > 256 or dpe != TILE or cfg.v_head_dim % 8 \
            or cfg.hidden_size % 8:
        return (f"qk_head_dim {dqk} (at most 256), qk_pos_emb_head_dim {dpe} "
                f"(the prologue ropes one {TILE}-column tile), v_head_dim "
                f"{cfg.v_head_dim} and hidden_size {cfg.hidden_size} "
                "(multiples of 8: 16-byte loads)")
    if layer is not None:
        leaves = [layer["ln1_scale"], layer.get("ln1_bias")]
        leaves += [layer["attention"].get(n) for n in _WEIGHTS]
        if any(t is not None and (not isinstance(t, torch.Tensor)
                                  or t.dtype != torch.bfloat16)
               for t in leaves):
            return ("MLA q/kv weights and norm vectors must be bf16 tensors "
                    "for the fused MLA prologue")
    return None


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_mla_qkv(x, p, cfg: TransformerConfig, cos=None, sin=None):
    """Norm + the MLA q path + rope + absorption + the latent and k_pe rows,
    the _fused_mla_qkv contract: x [R, H] (residual dtype), per-row rope
    tables cos/sin [R, dpe/2] fp32 (None without rope) → (q_lat [R, nq,
    klat], q_pe [R, nq, dpe], latent [R, klat], k_pe [R, dpe]) in the
    compute dtype. CPU tensors run the plain version; CUDA tensors launch
    the two kernels or raise."""
    if x.device.type == "cpu":
        return fused_mla_qkv_plain(x, p, cfg, cos, sin)
    a = p["attention"]
    dev = x.device
    rows, h = x.shape
    if dev.type != "cuda":
        raise ValueError(f"fused_mla_qkv: tensors on {dev} — the kernels "
                         "take CUDA tensors and the plain version CPU "
                         "tensors")
    reason = kernel_limits(cfg, rows, p)
    if reason is not None:
        raise ValueError(f"fused_mla_qkv: {reason}")
    nq, dqk, dpe = (cfg.num_attention_heads, cfg.qk_head_dim,
                    cfg.qk_pos_emb_head_dim)
    dv, klat = cfg.v_head_dim, cfg.kv_lora_rank
    lora = "q_down" in a
    qlr = cfg.q_lora_rank if lora else 0
    dq = nq * (dqk + dpe)
    want = {"x": (rows, h), "ln1_scale": (h,), "kv_down": (h, klat + dpe),
            "kv_ln_scale": (klat,), "kv_up": (klat, nq * (dqk + dv))}
    want.update({"q_down": (h, qlr), "q_ln_scale": (qlr,), "q_up": (qlr, dq)}
                if lora else {"q_proj": (h, dq)})
    if "ln1_bias" in p:
        want["ln1_bias"] = (h,)
    tensors = {"x": x, "ln1_scale": p["ln1_scale"],
               "ln1_bias": p.get("ln1_bias"),
               **{n: a.get(n) for n in _WEIGHTS}}
    for name, shape in want.items():
        t = tensors[name]
        if t is None or tuple(t.shape) != shape or t.device != dev \
                or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"fused_mla_qkv: {name} must be a contiguous, 16-byte "
                f"aligned bf16 {shape} tensor on {dev}, got "
                f"{None if t is None else (t.dtype, tuple(t.shape))}")
    half = 0
    if cos is not None:
        half = cos.shape[-1]
        for t in (cos, sin):
            if t.dtype != torch.float32 or tuple(t.shape) != (rows, half) \
                    or not t.is_contiguous() or t.device != dev:
                raise ValueError("fused_mla_qkv: cos/sin must be contiguous "
                                 f"fp32 [R, half] on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    bf = dict(dtype=torch.bfloat16, device=dev)
    q_lat = torch.empty(rows, nq, klat, **bf)
    q_pe = torch.empty(rows, nq, dpe, **bf)
    latent = torch.empty(rows, klat, **bf)
    k_pe = torch.empty(rows, dpe, **bf)
    ws_q = torch.empty(rows, qlr if lora else nq * dqk, **bf)
    ws_lat = torch.empty(rows, klat, **bf)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _kernel()
    for stage, name in enumerate(("mla_down", "mla_up")):
        rc = fn(stage, _ptr(x), _ptr(p["ln1_scale"]), _ptr(p.get("ln1_bias")),
                _ptr(a.get("q_proj")), _ptr(a.get("q_down")),
                _ptr(a.get("q_ln_scale")), _ptr(a.get("q_up")),
                _ptr(a["kv_down"]), _ptr(a["kv_ln_scale"]), _ptr(a["kv_up"]),
                _ptr(cos), _ptr(sin), _ptr(q_lat), _ptr(q_pe), _ptr(latent),
                _ptr(k_pe), _ptr(ws_q), _ptr(ws_lat), rows, h, nq, dqk, dpe,
                dv, klat, qlr, half, _NORM[cfg.normalization],
                float(cfg.layernorm_epsilon), float(yarn_m(cfg) ** 2),
                stream)
        if rc != 0:
            raise RuntimeError(f"fused_mla_qkv: {name} kernel launch failed:"
                               f" CUDA error {rc}")
        launches[name] += 1
    return q_lat, q_pe, latent, k_pe
