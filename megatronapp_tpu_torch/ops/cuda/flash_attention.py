"""Flash attention: the three CUDA kernels' wrappers, their plain versions
and their launch counters.

The kernels (csrc/flash_attention.cu) replace the TPU kernels of
``megatronapp_tpu/ops/pallas/flash_attention.py``:

- ``flash_fwd`` ← ``_flash_forward`` / ``_flash_forward_t`` (out and LSE);
- ``flash_bwd_dq`` ← the dq kernels of ``_flash_backward``,
  ``_flash_backward_t`` and ``_flash_backward_fold``;
- ``flash_bwd_dkv`` ← their dk/dv kernels, with the GQA group summed
  inside the block.

At the training shapes they are bound by operations. All three run every
product on the tensor cores (``mma.sync`` on bf16 tiles that ``cp.async``
loads ahead of use, the probabilities reused in registers): the forward
rounds q times the scale and P to bf16 as the TPU kernel does, and the
backward pair also rounds p and ds to bf16 before dv and dk, where the
TPU kernel keeps them fp32. The source note (csrc/flash_attention.cu)
gives the designs.

``flash_forward`` and ``flash_backward`` take the plain versions only for
tensors that lie on the CPU. For CUDA tensors they launch the kernels or
raise: there is no fallback. The plain versions compute the same
functions densely, from the LSE (the FlashAttention-2 recipe), with the
kernels' roundings to the input dtype (q times the scale, P before PV,
p and ds before dv and dk), so that bf16 inputs give what the kernels
give up to summation order.

Layouts: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] (any batch, sequence and
head strides; the head dim contiguous), lse and delta [B, Hq, Sq] fp32,
segment_ids [B, S] int.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from megatronapp_tpu_torch.ops.cuda import build as kbuild

NEG_INF = -1e30

# Launches of each kernel. Incremented only where the wrappers launch
# them (never by the plain versions).
launches: Dict[str, int] = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

SOURCE = kbuild.source("flash_attention.cu")
HEAD_DIMS = (64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P]
_DQ_ARGS = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _P]
_DKV_ARGS = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P]


def _scale(softmax_scale, d):
    return 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale


def _valid_mask(sq: int, skv: int, causal: bool, segment_ids, device):
    """[B or 1, 1, Sq, Skv] bool: the causal triangle (q row >= kv row, no
    offset, as the TPU kernel's _valid_mask) and equal segment ids."""
    valid = torch.ones(1, 1, sq, skv, dtype=torch.bool, device=device)
    if causal:
        rows = torch.arange(sq, device=device)[:, None]
        cols = torch.arange(skv, device=device)[None, :]
        valid = valid & (rows >= cols)
    if segment_ids is not None:
        seg = segment_ids.to(device)
        valid = valid & (seg[:, None, :, None] == seg[:, None, None, :])
    return valid


def flash_forward_plain(q, k, v, causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        segment_ids=None):
    """Plain version of flash_fwd → (out [B, Sq, Hq, D] in q's dtype, lse
    [B, Hq, Sq] fp32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = _scale(softmax_scale, d)
    qr = (q.float() * scale).to(k.dtype).float()
    kk = k.float().repeat_interleave(group, dim=2)
    vv = v.float().repeat_interleave(group, dim=2)
    valid = _valid_mask(sq, skv, causal, segment_ids, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qr, kk).masked_fill(~valid, NEG_INF)
    m_safe = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF / 2)
    p = torch.exp(s - m_safe).masked_fill(~valid, 0.0)
    del s
    l = p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vv)
    out = pv / l.clamp(min=1e-20).transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m_safe[..., 0] + torch.log(l.clamp(min=1e-20)),
                      torch.full_like(l, NEG_INF))
    return out.to(q.dtype), lse


def _plain_ds(q, k, v, g, lse, delta, causal, softmax_scale, segment_ids):
    """(p, ds, scaled q, repeated k) of the backward, fp32 [B, Hq, Sq, Skv]:
    p = exp(s - lse) and ds = p (dp - delta) on the valid pairs, with the
    kernels' roundings (s from bf16-rounded scaled q, dp from g in V's
    dtype)."""
    hq, d = q.shape[2], q.shape[3]
    group = hq // k.shape[2]
    scale = _scale(softmax_scale, d)
    qs = q.float() * scale
    kk = k.float().repeat_interleave(group, dim=2)
    vv = v.float().repeat_interleave(group, dim=2)
    valid = _valid_mask(q.shape[1], k.shape[1], causal, segment_ids,
                        q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.to(k.dtype).float(), kk)
    p = torch.exp(s - lse[..., None]).masked_fill(~valid, 0.0)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(v.dtype).float(), vv)
    ds = (p * (dp - delta[..., None])).masked_fill(~valid, 0.0)
    return p, ds, qs, kk


def flash_bwd_dq_plain(q, k, v, g, lse, delta, causal: bool = True,
                       softmax_scale: Optional[float] = None,
                       segment_ids=None):
    """Plain version of flash_bwd_dq → dq [B, Sq, Hq, D] in q's dtype:
    bf16(ds) · k, times the scale."""
    _, ds, _, kk = _plain_ds(q, k, v, g, lse, delta, causal, softmax_scale,
                             segment_ids)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kk)
    return (dq * _scale(softmax_scale, q.shape[3])).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        segment_ids=None):
    """Plain version of flash_bwd_dkv → (dk, dv) [B, Skv, Hkv, D]:
    ds^T · (q scale) and p^T · g summed over the GQA group, with p and ds
    rounded to the input dtype first, as the kernel rounds its tensor-core
    operands (a no-op for fp32 inputs; the TPU kernel keeps them fp32)."""
    b, _, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    p, ds, qs, _ = _plain_ds(q, k, v, g, lse, delta, causal, softmax_scale,
                             segment_ids)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(k.dtype).float(), qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), g.float())
    dk = dk.reshape(b, skv, hkv, hq // hkv, d).sum(dim=3)
    dv = dv.reshape(b, skv, hkv, hq // hkv, d).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, g, lse, delta, causal: bool = True,
                         softmax_scale: Optional[float] = None,
                         segment_ids=None):
    """Plain versions of both backward kernels → (dq, dk, dv) in the
    dtypes of q, k, v. g is the output's cotangent [B, Sq, Hq, D]."""
    args = (q, k, v, g, lse, delta, causal, softmax_scale, segment_ids)
    return (flash_bwd_dq_plain(*args),) + flash_bwd_dkv_plain(*args)


def _strides(*ts):
    vals = []
    for t in ts:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check(q, k, v, segment_ids, g=None):
    named = {"q": q, "k": k, "v": v}
    if g is not None:
        named["g"] = g
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"flash attention: tensors on {dev} — the kernels take CUDA "
            "tensors and the plain versions CPU tensors")
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"flash attention: {name} on {t.device}, q on "
                             f"{dev}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash attention: {name} is {t.dtype}; the "
                             "kernels take bf16")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"flash attention: {name} must be [B, S, H, D] "
                             "with a contiguous head dim")
        if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)):
            raise ValueError(f"flash attention: {name} is not 16-byte "
                             "aligned (pointer and strides)")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or hq % k.shape[2] or (g is not None and g.shape != q.shape):
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if d not in HEAD_DIMS or b > 65535 or hq > 65535:
        raise ValueError(f"flash attention: head_dim {d} (takes "
                         f"{HEAD_DIMS}), batch {b}, heads {hq}")
    if segment_ids is not None:
        if segment_ids.device != dev or segment_ids.dtype != torch.int32 \
                or not segment_ids.is_contiguous() \
                or tuple(segment_ids.shape) != (b, sq) or k.shape[1] != sq:
            raise ValueError("flash attention: segment_ids must be a "
                             "contiguous int32 [B, S] on q's device, with "
                             "Sq == Skv")


def flash_forward(q, k, v, causal: bool = True,
                  softmax_scale: Optional[float] = None, segment_ids=None):
    """(out [B, Sq, Hq, D], lse [B, Hq, Sq] fp32). CPU tensors run the
    plain version; CUDA tensors launch flash_fwd or raise."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, softmax_scale,
                                   segment_ids)
    _check(q, k, v, segment_ids)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty(b, sq, hq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    fn = kbuild.load(SOURCE, "flash_fwd_launch", _FWD_ARGS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if segment_ids is None else segment_ids.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _strides(q, k, v, q),
            b, sq, skv, hq, hkv, d, int(causal),
            float(_scale(softmax_scale, d)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    launches["fwd"] += 1
    return out, lse


def attention_delta(out, g):
    """delta = sum(g · out) over D in fp32, [B, Hq, Sq] (computed outside
    the kernels, as flash_attention.py:994)."""
    return (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_launch(kernel: str, q, k, v, g, lse, delta, outs, causal,
                softmax_scale, segment_ids):
    _check(q, k, v, segment_ids, g)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != (b, hq, sq) or t.device != q.device:
            raise ValueError(f"flash attention: {name} must be contiguous "
                             f"fp32 [B, Hq, Sq] on q's device")
    args = _DQ_ARGS if kernel == "bwd_dq" else _DKV_ARGS
    fn = kbuild.load(SOURCE, f"flash_{kernel}_launch", args)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if segment_ids is None else segment_ids.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs), _strides(q, k, v, g),
            b, sq, skv, hq, hkv, d, int(causal),
            float(_scale(softmax_scale, d)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_{kernel} kernel launch failed: CUDA "
                           f"error {rc}")
    launches[kernel] += 1


def flash_bwd_dq(q, k, v, g, lse, delta, causal: bool = True,
                 softmax_scale: Optional[float] = None, segment_ids=None):
    """dq [B, Sq, Hq, D]. CPU tensors run the plain version; CUDA tensors
    launch flash_bwd_dq or raise."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, causal,
                                  softmax_scale, segment_ids)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("bwd_dq", q, k, v, g, lse, delta, (dq,), causal,
                softmax_scale, segment_ids)
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, causal: bool = True,
                  softmax_scale: Optional[float] = None, segment_ids=None):
    """(dk, dv) [B, Skv, Hkv, D]. CPU tensors run the plain version; CUDA
    tensors launch flash_bwd_dkv or raise."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal,
                                   softmax_scale, segment_ids)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _bwd_launch("bwd_dkv", q, k, v, g, lse, delta, (dk, dv), causal,
                softmax_scale, segment_ids)
    return dk, dv


def flash_backward(q, k, v, out, lse, g, causal: bool = True,
                   softmax_scale: Optional[float] = None, segment_ids=None):
    """(dq, dk, dv) from the forward's (out, lse) and the cotangent g:
    delta = sum(g · out) in plain torch (flash_attention.py:994), then
    flash_bwd_dq and flash_bwd_dkv (or, for CPU tensors, their plain
    versions)."""
    delta = attention_delta(out, g)
    args = (q, k, v, g, lse, delta, causal, softmax_scale, segment_ids)
    return (flash_bwd_dq(*args),) + flash_bwd_dkv(*args)
