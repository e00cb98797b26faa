"""MegaScope capture hooks (identity unless enabled): the JAX package's
scope/hooks.py.

A capture site hands a compressed copy of a tensor to the host sink and
returns the tensor itself, so every output with capture on is the same
bits as with it off. The copy is made on the tensor's device (the
feature dim bucketed to ``compress_pixels`` means) and reaches the sink
as one host array a capture. Eager PyTorch needs no re-trace when capture
is toggled: a site reads the thread-local state each time it runs. Its
layer id is a Python int, so a ``wants(site, layer_id)`` predicate (the
TensorTracer's per-layer flags) decides before any copy is made: a site
that is not wanted costs neither the compression nor a host copy. The
state is thread-local because the server activates it in its worker
thread.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch


class FlagType(enum.IntEnum):
    """The reference's tensor_tracer.py:66-74 FlagType values (the wire
    contract with the frontend)."""
    QKV_mat_mul = 0
    RawAttentionScore = 1
    ContextLayer = 2
    MLP1 = 3
    MLP2 = 4
    Result = 5
    MLP2_Plot = 6


_SITE_TO_FLAG = {
    "qkv_q": FlagType.QKV_mat_mul,
    "qkv_k": FlagType.QKV_mat_mul,
    "qkv_v": FlagType.QKV_mat_mul,
    "attention_probs": FlagType.RawAttentionScore,
    "context": FlagType.ContextLayer,
    "mlp1": FlagType.MLP1,
    "mlp2": FlagType.MLP2,
    "result": FlagType.Result,
}


class _ScopeState(threading.local):
    def __init__(self):
        self.enabled = False
        self.sites: Dict[str, bool] = {}
        self.wants: Optional[Callable] = None
        self.sink: Optional[Callable] = None
        self.compress_pixels: int = 0


_state = _ScopeState()


def configure(enabled: bool, sites: Optional[Dict[str, bool]] = None,
              sink: Optional[Callable] = None, compress_pixels: int = 64,
              wants: Optional[Callable] = None):
    """Enable/disable capture in this thread. ``sink(site, layer_id,
    array)`` is called with a host (numpy) array. ``wants(site,
    layer_id)``, when given, takes the place of ``sites``; layer_id None
    there asks whether the site is wanted on any layer."""
    _state.enabled = enabled
    _state.sites = sites or {}
    _state.wants = wants
    _state.sink = sink
    _state.compress_pixels = compress_pixels


def is_enabled(site: str, layer_id=None) -> bool:
    if not _state.enabled or _state.sink is None:
        return False
    if _state.wants is not None:
        return bool(_state.wants(site, layer_id))
    return _state.sites.get(site, False)


def _compress(x: torch.Tensor, pixels: int) -> torch.Tensor:
    """Bucket the feature dim to `pixels` means, on x's device (the
    reference Compressor's default method, data.mean(dim=-1))."""
    x = x.detach()
    if pixels <= 0 or x.shape[-1] <= pixels:
        return x.float()
    chunk = x.shape[-1] // pixels
    trimmed = x[..., : pixels * chunk].float()
    return trimmed.reshape(*x.shape[:-1], pixels, chunk).mean(-1)


def capture_payload(site: str, layer_id, arr) -> dict:
    """The capture wire payload (update_type = FlagType value, layer_id,
    result), shared by the training WS server and the inference server."""
    flag = _SITE_TO_FLAG.get(site)
    return {
        "update_type": int(flag) if flag is not None else -1,
        "site": site,
        "layer_id": int(layer_id) if layer_id is not None else -1,
        "result": np.asarray(arr, np.float64).tolist(),
    }


def scope_capture(site: str, x: torch.Tensor, layer_id=None
                  ) -> torch.Tensor:
    """Identity that, when the site is enabled, also hands a compressed
    host copy of x to the sink (layer_id None reaches it as -1)."""
    if not is_enabled(site, layer_id):
        return x
    compressed = _compress(x, _state.compress_pixels)
    _state.sink(site, -1 if layer_id is None else int(layer_id),
                compressed.cpu().numpy())
    return x
