"""MegaScope tensor tracer: capture → compress → report pipeline (the
JAX package's scope/tensor_tracer.py).

The reference's megatron/core/tensor_tracer.py:
- FlagType per-layer on/off flags (:66-74, wire contract in scope/hooks.py);
- Compressor (:76-122): bucket the feature dim to `pixels` means (or a named
  reduction) before shipping to the frontend;
- TensorTracers.report (:125-183): captures see the whole tensor of one
  device, so the reference's tensor-parallel re-concat has nothing to do;
- tik_result (:189-209): per-token softmax + sampled token + top-20
  candidates with decoded text;
- tik_end PCA (:212-223): 2-component PCA of accumulated MLP records
  (sklearn, with a numpy-SVD fallback).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from megatronapp_tpu_torch.scope.hooks import (
    _SITE_TO_FLAG, FlagType, configure,
)


class Compressor:
    """Reference Compressor: chunk the last dim into `pixels` buckets and
    reduce each with a named method."""

    METHODS = {
        "mean": lambda x: x.mean(-1),
        "max": lambda x: x.max(-1),
        "min": lambda x: x.min(-1),
        "norm": lambda x: np.linalg.norm(x, axis=-1),
        "first": lambda x: x[..., 0],
    }

    def __init__(self, pixels: int = 64, method: str = "mean"):
        self.pixels = pixels
        if method not in self.METHODS:
            raise ValueError(
                f"compressor method must be one of {sorted(self.METHODS)}, "
                f"got {method!r}")
        self.method = method

    def __call__(self, data: np.ndarray) -> np.ndarray:
        feat = data.shape[-1]
        if self.pixels <= 0 or feat <= self.pixels:
            return np.asarray(data, np.float32)
        chunk = feat // self.pixels
        trimmed = np.asarray(data[..., : self.pixels * chunk], np.float32)
        buckets = trimmed.reshape(*data.shape[:-1], self.pixels, chunk)
        return self.METHODS[self.method](buckets)


class TensorTracer:
    """Singleton-style per-process tracer (reference TensorTracers).

    activate() wires scope.hooks so model-side scope_capture calls stream
    the compressed tensors of the flagged (site, layer) pairs into
    `report_func(site, layer_id, array)`.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.flags: Dict[int, set] = defaultdict(set)  # layer -> FlagTypes
        self.compressor = Compressor()
        self.report_func: Optional[Callable] = None
        self.mlp2_records: List[np.ndarray] = []
        self.enabled = False

    # -- flag control (reference tt_flags set/unset :225-266) --------------
    def set_flag(self, layer_id: int, flag: FlagType):
        self.flags[layer_id].add(flag)

    def unset_flag(self, layer_id: int, flag: FlagType):
        self.flags[layer_id].discard(flag)

    def set_flags_from_config(self, config: Dict[str, List[int]]):
        """config: {flag name: [layer ids]} — the WS wire format."""
        self.flags.clear()
        for name, layers in config.items():
            flag = FlagType[name]
            for lid in layers:
                self.flags[int(lid)].add(flag)

    def _site_enabled(self, site: str, layer_id) -> bool:
        flag = _SITE_TO_FLAG.get(site)
        if flag is None:
            return False
        if layer_id is None or layer_id < 0:
            return any(flag in s for s in self.flags.values())
        return flag in self.flags.get(int(layer_id), ())

    # -- activation --------------------------------------------------------
    def activate(self, report_func: Callable, pixels: int = 64,
                 method: str = "mean"):
        self.report_func = report_func
        self.compressor = Compressor(pixels, method)
        self.enabled = True
        # The hooks ask the flags before they compress or copy, so a
        # (site, layer) that is not flagged costs nothing. 'mean'
        # compresses on device (hooks._compress) so the host copy ships
        # pixels-sized data, not the full activation; other methods need
        # the raw tensor host-side.
        device_pixels = pixels if method == "mean" else 0
        configure(enabled=True, sink=self._sink,
                  compress_pixels=device_pixels, wants=self._site_enabled)

    def deactivate(self):
        self.enabled = False
        configure(enabled=False)

    def _sink(self, site: str, layer_id, array):
        if not self.enabled:
            return
        compressed = self.compressor(np.asarray(array))
        if site == "mlp2":
            with self._lock:
                self.mlp2_records.append(
                    compressed.reshape(-1, compressed.shape[-1]))
        if self.report_func is not None:
            self.report_func(site, layer_id, compressed)

    # -- token/logit reporting (tik_result :189-209) -----------------------
    def report_result(self, logits: np.ndarray, sampled_token: int,
                      tokenizer=None, top_n: int = 20) -> dict:
        logits = np.asarray(logits, np.float64).ravel()
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        top_idx = np.argsort(probs)[::-1][:top_n]
        cands = []
        for i in top_idx:
            text = (tokenizer.detokenize([int(i)]) if tokenizer else str(i))
            cands.append({"token": int(i), "prob": float(probs[i]),
                          "text": text})
        return {
            "token": int(sampled_token),
            "text": (tokenizer.detokenize([int(sampled_token)])
                     if tokenizer else str(sampled_token)),
            "candidates": cands,
        }

    # -- PCA (tik_end :212-223) -------------------------------------------
    def pca_mlp2(self, n_components: int = 2) -> Optional[np.ndarray]:
        with self._lock:
            if not self.mlp2_records:
                return None
            data = np.concatenate(self.mlp2_records, axis=0)
        if data.shape[0] < 2 or data.shape[1] < n_components:
            # Too few samples/features for a 2-component plane (sklearn
            # raises; the SVD fallback would emit degenerate points).
            return None
        # StandardScaler + PCA (sklearn when present, numpy SVD otherwise).
        mean = data.mean(0)
        std = data.std(0)
        std[std == 0] = 1.0
        scaled = (data - mean) / std
        try:
            from sklearn.decomposition import PCA
            return PCA(n_components=n_components).fit_transform(scaled)
        except ImportError:
            u, s, _ = np.linalg.svd(scaled, full_matrices=False)
            return u[:, :n_components] * s[:n_components]

    def clear_records(self):
        with self._lock:
            self.mlp2_records.clear()


_TT = TensorTracer()


def get_tensor_tracer() -> TensorTracer:
    return _TT
