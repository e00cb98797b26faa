"""MegaScope perturbation injection: the JAX package's
scope/disturbance.py.

The reference's tensor_disturbance.py:27-75 (NOISE_REGISTRY: 'noise1'
additive Gaussian, 'noise2' multiplicative uniform), applied at three
sites:
  weight       — the linear layers' weights,
  calculation  — the MLP's fc1 output (before the activation),
  system       — the hidden state between layers.

A site's noise is drawn from a ``torch.Generator`` on the tensor's device,
seeded from (seed, crc32(site), layer id) as the JAX package folds its
key; torch's draws are not jax.random's, so the same seed gives other
noise of the same law. Scale 0 (or a site not configured) is the
identity, and a site restricted to ``layers`` leaves other layers alone.
The state is read each time a site runs (eager PyTorch: nothing to
re-trace).
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Dict, Optional

import torch

SITES = ("weight", "calculation", "system")


def noise1(x, gen, scale):
    """Additive Gaussian (the reference's NOISE_REGISTRY['noise1'])."""
    draw = torch.randn(x.shape, generator=gen, device=x.device,
                       dtype=torch.float32)
    return x + (scale * draw).to(x.dtype)


def noise2(x, gen, scale):
    """Multiplicative uniform in [1-scale, 1+scale] (the reference's
    'noise2')."""
    draw = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=torch.float32)
    factor = 1.0 + scale * (2.0 * draw - 1.0)
    return x * factor.to(x.dtype)


NOISE_REGISTRY = {"noise1": noise1, "noise2": noise2}


@dataclasses.dataclass
class SiteConfig:
    kind: str = "noise1"
    scale: float = 0.0
    # Restrict to specific layers; None = all layers.
    layers: Optional[tuple] = None


def _seed_of(seed: int, site: str, layer_id) -> int:
    """One generator seed per (seed, site, layer): the JAX package folds
    crc32(site) mod 2^31 and the layer id into PRNGKey(seed)."""
    key = (int(seed) * 1_000_003 + zlib.crc32(site.encode()) % (2 ** 31))
    if layer_id is not None:
        key = key * 1_000_003 + int(layer_id) + 1
    return key % (2 ** 63)


class Disturbance:
    """Per-process perturbation state."""

    def __init__(self):
        self._lock = threading.Lock()
        self.sites: Dict[str, SiteConfig] = {}
        self.seed = 0

    def configure(self, config: Dict[str, dict], seed: int = 0):
        """config: {site: {kind, scale, layers}} (the WS wire format)."""
        with self._lock:
            self.sites = {}
            for site, c in config.items():
                if site not in SITES:
                    raise ValueError(
                        f"unknown disturbance site {site!r}; valid: {SITES}")
                kind = c.get("kind", "noise1")
                if kind not in NOISE_REGISTRY:
                    raise ValueError(
                        f"unknown noise kind {kind!r}; valid: "
                        f"{sorted(NOISE_REGISTRY)}")
                layers = c.get("layers")
                self.sites[site] = SiteConfig(
                    kind=kind, scale=float(c.get("scale", 0.0)),
                    layers=tuple(layers) if layers is not None else None)
            self.seed = seed

    def clear(self):
        with self._lock:
            self.sites = {}

    def active(self, site: str) -> bool:
        c = self.sites.get(site)
        return c is not None and c.scale != 0.0

    def apply(self, site: str, x: torch.Tensor, layer_id=None
              ) -> torch.Tensor:
        """x perturbed at `site` (layer `layer_id`); x itself when the
        site is inactive or its layers exclude this one."""
        c = self.sites.get(site)
        if c is None or c.scale == 0.0:
            return x
        if (layer_id is not None and c.layers is not None
                and int(layer_id) not in c.layers):
            return x
        gen = torch.Generator(device=x.device)
        gen.manual_seed(_seed_of(self.seed, site, layer_id))
        return NOISE_REGISTRY[c.kind](x, gen, c.scale)


_DISTURBANCE = Disturbance()


def get_disturbance() -> Disturbance:
    return _DISTURBANCE
