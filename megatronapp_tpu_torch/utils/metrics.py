"""Serving telemetry registry (the JAX package's utils/metrics.py, for
what this package records).

One process-wide registry of NAMED counters, gauges and log-bucketed
latency histograms, plus a Prometheus-text renderer for the server's
``GET /metrics``. Production code calls the module-level
``inc``/``set_gauge``/``observe`` at the instrumented sites (paged
allocator evictions, decode token intervals, TTFT, …); the registry
aggregates and the server exports.

Design constraints (mirrors utils/chaos.py):

- **Zero-cost when disabled.** Every module-level recording function
  starts with a single truthiness check of a module-level dict
  (``if not _ACTIVE: return``) — no lookup, no lock, no allocation — so
  the sites can live inside the serving stepper without a measurable
  change.
- **Bounded memory.** Histograms hold fixed bucket arrays (no raw
  samples); counters/gauges are one float per name.
- **Percentiles from buckets.** ``Histogram.percentile`` estimates
  p50/p90/p99 by geometric interpolation inside the covering log
  bucket — relative error is bounded by the bucket growth factor.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Dict, List, Optional

__all__ = [
    "Histogram", "MetricsRegistry", "enable", "disable", "enabled",
    "registry", "inc", "set_gauge", "observe", "render_prometheus",
    "snapshot", "counter_value",
]


class Histogram:
    """Log-bucketed histogram: bucket i covers
    (lo*growth^(i-1), lo*growth^i]; values ≤ lo land in bucket 0, values
    past hi in the overflow (+Inf) bucket. Thread-safe."""

    def __init__(self, lo: float = 1e-3, hi: float = 1e5,
                 growth: float = 1.25):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError("need 0 < lo < hi and growth > 1")
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        # Upper bucket edges; +Inf overflow is counts[-1].
        self.bounds: List[float] = [lo * growth ** i for i in range(n + 1)]
        self.growth = growth
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float):
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += value

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) from the bucket
        counts, interpolating geometrically inside the covering bucket
        (log buckets → geometric interpolation keeps the relative error
        within one growth factor)."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if total == 0:
            return 0.0
        rank = max(q / 100.0 * total, 1e-12)
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                frac = (rank - cum) / c
                if i >= len(self.bounds):       # overflow bucket
                    return self.bounds[-1] * self.growth
                upper = self.bounds[i]
                lower = self.bounds[i - 1] if i > 0 else upper / self.growth
                return lower * (upper / lower) ** frac
            cum += c
        return self.bounds[-1] * self.growth    # unreachable if total>0

    def stats(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6) if self.count else 0.0,
            "p50": round(self.percentile(50), 6),
            "p90": round(self.percentile(90), 6),
            "p99": round(self.percentile(99), 6),
        }


class MetricsRegistry:
    """Named counters / gauges / histograms behind one lock (histograms
    additionally carry their own — they are handed out and observed
    lock-free of the registry)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    # -- recording ---------------------------------------------------------
    def inc(self, name: str, value: float = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float):
        with self._lock:
            self.gauges[name] = value

    def histogram(self, name: str, lo: float = 1e-3, hi: float = 1e5,
                  growth: float = 1.25) -> Histogram:
        """Get-or-create a named histogram (bucket layout is fixed by
        the FIRST declaration; later calls reuse it)."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(lo, hi, growth)
        return h

    def observe(self, name: str, value: float, lo: float = 1e-3,
                hi: float = 1e5, growth: float = 1.25):
        self.histogram(name, lo, hi, growth).observe(value)

    # -- export ------------------------------------------------------------
    @staticmethod
    def _sanitize(name: str) -> str:
        return re.sub(r"[^a-zA-Z0-9_:]", "_", name)

    @staticmethod
    def _fmt(v: float) -> str:
        if isinstance(v, int):
            return str(v)
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(float(v))

    def render_prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges, histograms with
        cumulative le buckets + _sum/_count)."""
        lines: List[str] = []
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = dict(self.histograms)
        for kind, values in (("counter", counters), ("gauge", gauges)):
            for name in sorted(values):
                n = self._sanitize(name)
                lines.append(f"# TYPE {n} {kind}")
                lines.append(f"{n} {self._fmt(values[name])}")
        for name in sorted(hists):
            h = hists[name]
            n = self._sanitize(name)
            lines.append(f"# TYPE {n} histogram")
            with h._lock:
                counts = list(h.counts)
                total, s = h.count, h.sum
            cum = 0
            for bound, c in zip(h.bounds, counts):
                cum += c
                # Only buckets that change the cumulative count, plus
                # +Inf: every log bucket would be noisy, and cumulative
                # semantics stay exact for any quantile query.
                if c:
                    lines.append(f'{n}_bucket{{le="{bound:g}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {total}')
            lines.append(f"{n}_sum {self._fmt(s)}")
            lines.append(f"{n}_count {total}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        """JSON-ready view (histograms as count/sum/percentiles)."""
        with self._lock:
            out = {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {},
            }
            hists = dict(self.histograms)
        for name, h in hists.items():
            out["histograms"][name] = h.stats()
        return out


# ---------------------------------------------------------------------------
# Module-level front door. _ACTIVE is the one-dict-truthiness disabled
# gate (chaos.py pattern): empty dict == disabled == every recording
# call returns after one check.
# ---------------------------------------------------------------------------

_ACTIVE: Dict[str, MetricsRegistry] = {}


def enable() -> MetricsRegistry:
    """Turn recording on (idempotent; keeps accumulated values)."""
    reg = _ACTIVE.get("registry")
    if reg is None:
        reg = MetricsRegistry()
        _ACTIVE["registry"] = reg
    return reg


def disable():
    """Turn recording off AND drop accumulated values (tests isolate
    through this)."""
    _ACTIVE.clear()


def enabled() -> bool:
    return bool(_ACTIVE)


def registry() -> Optional[MetricsRegistry]:
    return _ACTIVE.get("registry")


def inc(name: str, value: float = 1):
    if not _ACTIVE:
        return
    # Atomic re-read: disable() can clear the dict between the
    # truthiness check and the index on another thread — a KeyError
    # here would surface as a serving step failure.
    reg = _ACTIVE.get("registry")
    if reg is not None:
        reg.inc(name, value)


def set_gauge(name: str, value: float):
    if not _ACTIVE:
        return
    reg = _ACTIVE.get("registry")
    if reg is not None:
        reg.set_gauge(name, value)


def observe(name: str, value: float, lo: float = 1e-3, hi: float = 1e5,
            growth: float = 1.25):
    if not _ACTIVE:
        return
    reg = _ACTIVE.get("registry")
    if reg is not None:
        reg.observe(name, value, lo, hi, growth)


def counter_value(name: str) -> float:
    """Current counter value (0 when disabled/absent)."""
    reg = _ACTIVE.get("registry")
    if reg is None:
        return 0.0
    return reg.counters.get(name, 0.0)


def render_prometheus() -> str:
    reg = _ACTIVE.get("registry")
    if reg is None:
        return "# metrics registry disabled\n"
    return reg.render_prometheus()


def snapshot() -> Dict:
    reg = _ACTIVE.get("registry")
    if reg is None:
        return {"enabled": False}
    out = reg.snapshot()
    out["enabled"] = True
    return out
