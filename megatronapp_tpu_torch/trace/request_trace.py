"""Per-request lifecycle tracing: an always-on bounded ring of B/E spans
(the JAX package's trace/request_trace.py, for one engine process).

The interesting serving timeline is a REQUEST's: admit → queue wait →
prefill chunks → decode steps → retire/expire/abort/preempt. A
singleton ring-buffer tracer takes Chrome-trace-style B/E/i records from
the engine, bounded by ``capacity`` (old records fall off — tracing can
stay ON in production), and trace/aggregate.py renders them (B/E→X
pairing, Chrome trace metadata).

Timeline layout: ``pid`` is the engine's row (``DECODE_PID``); ``tid``
is the request id + 1 for per-request spans (each request gets its own
timeline row; B/E pairing keys on (pid, tid, name), so concurrent
requests never mis-pair), and 0 for step-granularity spans
(decode-step, and spec-round: one speculate-and-verify round of a
speculative engine).

Pairing is guaranteed by construction: ``end()`` is a no-op unless that
span is open (no orphan E), and ``finish()`` closes every span a
request still has open (retire/expire/abort paths all funnel through
it — no orphan B).

The disabled path is one attribute truthiness check per call site.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DECODE_PID = 0      # the engine's timeline row

_PROCESS_NAMES = {DECODE_PID: "engine"}


class RequestTracer:
    """Bounded always-on request-lifecycle tracer (singleton via
    get_request_tracer)."""

    def __init__(self, capacity: int = 16384):
        self.enabled = False
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # rid -> [(pid, name), ...] open spans, innermost last.
        self._open: Dict[int, List[tuple]] = {}
        self._t0 = time.perf_counter_ns()

    # -- configuration -----------------------------------------------------
    def configure(self, enabled: bool = True,
                  capacity: Optional[int] = None):
        with self._lock:
            self.enabled = enabled
            if capacity is not None and capacity != self.capacity:
                self.capacity = capacity
                self._ring = deque(self._ring, maxlen=capacity)

    def reset(self):
        """Drop all records and open-span state (tests; fresh
        epochs)."""
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self._t0 = time.perf_counter_ns()

    def _ts_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    # -- emission ----------------------------------------------------------
    def _emit(self, name: str, ph: str, rid: Optional[int], pid: int,
              attrs: Dict[str, Any]):
        rec = {
            "name": name, "ph": ph, "ts": self._ts_us(),
            "pid": pid,
            "tid": 0 if rid is None else rid + 1,
            "iteration": 0,
            "args": dict(attrs, rid=rid) if rid is not None else dict(attrs),
        }
        with self._lock:
            self._ring.append(rec)

    def begin(self, name: str, rid: Optional[int],
              pid: int = DECODE_PID, **attrs):
        if not self.enabled:
            return
        with self._lock:
            self._open.setdefault(rid, []).append((pid, name))
        self._emit(name, "B", rid, pid, attrs)

    def end(self, name: str, rid: Optional[int],
            pid: int = DECODE_PID, **attrs):
        """Close an open span. Tolerant: a no-op when `name` is not open
        for `rid` — the lifecycle paths overlap (abort during prefill,
        expire mid-decode) and an orphan E would corrupt B/E pairing
        downstream."""
        if not self.enabled:
            return
        with self._lock:
            spans = self._open.get(rid)
            if not spans or (pid, name) not in spans:
                return
            # Remove the innermost matching occurrence.
            for i in range(len(spans) - 1, -1, -1):
                if spans[i] == (pid, name):
                    del spans[i]
                    break
            if not spans:
                self._open.pop(rid, None)
        self._emit(name, "E", rid, pid, attrs)

    def instant(self, name: str, rid: Optional[int] = None,
                pid: int = DECODE_PID, **attrs):
        if not self.enabled:
            return
        self._emit(name, "i", rid, pid, attrs)

    def finish(self, rid: int, reason: Optional[str] = None, **attrs):
        """Terminal event for a request: optional instant `reason`
        (retire/expire/abort) then close EVERY span it still has open,
        innermost first — the one funnel that guarantees no orphan B on
        any exit path."""
        if not self.enabled:
            return
        if reason is not None:
            self._emit(reason, "i", rid, DECODE_PID, attrs)
        with self._lock:
            spans = self._open.pop(rid, [])
        for pid, name in reversed(spans):
            self._emit(name, "E", rid, pid, {})

    # -- export ------------------------------------------------------------
    def dump(self) -> List[dict]:
        """Ring contents, oldest first (records stay in the ring)."""
        with self._lock:
            return list(self._ring)

    def _windowed_records(self) -> List[dict]:
        """Records wrapped in a synthetic single-iteration window per
        pid (the JAX package's trace aggregation keys offsets on
        'iteration' B/E spans, so a serving trace reads as one
        window)."""
        recs = self.dump()
        if not recs:
            return []
        t_end = max(r["ts"] for r in recs) + 1.0
        out = []
        for pid in sorted({r["pid"] for r in recs}):
            out.append({"name": "iteration", "ph": "B", "ts": 0.0,
                        "pid": pid, "tid": 0, "iteration": 0, "args": {}})
        out.extend(recs)
        for pid in sorted({r["pid"] for r in recs}):
            out.append({"name": "iteration", "ph": "E", "ts": t_end,
                        "pid": pid, "tid": 0, "iteration": 0, "args": {}})
        return out

    def chrome_trace(self, process_names: Optional[Dict[int, str]] = None
                     ) -> dict:
        """Render the ring as one Chrome trace (B/E→X pairing + process
        metadata)."""
        from megatronapp_tpu_torch.trace.aggregate import (
            chrome_trace as _chrome, transform_to_complete_events,
        )
        recs = sorted(self._windowed_records(),
                      key=lambda r: (r["ts"], r["pid"]))
        events = transform_to_complete_events(recs)
        return _chrome(events, process_names or dict(_PROCESS_NAMES))


_TRACER = RequestTracer()


def get_request_tracer() -> RequestTracer:
    return _TRACER
