"""MegaScan tracer: schedule-phase spans timed by the device's own clock.

The JAX package's trace/tracer.py (Tracer, get_tracer,
GRANULARITY_EVENTS), with the reference's CUDA events back in place of
that package's ``io_callback`` markers and custom-VJP span mirrors:

- A span's B and E records each hold a ``torch.cuda.Event`` recorded on
  the current stream at the host point where the span opens or closes;
  ``iteration_begin`` records the iteration's base event. Events land in
  stream order, so a span around an eager region of the train step times
  the device work that region enqueued.
- ``iteration_end`` records a last event, synchronizes once (the
  reference's fence) and resolves every event of the iteration to µs
  after its base, in the record schema the JAX tracer writes: {name, ph,
  ts (µs from the iteration start), pid, tid, iteration, args}. So the
  JAX package's aggregate_dir reads the port's files, and the other way
  round.
- Untraced iterations record nothing and add no synchronization.
- The clock is the device the trainer was given: CUDA events on the
  card, ``perf_counter_ns`` only when the caller asked for the CPU.
- Interval windows: iteration i (0-indexed) is traced when
  i % interval < continuous_iterations.
- Per-process files ``benchmark-data-*.json`` are appended by a saver
  thread; trace/aggregate.py merges them into one Chrome trace.
- The granularity filter is the JAX tracer's. Every event a one-device
  train step records is a schedule event, so 'schedule' and 'collective'
  keep all of them; the filter drops events once collective spans are
  recorded (their producers, the JAX tracer's ``set_attr`` and
  ``phase_event``, come with them).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

# Granularity sets: 'full' records everything, 'schedule' only phase
# events, 'collective' adds comm ops.
GRANULARITY_EVENTS = {
    "schedule": {
        "train-step", "forward", "backward", "optimizer", "loss",
        "allreduce", "grad-sync", "data", "recv-warmup", "send-forward",
        "recv-forward", "send-backward", "recv-backward", "exchange-next",
        "exchange-prev", "checkpoint",
    },
    "collective": {
        "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
        "all-to-all", "tp-overlap-compute", "tp-overlap-permute",
        "cp-overlap-compute", "cp-overlap-permute",
        "moe-a2a-compute", "moe-a2a-permute", "pp-overlap-permute",
    },
}


class Tracer:
    """Per-process tracer (the reference's get_tracer singleton)."""

    def __init__(self):
        self.enabled = False
        self.interval = 5
        self.continuous_iterations = 2
        self.trace_dir = "trace"
        self.granularity = "full"
        # One process a trainer: the pid of every record and the file.
        self.process_index = 0
        self.layout = None
        self.device = torch.device("cpu")
        self.active = False
        self._iteration = -1
        self._base = None
        # Pending records of the open iteration: "ts" holds a CUDA event
        # or a perf_counter_ns stamp until iteration_end resolves it.
        self._pending: List[Dict[str, Any]] = []
        self._records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._save_lock = threading.Lock()
        self._saver_threads: List[threading.Thread] = []

    # -- configuration ----------------------------------------------------
    def configure(self, enabled: bool = True, trace_dir: str = "trace",
                  interval: int = 5, continuous_iterations: int = 2,
                  granularity: str = "full", layout=None, device=None):
        """layout: an object with dp, pp and tp (a mesh context) naming
        the per-process file as the JAX tracer does; device: the device
        whose clock times the spans (CUDA events on a CUDA device)."""
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.interval = max(interval, 1)
        self.continuous_iterations = max(continuous_iterations, 1)
        self.granularity = granularity
        self.layout = layout
        self.device = torch.device("cpu" if device is None else device)
        self.active = False
        self._pending = []
        if enabled:
            os.makedirs(trace_dir, exist_ok=True)

    def _window_active(self, iteration: int) -> bool:
        return iteration % self.interval < self.continuous_iterations

    def _stamp(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter_ns()

    # -- iteration lifecycle ----------------------------------------------
    def iteration_begin(self, iteration: int):
        if not self.enabled:
            return
        self.active = self._window_active(iteration)
        if not self.active:
            return
        self._iteration = iteration
        self._pending = []
        self._base = self._stamp()
        self._emit("iteration", "B", self._base, {"iteration": iteration})

    def iteration_end(self, iteration: int):
        """Close the iteration: one synchronization, then every event of
        the window becomes a µs offset from the iteration's base."""
        if not self.enabled or not self.active:
            return
        self._emit("iteration", "E", self._stamp(), {})
        if self.device.type == "cuda":
            self._pending[-1]["ts"].synchronize()
            base = self._base
            for rec in self._pending:
                rec["ts"] = base.elapsed_time(rec["ts"]) * 1e3
        else:
            base = self._base
            for rec in self._pending:
                rec["ts"] = (rec["ts"] - base) / 1e3
        with self._lock:
            self._records.extend(self._pending)
        self._pending = []
        self.active = False

    # -- scopes ------------------------------------------------------------
    def _allowed(self, name: str) -> bool:
        if self.granularity == "full":
            return True
        allowed = GRANULARITY_EVENTS.get(self.granularity, set())
        return name in allowed or name in GRANULARITY_EVENTS["schedule"]

    def _on(self, name: str) -> bool:
        return self.enabled and self.active and self._allowed(name)

    @contextlib.contextmanager
    def scope(self, name: str, **attrs):
        if not self._on(name):
            yield self
            return
        self._emit(name, "B", self._stamp(), attrs)
        try:
            yield self
        finally:
            self._emit(name, "E", self._stamp(), attrs)

    def instant(self, name: str, **attrs):
        if self._on(name):
            self._emit(name, "i", self._stamp(), attrs)

    # -- record handling -----------------------------------------------------
    def _emit(self, name: str, ph: str, stamp, args: Dict[str, Any]):
        self._pending.append({
            "name": name, "ph": ph, "ts": stamp, "pid": self.process_index,
            "tid": 0, "iteration": self._iteration, "args": dict(args)})

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            recs, self._records = self._records, []
        return recs

    def file_name(self) -> str:
        lay = self.layout
        if lay is not None:
            return (f"benchmark-data-{lay.dp}-pipeline-{lay.pp}"
                    f"-tensor-{lay.tp}-process-{self.process_index}.json")
        return f"benchmark-data-process-{self.process_index}.json"

    def save(self, path: Optional[str] = None):
        """Append the resolved records to the per-process trace file on
        a saver thread (the reference's background saver)."""
        recs = self.drain()
        if not recs:
            return
        path = path or os.path.join(self.trace_dir, self.file_name())

        def _write():
            with self._save_lock:
                existing = []
                if os.path.exists(path):
                    with open(path) as f:
                        try:
                            existing = json.load(f)
                        except json.JSONDecodeError:
                            existing = []
                existing.extend(recs)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(existing, f)
                os.replace(tmp, path)

        t = threading.Thread(target=_write, daemon=True)
        t.start()
        self._saver_threads.append(t)

    def finalize(self):
        self.save()
        for t in self._saver_threads:
            t.join()
        self._saver_threads.clear()


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER
