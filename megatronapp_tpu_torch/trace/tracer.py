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
- The granularity filter is the JAX tracer's: 'schedule' keeps the
  phase spans, 'collective' adds the collective events, 'full' keeps
  everything.
- Collective events (``collective``, called by parallel/collectives.py
  around each collective of a rank grid): one pre-formed X record per
  call, on the rank's device timeline (pid 1000 · (rank + 1), as JAX's
  trace/profiler_collectives.py ``collective_events`` places device
  rows), with that function's args: id, group (global ranks), bytes,
  axes ("tp" or "dp"), bandwidth_gbps, process, device, iteration.
- A rank of a grid (``configure(rank=)``) writes its own file under
  JAX's per-rank name; trace/aggregate.py merges the ranks.
- Span ends placed apart (``phase_event``): the cp ring's
  'cp-overlap-permute' (a hop, issued before a round's compute and
  waited after it) and 'cp-overlap-compute' (the round) with JAX's args
  op, rank (the ring index) and step (ops/context_parallel.py); the TP
  overlap rings' 'tp-overlap-permute' / 'tp-overlap-compute' and the
  ZeRO-1 ring's 'dp-overlap-permute' (parallel/overlap.py) on a timeline
  of their own a ring rank (``tid`` = rank + 1, JAX's), a hop's span
  carrying its bytes: an arg ``data`` becomes the record's ``bytes``
  (JAX's ``_emit``).
- Host-timed records (``add_collective_records``, JAX's): pre-formed X
  events on pids of their own, placed in the open iteration by a
  host-clock anchor, ``now_in_iteration_us()`` (µs since
  ``iteration_begin`` on ``perf_counter``). Their producer is the MegaDPP
  step (runtime/dpp_train.py), whose runner times its per-stage compute
  and transfer spans on the host. The anchor's clock is the host's, the
  phase spans' the device's: both start at the iteration's begin.
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
        self._iter_t0_ns = time.perf_counter_ns()
        # Pending records of the open iteration: "ts" holds a CUDA event
        # or a perf_counter_ns stamp until iteration_end resolves it.
        self._pending: List[Dict[str, Any]] = []
        self._records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._save_lock = threading.Lock()
        self._saver_threads: List[threading.Thread] = []
        self._next_id = 0

    # -- configuration ----------------------------------------------------
    def configure(self, enabled: bool = True, trace_dir: str = "trace",
                  interval: int = 5, continuous_iterations: int = 2,
                  granularity: str = "full", layout=None, device=None,
                  rank: int = 0):
        """layout: an object with dp, pp and tp (a mesh context) naming
        the per-process file as the JAX tracer does; device: the device
        whose clock times the spans (CUDA events on a CUDA device); rank:
        this process's rank in its grid (its records' pid and its file's
        process index)."""
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.interval = max(interval, 1)
        self.continuous_iterations = max(continuous_iterations, 1)
        self.granularity = granularity
        self.layout = layout
        self.device = torch.device("cpu" if device is None else device)
        self.process_index = rank
        self.active = False
        self._pending = []
        self._next_id = 0
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
        self._iter_t0_ns = time.perf_counter_ns()
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

            def us(stamp):
                return base.elapsed_time(stamp) * 1e3
        else:
            base = self._base

            def us(stamp):
                return (stamp - base) / 1e3
        for rec in self._pending:
            rec["ts"] = us(rec["ts"])
            if rec["ph"] == "X":
                rec["dur"] = max(us(rec.pop("end")) - rec["ts"], 0.0)
                gbps = (rec["args"]["bytes"] * 8e-3 / rec["dur"]
                        if rec["dur"] > 0 else 0.0)
                rec["args"]["bandwidth_gbps"] = round(gbps, 3)
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

    def phase_event(self, name: str, ph: str, tid: int = 0, **attrs):
        """One end ("B" or "E") of a span whose ends the caller places
        apart (JAX's phase_event): the ring spans open before the compute
        they ride under and close after it (ops/context_parallel.py,
        parallel/overlap.py). tid: the timeline (0 the host scopes'; the
        TP and ZeRO-1 rings' ring rank + 1). Stamped in stream order;
        nothing outside a traced iteration."""
        if self._on(name):
            self._emit(name, ph, self._stamp(), attrs, tid=tid)

    def instant(self, name: str, **attrs):
        if self._on(name):
            self._emit(name, "i", self._stamp(), attrs)

    @contextlib.contextmanager
    def collective(self, name: str, *, group, bytes: int, axes: str):
        """One X event for the collective run inside the block (see the
        module docstring); nothing outside a traced iteration."""
        if not self._on(name):
            yield self
            return
        start = self._stamp()
        try:
            yield self
        finally:
            rank = self.process_index
            self._pending.append({
                "name": name, "ph": "X", "ts": start, "end": self._stamp(),
                "pid": 1000 * (rank + 1), "tid": 0,
                "iteration": self._iteration,
                "args": {"id": self._next_id, "group": list(group),
                         "bytes": int(bytes), "axes": axes,
                         "process": rank, "device": rank,
                         "iteration": self._iteration}})
            self._next_id += 1

    # -- record handling -----------------------------------------------------
    def _emit(self, name: str, ph: str, stamp, args: Dict[str, Any],
              tid: int = 0):
        rec = {"name": name, "ph": ph, "ts": stamp,
               "pid": self.process_index, "tid": tid,
               "iteration": self._iteration, "args": dict(args)}
        if "data" in args:
            rec["args"]["bytes"] = int(args["data"])
        self._pending.append(rec)

    def now_in_iteration_us(self) -> float:
        """Current offset inside the open iteration window (µs, host
        clock)."""
        return (time.perf_counter_ns() - self._iter_t0_ns) / 1e3

    def add_collective_records(self, events: List[Dict[str, Any]],
                               offset_us: Optional[float] = None):
        """Merge pre-formed X events (pids of their own) into this
        iteration's records. offset_us anchors them inside the iteration
        window: the value of now_in_iteration_us() taken BEFORE the work
        they time, so they land where it ran rather than after whatever
        delay came between (JAX's contract)."""
        if not (self.enabled and self.active and events):
            return
        base = min(e["ts"] for e in events)
        if offset_us is None:
            offset_us = self.now_in_iteration_us()
        recs = []
        for e in events:
            recs.append({
                "name": e["name"], "ph": "X",
                "ts": e["ts"] - base + offset_us,
                "dur": e.get("dur", 0.0),
                "pid": e["pid"],
                "tid": e.get("tid", 0),
                "iteration": self._iteration,
                "args": dict(e.get("args", {}),
                             iteration=self._iteration),
            })
        with self._lock:
            self._records.extend(recs)

    def peek(self) -> List[Dict[str, Any]]:
        """The resolved records not yet saved, left in place (the
        pipeline planner mines a traced iteration before save())."""
        with self._lock:
            return list(self._records)

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
