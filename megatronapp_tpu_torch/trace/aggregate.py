"""MegaScan aggregation: per-process trace files → merged Chrome trace.

A copy of the JAX package's trace/aggregate.py, itself a port of the
reference's scripts/aggregate.py (:56 collect_benchmark_files, :92
read_benchmark_file, :142 aggregate_benchmark_data, :273 transform B/E→X, :337
benchmark_to_chrome_trace) — reimplemented for our record schema (tracer.py
emits Chrome-style dicts with ts in µs relative to each iteration start).

Timeline stitching: iterations are aligned across processes by padding each
iteration's events to a shared global timeline (the reference's pad_before +
per-iteration max-duration logic): global_offset(iter) = sum over previous
iterations of max-across-ranks(iteration duration).
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

# Stable color assignment per event name (Chrome trace 'cname' is limited;
# we use the reference's approach of cycling a palette per name).
_COLORS = [
    "thread_state_running", "thread_state_runnable", "rail_response",
    "rail_animation", "rail_idle", "rail_load", "good", "bad", "terrible",
    "cq_build_passed", "cq_build_failed", "cq_build_running",
]


def collect_benchmark_files(trace_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(trace_dir, "benchmark-data-*.json")))


def read_benchmark_file(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def _iteration_spans(records: List[dict]) -> Dict[int, float]:
    """Per-iteration duration (µs) = ts of the iteration E record."""
    spans = {}
    for r in records:
        if r["name"] == "iteration" and r["ph"] == "E":
            spans[r["iteration"]] = max(spans.get(r["iteration"], 0.0),
                                        r["ts"])
    return spans


def aggregate_benchmark_data(per_process: Dict[int, List[dict]]
                             ) -> List[dict]:
    """Stitch per-process records onto one global timeline.

    Returns records with absolute 'ts' (µs); iteration k starts at the same
    global offset on every process (reference aggregate_benchmark_data)."""
    # Global per-iteration duration = max across processes.
    global_spans: Dict[int, float] = defaultdict(float)
    for recs in per_process.values():
        for it, dur in _iteration_spans(recs).items():
            global_spans[it] = max(global_spans[it], dur)
    iters = sorted(global_spans)
    offsets = {}
    cursor = 0.0
    for it in iters:
        offsets[it] = cursor
        cursor += global_spans[it] + 1.0  # 1µs gap

    out = []
    for pid, recs in per_process.items():
        for r in recs:
            it = r.get("iteration", -1)
            if it not in offsets:
                continue
            rr = dict(r)
            rr["ts"] = r["ts"] + offsets[it]
            # Records carry their own pid (host records: the process
            # index; collective events: 1000 * (rank + 1), the rank's
            # device row); fall back to the file's process id for legacy
            # traces.
            rr["pid"] = r.get("pid", pid)
            out.append(rr)
    out.sort(key=lambda r: (r["ts"], r["pid"]))
    return out


def transform_to_complete_events(records: List[dict]) -> List[dict]:
    """B/E pairs → X (complete) events; i stays instant (reference
    transform, aggregate.py:273)."""
    out = []
    # Keyed by (pid, tid, name): spans of different phases interleave
    # (e.g. 'backward' opens while 'forward' of the next microbatch is
    # pending), so pairing must match names, not just nesting order.
    open_stacks: Dict[tuple, List[dict]] = defaultdict(list)
    color_map: Dict[str, str] = {}
    eid = 0
    for r in records:
        key = (r["pid"], r.get("tid", 0), r["name"])
        if r["ph"] == "B":
            open_stacks[key].append(r)
        elif r["ph"] == "E":
            if not open_stacks[key]:
                continue
            b = open_stacks[key].pop()
            name = b["name"]
            if name not in color_map:
                color_map[name] = _COLORS[len(color_map) % len(_COLORS)]
            eid += 1
            out.append({
                "name": name, "ph": "X", "ts": b["ts"],
                "dur": max(r["ts"] - b["ts"], 0.001),
                "pid": b["pid"], "tid": b.get("tid", 0),
                "cname": color_map[name],
                "args": {**b.get("args", {}),
                         "iteration": b.get("iteration", -1),
                         "id": eid},
            })
        elif r["ph"] == "i":
            eid += 1
            out.append({
                "name": r["name"], "ph": "i", "ts": r["ts"],
                "pid": r["pid"], "tid": r.get("tid", 0), "s": "t",
                "args": {**r.get("args", {}),
                         "iteration": r.get("iteration", -1), "id": eid},
            })
        elif r["ph"] == "X":
            # Pre-formed complete events (the collective events of
            # trace/tracer.py) pass through. Ids are ALWAYS
            # reassigned here: producer ids restart per capture window
            # and per process, so keeping them would collide with span
            # ids and with each other, corrupting every id-keyed lookup
            # (dependency related-sets, detect stage 2, amend_p2p).
            eid += 1
            args = {**r.get("args", {})}
            args.setdefault("iteration", r.get("iteration", -1))
            args["id"] = eid
            out.append({
                "name": r["name"], "ph": "X", "ts": r["ts"],
                "dur": r.get("dur", 0.001), "pid": r["pid"],
                "tid": r.get("tid", 0), "args": args,
            })
    out.sort(key=lambda r: (r["ts"], r["pid"]))
    return out


def chrome_trace(events: List[dict], process_names: Optional[Dict[int, str]]
                 = None) -> dict:
    """Final Chrome trace JSON (with process_name/sort metadata like the
    reference's benchmark_to_chrome_trace)."""
    meta = []
    pids = sorted({e["pid"] for e in events})
    for pid in pids:
        name = (process_names or {}).get(pid, f"process {pid}")
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": name}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "args": {"sort_index": pid}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def aggregate_dir(trace_dir: str, output: Optional[str] = None,
                  detect: bool = False) -> dict:
    """Full offline pipeline (reference scripts/aggregate.py __main__):
    read per-process files → stitch → X events → dependency → [detect] →
    Chrome trace file."""
    from megatronapp_tpu_torch.trace.dependency import (
        amend_p2p, build_dependencies)

    files = collect_benchmark_files(trace_dir)
    if not files:
        raise FileNotFoundError(f"no benchmark-data-*.json in {trace_dir}")
    per_process = {}
    for path in files:
        recs = read_benchmark_file(path)
        pid = recs[0]["pid"] if recs else len(per_process)
        per_process[pid] = recs
    merged = aggregate_benchmark_data(per_process)
    events = transform_to_complete_events(merged)
    related = build_dependencies(events)
    amend_p2p(events, related)

    if detect:
        from megatronapp_tpu_torch.trace.detect import try_detect
        suspects = try_detect(events, related)
        if suspects:
            with open(os.path.join(trace_dir, "abnormal.txt"), "w") as f:
                for s in suspects:
                    f.write(f"Abnormal chip: process {s}\n")

    trace = chrome_trace(events)
    if output:
        with open(output, "w") as f:
            json.dump(trace, f)
    return trace


def main(argv=None):
    """CLI of the reference's scripts/aggregate.py:
    python -m megatronapp_tpu_torch.trace.aggregate -b DIR [-o OUT] [-d]"""
    import argparse
    ap = argparse.ArgumentParser(description="MegaScan trace aggregation")
    ap.add_argument("-b", "--benchmark-dir", required=True)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-d", "--detect", action="store_true")
    args = ap.parse_args(argv)
    out = args.output or os.path.join(args.benchmark_dir, "aggregated.json")
    aggregate_dir(args.benchmark_dir, out, detect=args.detect)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
