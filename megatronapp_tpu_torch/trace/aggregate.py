"""Chrome-trace rendering of request-trace records.

A copy of the two functions of the JAX package's trace/aggregate.py
that the request tracer renders through: B/E→X pairing and the final
Chrome trace JSON with process metadata.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

_COLORS = [
    "thread_state_running", "thread_state_runnable", "rail_response",
    "rail_animation", "rail_idle", "rail_load", "good", "bad", "terrible",
    "cq_build_passed", "cq_build_failed", "cq_build_running",
]


def transform_to_complete_events(records: List[dict]) -> List[dict]:
    """B/E pairs → X (complete) events; i stays instant (reference
    transform, aggregate.py:273)."""
    out = []
    # Keyed by (pid, tid, name): spans of different names interleave
    # (a request's 'prefill' closes while its 'request' span stays
    # open), so pairing must match names, not just nesting order.
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
