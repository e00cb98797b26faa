"""Offline trace analytics: iteration times, compute/communication ratio,
phase windows.

A copy of the JAX package's trace/analytics.py, a port of the
reference's profiling/process_*.py (process_data.py,
process_send_compute.py, process_memory.py: iteration-time stats,
compute-vs-send ratio and windows, peak memory across pp/dpp runs) —
computed from our aggregated Chrome-trace events (trace/aggregate.py
transform_to_complete_events 'X' records).

Usage:
  python -m megatronapp_tpu_torch.trace.analytics --trace-dir trace/ \
      [--json out]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict, List, Optional

# Event names that are communication (collectives/transfers) — matches the
# tracer's collective scope names + schedule-phase comm spans.
_COMM_MARKERS = ("all-reduce", "all-gather", "reduce-scatter", "allreduce",
                 "ppermute", "all-to-all", "send", "recv", "exchange",
                 "grad-sync")


def is_comm_event(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in _COMM_MARKERS)


def iteration_time_stats(events: List[dict]) -> Dict:
    """Per-iteration wall time stats from 'iteration' X events (µs)."""
    durs = sorted(e["dur"] for e in events
                  if e.get("name") == "iteration" and e.get("ph") == "X")
    if not durs:
        return {"iterations": 0}
    n = len(durs)
    return {
        "iterations": n,
        "mean_us": sum(durs) / n,
        "p50_us": durs[n // 2],
        "max_us": durs[-1],
        "min_us": durs[0],
    }


def compute_comm_ratio(events: List[dict]) -> Dict:
    """Total compute vs communication span time per process (reference
    process_send_compute.py ratio)."""
    per_pid = defaultdict(lambda: {"compute_us": 0.0, "comm_us": 0.0})
    # Wrapper spans contain the phase spans — counting both would double
    # every microsecond (train-step wraps forward/backward/grad-sync).
    wrappers = {"iteration", "train-step"}
    for e in events:
        if e.get("ph") != "X" or e.get("name") in wrappers:
            continue
        bucket = "comm_us" if is_comm_event(e["name"]) else "compute_us"
        per_pid[e.get("pid", 0)][bucket] += e["dur"]
    out = {}
    for pid, d in sorted(per_pid.items()):
        total = d["compute_us"] + d["comm_us"]
        out[pid] = {**d,
                    "comm_fraction": (d["comm_us"] / total if total
                                      else 0.0)}
    return out


def phase_windows(events: List[dict]) -> Dict[str, Dict]:
    """Per-phase (forward/backward/loss/allreduce/optimizer) totals +
    counts — the schedule-phase breakdown the reference's detector keys on
    (scripts/aggregate.py try_detect inputs)."""
    agg = defaultdict(lambda: {"total_us": 0.0, "count": 0})
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e["name"]
        if name in ("forward", "backward", "loss", "allreduce",
                    "optimizer", "grad-sync", "train-step"):
            agg[name]["total_us"] += e["dur"]
            agg[name]["count"] += 1
    return dict(agg)


def collective_stats(events: List[dict]) -> Dict[str, Dict]:
    """Per-kind collective summary from profiler-derived records
    (trace/profiler_collectives.py): count, total bytes, duration, and
    mean/max bandwidth — the reference's per-op Gbps reporting
    (training/trace.py:371-380) aggregated per collective kind."""
    agg = defaultdict(lambda: {"count": 0, "bytes_total": 0,
                               "time_us": 0.0, "gbps": []})
    # Convention: totals are per LOGICAL collective (the reference's
    # per-op accounting), not per participant. Each device in a group
    # contributes its own copy of the same event, so copies are deduped
    # ACROSS pids by matching the n-th occurrence of
    # (name, hlo_op, iteration, group) per pid — the same logical-op
    # identity trace/dependency.py uses. This is robust to aggregated
    # and raw per-rank traces alike (a 1/len(group) weighting would
    # undercount the latter) while still counting repeated executions of
    # one HLO op within an iteration (per-microbatch loop collectives)
    # separately. bytes count once per occurrence; time_us takes the
    # slowest participant (the collective's critical path); per-copy
    # bandwidths all feed the mean/max.
    #
    # Dropped-event guard: when a pid dropped copies,
    # its occurrence numbering lags the other pids', so its n-th event
    # would pair with a DIFFERENT logical op and corrupt the
    # slowest-participant merge. The cross-pid matching window is
    # therefore CLAMPED to the minimum per-pid occurrence count of the
    # ident; occurrences beyond it keep per-pid identities (each counts
    # as its own logical op — a conservative overcount of at most the
    # dropped tail). An EARLY drop can still misalign pairings inside the
    # common window (occurrence indices carry no timing); the clamp
    # bounds the damage to that window instead of letting the tail
    # inflate counts too — a span-overlap tie-breaker would be the full
    # fix if early drops show up in practice.
    def _is_copy(ev):
        return ev.get("ph") == "X" and "bandwidth_gbps" in ev.get(
            "args", {})

    def _ident_of(ev):
        args = ev.get("args", {})
        if not args.get("hlo_op"):
            return None
        return (ev["name"], args["hlo_op"], args.get("iteration"),
                tuple(args.get("group") or ()))

    ident_pid_totals: Dict[tuple, Dict] = defaultdict(
        lambda: defaultdict(int))
    for e in events:
        if _is_copy(e):
            ident = _ident_of(e)
            if ident is not None:
                ident_pid_totals[ident][e.get("pid")] += 1
    n_common = {ident: min(by_pid.values())
                for ident, by_pid in ident_pid_totals.items()}

    seen: Dict[tuple, str] = {}
    per_pid_n: Dict[tuple, int] = {}
    for e in sorted(events, key=lambda ev: (str(ev.get("pid")),
                                            ev.get("ts", 0.0))):
        args = e.get("args", {})
        if not _is_copy(e):
            continue
        a = agg[e["name"]]
        # Occurrence identity needs hlo_op (+iteration+group); events
        # without it (hand-built or foreign traces) can't be deduped and
        # each counts as its own occurrence.
        ident = _ident_of(e)
        if ident is not None:
            pkey = (e.get("pid"),) + ident
            n = per_pid_n.get(pkey, 0)
            per_pid_n[pkey] = n + 1
            if n < n_common[ident]:
                occ = ident + (n,)
            else:
                # Beyond the common window: some pid dropped copies of
                # this ident — keep per-pid identity (longer key shape,
                # so it can never collide with a merged occurrence).
                occ = ident + (e.get("pid"), n)
        else:
            occ = (id(e),)
        dur = float(e.get("dur", 0.0))
        if occ not in seen:
            seen[occ] = e["name"]
            a["count"] += 1
            a["bytes_total"] += int(args.get("bytes", 0))
            a["time_us"] += dur
            a.setdefault("max_dur", {})[occ] = dur
        else:
            prev = a.setdefault("max_dur", {}).get(occ, 0.0)
            if dur > prev:
                a["time_us"] += dur - prev
                a["max_dur"][occ] = dur
        if args["bandwidth_gbps"] > 0:
            a["gbps"].append(args["bandwidth_gbps"])
    out = {}
    for kind, a in sorted(agg.items()):
        gb = a.pop("gbps")
        a.pop("max_dur", None)
        a["count"] = int(a["count"])
        a["bytes_total"] = int(a["bytes_total"])
        a["time_us"] = round(a["time_us"], 3)
        out[kind] = {**a,
                     "gbps_mean": (round(sum(gb) / len(gb), 3)
                                   if gb else 0.0),
                     "gbps_max": max(gb) if gb else 0.0}
    return out


def analyze(trace_dir: str) -> Dict:
    """Full report over an aggregated (or raw per-rank) trace dir."""
    from megatronapp_tpu_torch.trace.aggregate import aggregate_dir
    trace = aggregate_dir(trace_dir, output=None)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    return {
        "iteration_time": iteration_time_stats(events),
        "compute_comm": compute_comm_ratio(events),
        "phases": phase_windows(events),
        "collectives": collective_stats(events),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", required=True)
    ap.add_argument("--json", default=None, help="write report here")
    args = ap.parse_args(argv)
    report = analyze(args.trace_dir)
    text = json.dumps(report, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
