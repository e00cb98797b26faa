"""Slow-chip detection heuristic.

A copy of the JAX package's trace/detect.py, itself a port of the
reference's scripts/aggregate.py:399 (try_detect) and :366
(detect_in_data_parallelism_group):

Stage 1 — across data-parallel peers, compare the k-th occurrence of each
schedule event per iteration:
  * a 'loss' or 'allreduce' event *finishing early* (< 0.9 x the mean of the
    other ranks) marks the rank suspect — a slow rank reaches the sync op
    last and therefore waits *less* inside it;
  * a 'backward' event *taking long* (> 1.1 x the mean of the others) marks
    the rank suspect.
A rank suspected more than `stage1_threshold` (5) times is escalated.

Stage 2 — for an escalated rank, compare each of its collective events
('all-reduce'/'reduce-scatter'/'all-gather' — the TP '_reduce' analogues)
against the related_sync_op peers; if it is the earliest-finishing member in
> 40% of them, report it as abnormal.

'Rank' granularity is the trace producer (one process per device, as the
reference has). The math is the JAX package's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set

SYNC_EARLY_EVENTS = ("loss", "allreduce", "grad-sync", "optimizer")
SLOW_EVENTS = ("backward", "forward-backward")
COLLECTIVE_PREFIXES = ("all-reduce", "reduce-scatter", "all-gather",
                       "collective-permute", "all-to-all")

EARLY_FACTOR = 0.9
SLOW_FACTOR = 1.1
STAGE1_THRESHOLD = 5
STAGE2_FRACTION = 0.4


def _end(e):
    return e["ts"] + e.get("dur", 0.0)


def detect_stage1(events: List[dict]) -> Dict[int, int]:
    """Suspect counts per pid (reference try_detect stage 1)."""
    # Bucket by (iteration, name, occurrence index) across pids.
    buckets: Dict[tuple, Dict[int, List[dict]]] = defaultdict(
        lambda: defaultdict(list))
    for e in events:
        if e["ph"] != "X":
            continue
        if e["name"] in SYNC_EARLY_EVENTS or e["name"] in SLOW_EVENTS:
            key = (e["args"].get("iteration", -1), e["name"])
            buckets[key][e["pid"]].append(e)

    suspects: Dict[int, int] = defaultdict(int)
    for (it, name), per_pid in buckets.items():
        if len(per_pid) < 2:
            continue
        depth = min(len(v) for v in per_pid.values())
        for i in range(depth):
            if name in SYNC_EARLY_EVENTS:
                # Use wait time inside the op ≈ duration: a slow rank
                # arrives late and waits less.
                durs = {pid: v[i].get("dur", 0.0)
                        for pid, v in per_pid.items()}
                for pid, d in durs.items():
                    others = [durs[q] for q in durs if q != pid]
                    avg = sum(others) / len(others)
                    if avg > 0 and d < EARLY_FACTOR * avg:
                        suspects[pid] += 1
            else:  # slow events: longer duration ⇒ suspect
                durs = {pid: v[i].get("dur", 0.0)
                        for pid, v in per_pid.items()}
                for pid, d in durs.items():
                    others = [durs[q] for q in durs if q != pid]
                    avg = sum(others) / len(others)
                    if avg > 0 and d > SLOW_FACTOR * avg:
                        suspects[pid] += 1
    return dict(suspects)


def _owner(e: dict):
    """Process a collective event belongs to: profiler-derived per-device
    records carry args['process'] (trace/profiler_collectives.py); plain
    tracer records are owned by their pid."""
    return e.get("args", {}).get("process", e["pid"])


def detect_stage2(events: List[dict], related: Dict[int, Set[int]],
                  pid: int) -> bool:
    """Within collectives, is `pid` the earliest finisher in >40% of its
    related-op sets (reference detect_in_data_parallelism_group)?

    Membership is by owning PROCESS: profiler-derived collective events
    have per-device pids, so a set's events attribute back to the
    process stage 1 escalated."""
    by_id = {e["args"]["id"]: e for e in events
             if "id" in e.get("args", {})}
    total = 0
    slow_cnt = 0
    seen = set()
    for eid, ids in related.items():
        if eid in seen or len(ids) < 2:
            continue
        seen.update(ids)
        evs = [by_id[i] for i in ids if i in by_id]
        if not any(_owner(e) == pid for e in evs):
            continue
        # Events in a related set share a name by construction
        # (dependency matching key), but tolerate heterogeneous sets from
        # hand-built traces: require at least one collective member.
        if not any(e["name"].startswith(p) for e in evs
                   for p in COLLECTIVE_PREFIXES):
            continue
        mine = [e for e in evs if _owner(e) == pid]
        others = [e for e in evs if _owner(e) != pid]
        if not others:
            continue
        total += 1
        if min(_end(m) for m in mine) < min(_end(o) for o in others):
            slow_cnt += 1
    return total > 0 and slow_cnt > STAGE2_FRACTION * total


def stage_step_gaps(events: List[dict],
                    name: str = "pp-overlap-permute") -> Dict[int, list]:
    """Per-stage compute-time samples mined from the pipeline's ring-hop
    spans — the bridge from MegaScan detection to MegaDPP scheduling:
    between hop E(step t) and hop B(step t+1) on one stage
    timeline the rank runs its stage body, so those gaps ARE the
    per-stage step times the pipeline planner
    (parallel/schedule.Planner.ingest_trace_events) consumes.

    Returns {stage (args.rank): [gap_seconds, ...]}. Spans from other
    ring domains (op != 'pp-*') are ignored; timelines are keyed
    (pid, tid, op) so dp/cp shards of one stage never interleave AND
    the forward scan's hops ('pp-schedule') never pair with the
    zero-bubble backward scan's ('pp-zb-bwd') — a cross-scan gap spans
    the LM head + loss + head backward, not a stage body."""
    by_tid: Dict[tuple, List[dict]] = defaultdict(list)
    for e in events:
        if e.get("name") != name:
            continue
        op = str(e.get("args", {}).get("op", ""))
        if not op.startswith("pp"):
            continue
        by_tid[(e.get("pid"), e.get("tid"), op)].append(e)
    gaps: Dict[int, list] = defaultdict(list)
    for evs in by_tid.values():
        evs.sort(key=lambda e: e["ts"])
        last_end = None
        for e in evs:
            rank = e.get("args", {}).get("rank")
            if e["ph"] == "B" and last_end is not None and rank is not None:
                gap_us = e["ts"] - last_end
                if gap_us > 0:
                    gaps[int(rank)].append(gap_us / 1e6)
            elif e["ph"] == "E":
                last_end = e["ts"]
    return dict(gaps)


def try_detect(events: List[dict], related: Dict[int, Set[int]],
               stage1_threshold: int = STAGE1_THRESHOLD) -> List[int]:
    """Full two-stage detection; returns abnormal pids (reference
    try_detect → abnormal.txt)."""
    counts = detect_stage1(events)
    escalated = [pid for pid, c in counts.items() if c > stage1_threshold]
    abnormal = []
    for pid in escalated:
        # Stage 2 only filters when collective events with groups exist;
        # otherwise stage-1 escalation stands (the reference requires
        # _reduce events, which exist in its traces by construction).
        has_collectives = any(
            e["name"].startswith(p) for e in events
            for p in COLLECTIVE_PREFIXES)
        if not has_collectives or detect_stage2(events, related, pid):
            abnormal.append(pid)
    return abnormal
