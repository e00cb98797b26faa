"""Dependency reconstruction + P2P amendment for merged traces.

A copy of the JAX package's trace/dependency.py, itself a port of the
reference's scripts/dependency.py:
- :26 dependency(): events whose (name, sorted participant group) coincide
  are the same logical collective → grouped into a related_sync_op set;
- :54 amendP2P(): for matched send/recv pairs, both sides are shrunk to the
  overlap (the actual transfer) — the long side was waiting, not moving
  bytes — and annotated with the max of the two measured bandwidths.

Events carry the participant list in args['group'] and byte counts in
args['bytes'] (the JAX tracer's set_attr / set_group records).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set


def build_dependencies(events: List[dict]) -> Dict[int, Set[int]]:
    """Map event id → set of related event ids (same collective instance).

    Same (name, sorted group, iteration, occurrence-index-within-iteration)
    across processes = one logical op, exactly the reference's matching key.
    """
    buckets: Dict[tuple, List[dict]] = defaultdict(list)
    for e in events:
        group = e.get("args", {}).get("group")
        if not group:
            continue
        key_base = (e["name"], tuple(sorted(group)),
                    e["args"].get("iteration", -1))
        buckets[key_base].append(e)

    related: Dict[int, Set[int]] = {}
    for key, evs in buckets.items():
        # Within a bucket, the n-th occurrence on each pid matches the n-th
        # occurrence on every other pid.
        per_pid: Dict[int, List[dict]] = defaultdict(list)
        for e in sorted(evs, key=lambda x: x["ts"]):
            per_pid[e["pid"]].append(e)
        depth = max(len(v) for v in per_pid.values())
        for i in range(depth):
            ids = {v[i]["args"]["id"] for v in per_pid.values()
                   if len(v) > i}
            for v in per_pid.values():
                if len(v) > i:
                    v[i]["args"]["related_sync_op"] = sorted(ids)
                    related[v[i]["args"]["id"]] = ids
    return related


def amend_p2p(events: List[dict], related: Dict[int, Set[int]]) -> None:
    """Shrink matched send/recv pairs to the actual transfer window
    (reference amendP2P): new duration = min of the pair; both get the max
    bandwidth; start aligned to the later start."""
    by_id = {e["args"]["id"]: e for e in events if "id" in e.get("args", {})}
    done = set()
    for eid, ids in related.items():
        if eid in done or len(ids) != 2:
            continue
        a_id, b_id = sorted(ids)
        a, b = by_id.get(a_id), by_id.get(b_id)
        if not a or not b or a["ph"] != "X" or b["ph"] != "X":
            continue
        name = a["name"]
        if not (name.startswith("send") or name.startswith("recv") or
                name.startswith("exchange") or "p2p" in name):
            continue
        start = max(a["ts"], b["ts"])
        dur = min(a["dur"], b["dur"])
        bw = max(a["args"].get("bandwidth", 0.0),
                 b["args"].get("bandwidth", 0.0))
        for e in (a, b):
            e["args"]["orig_ts"] = e["ts"]
            e["args"]["orig_dur"] = e["dur"]
            e["ts"] = start
            e["dur"] = dur
            if bw:
                e["args"]["bandwidth"] = bw
        done.update(ids)
