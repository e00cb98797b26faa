"""The pipeline schedule layer (the JAX package's parallel/schedule.py,
numpy only): the per-stage instruction programs, the simulated-timeline
bubble model and the trace-driven planner that closes the MegaScan →
MegaDPP loop.

- ``forward_tables`` emits the clocked (active, microbatch, chunk)
  tables of the 1F1B / interleaved-VPP forward and ``zb_backward_tables``
  the zero-bubble backward program: B = dgrad (the activation cotangent,
  one hop a slot down the reverse stage ring), W = wgrad (the weight
  cotangent, deferred into idle slots). Every W lies inside the program,
  so the optimizer fence is structural. The port's executor
  (parallel/pipeline.py) runs these tables on every stage rank.
- ``validate_programs`` is the gate every table passes before it runs:
  dependencies, ring alignment (an instruction consumes what its
  producer emitted one slot earlier), duplicates and the W fence.
- ``simulate_timeline`` / ``analytic_vpp_bubble``: the bubble model of
  the combined per-stage programs under a per-stage cost table
  (``stage_cost_model``: uniform for the port's homogeneous stacks).
- ``Planner``: per-(stage, vstage) step-time EWMAs fed by the pipeline's
  ring-hop spans (``ingest_trace_events`` → trace/detect.py
  ``stage_step_gaps``) or whole-step samples (``observe_step``), a
  modelled bubble per candidate schedule, hysteresis re-planning with a
  loud log (``maybe_replan``) and gauges keyed (stage, vstage)
  (``export_metrics``).

Conventions: one instruction a stage a slot; an instruction run at slot
t is consumable by another stage at slot t+1 (one hop a slot).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from megatronapp_tpu_torch.utils import metrics as telemetry

logger = logging.getLogger(__name__)

F, B, W, BW = "F", "B", "W", "BW"

# NOP/B/W encoding of the backward tables.
KIND_NOP, KIND_B, KIND_W = 0, 1, 2

SCHEDULES = ("1f1b", "vpp", "zero-bubble")


@dataclasses.dataclass(frozen=True)
class Instr:
    kind: str
    mb: int
    chunk: int = 0


# ---------------------------------------------------------------------------
# Forward program tables (1F1B / interleaved VPP)
# ---------------------------------------------------------------------------

def forward_tables(pp: int, num_microbatches: int, vpp: int = 1
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Clocked forward program: (active[T, pp] bool, mb[T, pp] i32,
    chunk[T, pp] i32) with T = M*vpp + pp - 1.

    Entry [t, s] is the instruction stage s executes at slot t (masked
    when inactive). Matches the unified closed-form schedule bit-for-bit
    (u = t - s, round r = u // (pp*vpp), chunk = (u % (pp*vpp)) // pp,
    m = r*pp + u % pp); the executor runs this table, so zero-bubble
    (and future schedules) swap in as data."""
    M = num_microbatches
    T = M * vpp + pp - 1
    cycle = pp * vpp
    active = np.zeros((T, pp), np.bool_)
    mb_t = np.zeros((T, pp), np.int32)
    ck_t = np.zeros((T, pp), np.int32)
    for t in range(T):
        for s in range(pp):
            u = t - s
            r, w = divmod(u, cycle)          # floor division
            c = w // pp
            m = r * pp + (w % pp)
            active[t, s] = (u >= 0) and (0 <= m < M)
            mb_t[t, s] = min(max(m, 0), M - 1)
            ck_t[t, s] = min(max(c, 0), vpp - 1)
    return active, mb_t, ck_t


# ---------------------------------------------------------------------------
# Zero-bubble backward program tables
# ---------------------------------------------------------------------------

def zb_backward_tables(pp: int, num_microbatches: int, vpp: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Clocked zero-bubble backward program: (kind[T2, pp] i32 in
    {KIND_NOP, KIND_B, KIND_W}, mb[T2, pp], chunk[T2, pp]).

    B's form cotangent WAVEFRONTS: microbatch m's backward visits
    (chunk vpp-1 .. 0) x (stage pp-1 .. 0) on consecutive slots, so each
    B consumes exactly what the ring delivered from its producer one slot
    earlier (B_(m,c,s) is one slot after B_(m,c,s+1); at s == pp-1 and
    c < vpp-1 one slot after B_(m,c+1,0) — the reversed chunk hand-off).
    Wavefront start slots are chosen greedily earliest-first without
    per-stage slot collisions. W's then fill every remaining idle slot
    after their same-stage B (FIFO by B time) — the deferral that turns
    1F1B's cooldown bubble into wgrad work. All W's complete inside the
    program: the optimizer fence is structural."""
    M = num_microbatches

    def slot(tau, c, s):
        return tau + (vpp - 1 - c) * pp + (pp - 1 - s)

    occupied: List[Dict[int, Tuple[int, int]]] = [dict() for _ in range(pp)]
    taus = []
    tau = 0
    for m in range(M):
        while any(slot(tau, c, s) in occupied[s]
                  for c in range(vpp) for s in range(pp)):
            tau += 1
        taus.append(tau)
        for c in range(vpp):
            for s in range(pp):
                occupied[s][slot(tau, c, s)] = (m, c)
        tau += 1

    b_end = max(max(o) for o in occupied)
    # W fill: walk slots; at each idle slot run the earliest-ready wgrad.
    w_sched: List[Dict[int, Tuple[int, int]]] = [dict() for _ in range(pp)]
    for s in range(pp):
        ready = sorted(occupied[s].items())     # [(slot, (m, c))...]
        pending: List[Tuple[int, Tuple[int, int]]] = []
        nxt = 0
        t = 0
        while nxt < len(ready) or pending:
            while nxt < len(ready) and ready[nxt][0] < t:
                pending.append(ready[nxt])
                nxt += 1
            if t not in occupied[s] and pending:
                w_sched[s][t] = pending.pop(0)[1]
            t += 1

    T2 = 1 + max(b_end,
                 max((max(w) for w in w_sched if w), default=0))
    kind = np.zeros((T2, pp), np.int32)
    mb_t = np.zeros((T2, pp), np.int32)
    ck_t = np.zeros((T2, pp), np.int32)
    for s in range(pp):
        for t, (m, c) in occupied[s].items():
            kind[t, s], mb_t[t, s], ck_t[t, s] = KIND_B, m, c
        for t, (m, c) in w_sched[s].items():
            kind[t, s], mb_t[t, s], ck_t[t, s] = KIND_W, m, c
    return kind, mb_t, ck_t


# ---------------------------------------------------------------------------
# Program validation (dependency / ring-alignment / fence checks)
# ---------------------------------------------------------------------------

def validate_programs(pp: int, num_microbatches: int, vpp: int,
                      fwd: Tuple[np.ndarray, np.ndarray, np.ndarray],
                      bwd: Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]] = None) -> None:
    """Raise ValueError on any dependency, ring-alignment, duplicate, or
    fence violation. The executor runs programs blindly — this is the
    gate that keeps a planner-emitted program from silently consuming a
    stale ring value or dropping a wgrad before the optimizer fence."""
    M = num_microbatches
    active, mb_t, ck_t = fwd
    T = active.shape[0]
    f_slot: Dict[Tuple[int, int, int], int] = {}
    for t in range(T):
        for s in range(pp):
            if not active[t, s]:
                continue
            key = (int(mb_t[t, s]), int(ck_t[t, s]), s)
            if key in f_slot:
                raise ValueError(f"duplicate F for (m, chunk, stage)={key}")
            f_slot[key] = t
    if len(f_slot) != M * vpp * pp:
        raise ValueError(
            f"forward program has {len(f_slot)} F instructions, expected "
            f"{M * vpp * pp} (every (microbatch, chunk) on every stage)")
    for (m, c, s), t in f_slot.items():
        if s > 0:
            dep = (m, c, s - 1)
        elif c > 0:
            dep = (m, c - 1, pp - 1)
        else:
            continue                       # stage-0 chunk-0 injects fresh
        if f_slot.get(dep) != t - 1:
            raise ValueError(
                f"F{(m, c, s)} at slot {t} misaligned with its ring "
                f"producer F{dep} (need slot {t - 1}, got "
                f"{f_slot.get(dep)})")

    if bwd is None:
        return
    kind, bmb, bck = bwd
    T2 = kind.shape[0]
    b_slot: Dict[Tuple[int, int, int], int] = {}
    w_slot: Dict[Tuple[int, int, int], int] = {}
    for t in range(T2):
        for s in range(pp):
            k = int(kind[t, s])
            if k == KIND_NOP:
                continue
            key = (int(bmb[t, s]), int(bck[t, s]), s)
            table = b_slot if k == KIND_B else w_slot
            if key in table:
                raise ValueError(
                    f"duplicate {'B' if k == KIND_B else 'W'} for "
                    f"(m, chunk, stage)={key}")
            table[key] = t
    if len(b_slot) != M * vpp * pp or len(w_slot) != M * vpp * pp:
        raise ValueError(
            f"backward program has {len(b_slot)} B / {len(w_slot)} W "
            f"instructions, expected {M * vpp * pp} each — a missing W "
            "would drop a wgrad before the optimizer fence")
    for (m, c, s), t in b_slot.items():
        if s == pp - 1 and c == vpp - 1:
            continue                    # consumes the output cotangent
        dep = (m, c, s + 1) if s < pp - 1 else (m, c + 1, 0)
        if b_slot.get(dep) != t - 1:
            raise ValueError(
                f"B{(m, c, s)} at slot {t} misaligned with its reverse-"
                f"ring producer B{dep} (need slot {t - 1}, got "
                f"{b_slot.get(dep)})")
    for (m, c, s), t in w_slot.items():
        tb = b_slot.get((m, c, s))
        if tb is None or tb >= t:
            raise ValueError(
                f"W{(m, c, s)} at slot {t} runs before its dgrad "
                f"B at slot {tb} — wgrad needs the saved output "
                "cotangent")


# ---------------------------------------------------------------------------
# Combined (modeled) per-stage programs + the bubble simulator
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def combined_programs(schedule: str, pp: int, num_microbatches: int
                      ) -> List[List[Instr]]:
    """Ordered per-stage instruction lists of the COMBINED timeline an
    MPMD runtime would execute (vpp == 1): '1f1b' uses the fused BW
    backward; 'zero-bubble' splits B/W with greedy B > F > W priority
    under the 1F1B in-flight cap (ZB-H1-style, same activation memory).

    Cached per (schedule, pp, M) — the planner re-simulates every
    candidate each log interval and only the cost-dependent event
    simulation varies; callers must treat the returned lists as
    read-only."""
    M = num_microbatches
    if schedule in ("1f1b", "vpp"):
        progs = []
        for s in range(pp):
            warm = min(pp - 1 - s, M)
            order = [Instr(F, m) for m in range(warm)]
            for i in range(M - warm):
                order.append(Instr(F, warm + i))
                order.append(Instr(BW, i))
            for m in range(M - warm, M):
                order.append(Instr(BW, m))
            progs.append(order)
        return progs
    if schedule != "zero-bubble":
        raise ValueError(f"unknown schedule {schedule!r} (one of "
                         f"{SCHEDULES})")

    # Greedy unit-cost construction. done-slot semantics: an instruction
    # run at slot t is visible to OTHER stages at t+1 and to its OWN
    # stage's later slots.
    f_at: Dict[Tuple[int, int], int] = {}
    b_at: Dict[Tuple[int, int], int] = {}
    f_next = [0] * pp
    b_next = [0] * pp
    w_done = [0] * pp
    w_pool: List[List[int]] = [[] for _ in range(pp)]
    progs: List[List[Instr]] = [[] for _ in range(pp)]
    t = 0
    while any(w_done[s] < M for s in range(pp)):
        for s in range(pp):
            m = b_next[s]
            can_b = (m < M and f_at.get((m, s), t) < t
                     and (s == pp - 1 or b_at.get((m, s + 1), t) < t))
            if can_b:
                b_at[(m, s)] = t
                b_next[s] += 1
                w_pool[s].append(m)
                progs[s].append(Instr(B, m))
                continue
            m = f_next[s]
            can_f = (m < M and (s == 0 or f_at.get((m, s - 1), t) < t)
                     and f_next[s] - b_next[s] < pp - s)
            if can_f:
                f_at[(m, s)] = t
                f_next[s] += 1
                progs[s].append(Instr(F, m))
                continue
            if w_pool[s] and b_at[(w_pool[s][0], s)] < t:
                progs[s].append(Instr(W, w_pool[s].pop(0)))
                w_done[s] += 1
        t += 1
        if t > 10 * (3 * M + pp) + 100:
            raise RuntimeError("zero-bubble greedy scheduler failed to "
                               "converge (internal bug)")
    # The loop's only normal exit (w_done == M on every stage) implies
    # every W already drained — a leftover would violate the ZB-H1
    # in-flight invariant the loop encodes.
    assert not any(w_pool), "zero-bubble greedy left W pending"
    return progs


def simulate_timeline(schedule: str, pp: int, num_microbatches: int,
                      stage_costs: Optional[Sequence[float]] = None,
                      comm: float = 0.0, bwd_ratio: float = 1.0,
                      wgrad_ratio: float = 1.0) -> Dict:
    """Event-driven simulation of the combined per-stage programs.

    stage_costs: relative per-stage forward cost (per microbatch);
    B costs bwd_ratio x F, W costs wgrad_ratio x F, the fused BW their
    sum. Returns {makespan, bubble_fraction, per_stage_busy,
    per_stage_idle}."""
    M = num_microbatches
    costs = list(stage_costs) if stage_costs is not None else [1.0] * pp
    if len(costs) != pp:
        raise ValueError(f"stage_costs must have pp={pp} entries")
    progs = combined_programs(schedule, pp, M)
    done: Dict[Tuple[str, int, int], float] = {}
    t_free = [0.0] * pp
    busy = [0.0] * pp
    idx = [0] * pp

    def ready_time(ins: Instr, s: int) -> Optional[float]:
        if ins.kind == F:
            if s == 0:
                return 0.0
            dep = (F, ins.mb, s - 1)
            return None if dep not in done else done[dep] + comm
        if ins.kind in (B, BW):
            fdep = (F, ins.mb, s)
            if fdep not in done:
                return None
            if s == pp - 1:
                return done[fdep]
            dep = (ins.kind, ins.mb, s + 1)
            if dep not in done:
                return None
            return max(done[dep] + comm, done[fdep])
        dep = (B, ins.mb, s)                      # W
        return done.get(dep)

    def cost_of(ins: Instr, s: int) -> float:
        if ins.kind == F:
            return costs[s]
        if ins.kind == B:
            return costs[s] * bwd_ratio
        if ins.kind == W:
            return costs[s] * wgrad_ratio
        return costs[s] * (bwd_ratio + wgrad_ratio)

    progressed = True
    while any(idx[s] < len(progs[s]) for s in range(pp)):
        if not progressed:
            raise RuntimeError(
                f"deadlock simulating {schedule!r} program (stuck at "
                f"{[(s, idx[s]) for s in range(pp)]})")
        progressed = False
        for s in range(pp):
            while idx[s] < len(progs[s]):
                ins = progs[s][idx[s]]
                ready = ready_time(ins, s)
                if ready is None:
                    break
                start = max(t_free[s], ready)
                dur = cost_of(ins, s)
                done[(ins.kind, ins.mb, s)] = start + dur
                t_free[s] = start + dur
                busy[s] += dur
                idx[s] += 1
                progressed = True
    makespan = max(t_free)
    return {
        "makespan": makespan,
        "bubble_fraction": 1.0 - sum(busy) / (pp * makespan),
        "per_stage_busy": busy,
        "per_stage_idle": [makespan - b for b in busy],
    }


def analytic_vpp_bubble(pp: int, num_microbatches: int, vpp: int,
                        stage_costs: Sequence[float]) -> float:
    """Closed-form interleaved-VPP bubble estimate: the fill fraction
    (M*vpp)/(M*vpp + pp - 1) scaled by the heterogeneous imbalance
    (mean/max stage cost — the slowest stage dictates the clock)."""
    imb = (sum(stage_costs) / len(stage_costs)) / max(stage_costs)
    fill = (num_microbatches * vpp) / (num_microbatches * vpp + pp - 1)
    return 1.0 - imb * fill


# ---------------------------------------------------------------------------
# Stage cost model (heterogeneous stage table) + the planner
# ---------------------------------------------------------------------------

def stage_cost_model(cfg, pp: int, vpp: int = 1) -> List[float]:
    """Relative per-stage forward cost table, normalized to mean 1.0:
    all ones. The port's stacks are homogeneous (its TransformerConfig
    refuses heterogeneous per-layer configs), so every stage holds the
    same layers; JAX weighs a heterogeneous stack's stages by their
    layers' projection FLOPs."""
    return [1.0] * pp


def _window_z(values, x: float) -> Optional[float]:
    """z-score of x against the trailing window (population std); None
    when the window has no spread (JAX utils/straggler.py)."""
    n = len(values)
    mean = sum(values) / n
    std = (sum((t - mean) ** 2 for t in values) / n) ** 0.5
    if std <= 0:
        return None
    return (x - mean) / std


class RollingZ:
    """Windowed z-score of the latest sample against the trailing window
    (JAX utils/straggler.py RollingZ): the planner keys one per (stage,
    vstage), so a slow stage shows at /metrics even when the step time
    hides it. Outliers stay out of the window."""

    def __init__(self, window: int = 64, min_samples: int = 8,
                 z_threshold: float = 3.0):
        self.window: Deque[float] = deque(maxlen=window)
        self.min_samples = min_samples
        self.z_threshold = z_threshold
        self.last_z: Optional[float] = None

    def observe(self, x: float) -> Optional[float]:
        z = None
        if len(self.window) >= self.min_samples:
            z = _window_z(self.window, x)
        if z is None or z <= self.z_threshold:
            self.window.append(x)
        self.last_z = z
        return z


@dataclasses.dataclass
class PipelinePlan:
    schedule: str
    num_microbatches: int
    vpp: int
    bubble_fraction: float
    candidates: Dict[str, float]
    stage_costs: List[float]


class Planner:
    """Turns MegaScan's detection signal into scheduling decisions.

    Per-(stage, vstage) step-time EWMAs are fed three ways: real
    per-stage samples from the pipeline's ring-hop trace spans
    (``ingest_trace_events`` → trace/detect.stage_step_gaps), whole-step
    samples distributed by the current relative weights
    (``observe_step`` — keeps the signal alive when tracing is off), or
    direct ``observe_stage_time`` calls (tests, external probes). The
    static fallback is the heterogeneous stage table. ``plan`` simulates
    every candidate schedule's bubble under the current costs and picks
    the minimum; ``maybe_replan`` adds hysteresis and logs loudly.
    """

    def __init__(self, pp: int, vpp: int = 1, model_cfg=None,
                 alpha: float = 0.2, replan_margin: float = 0.02,
                 z_window: int = 64, allow_zero_bubble: bool = True):
        self.pp = pp
        self.vpp = vpp
        self.alpha = alpha
        self.replan_margin = replan_margin
        # The caller may take zero-bubble out of the candidates (JAX does
        # where its one-program executor runs both backward halves every
        # slot). The port's executor runs each slot's own instruction on
        # its rank, so its trainer leaves it in.
        self.allow_zero_bubble = allow_zero_bubble
        self.base_costs = stage_cost_model(model_cfg, pp, vpp)
        self._ewma: Dict[Tuple[int, int], float] = {}
        self._z: Dict[Tuple[int, int], RollingZ] = {}
        self._z_window = z_window
        self._make_z = RollingZ
        self.current: Optional[PipelinePlan] = None
        self.replans = 0
        self._trace_seen = False
        self._validated: set = set()  # (schedule, M) already validated

    # -- signal ingestion --------------------------------------------------
    def observe_stage_time(self, stage: int, seconds: float,
                           vstage: int = 0):
        key = (int(stage), int(vstage))
        prev = self._ewma.get(key)
        self._ewma[key] = (seconds if prev is None
                           else self.alpha * seconds
                           + (1 - self.alpha) * prev)
        z = self._z.get(key)
        if z is None:
            z = self._z[key] = self._make_z(window=self._z_window)
        z.observe(seconds)

    def observe_step(self, step_seconds: float):
        """Whole-pipeline step sample (the straggler detector's view):
        distributed over stages by the current relative weights, so the
        EWMAs stay alive — and the plan stays stable — when tracing is
        off. A no-op once ring-hop trace samples have been ingested:
        those are per-SLOT stage-body times (~step/(M*vpp+pp-1)), a
        different unit from this per-step split (~step/pp) — mixing the
        two in one EWMA/RollingZ window would oscillate the exported
        gauges and flag phantom stragglers on uniform stages."""
        if self._trace_seen:
            return
        w = self.stage_costs()
        total = sum(w)
        for s in range(self.pp):
            self.observe_stage_time(s, step_seconds * w[s] / total)

    def ingest_trace_events(self, events) -> int:
        """Feed per-stage compute-time gaps mined from the pipeline's
        ring-hop spans (MegaScan → planner). Returns samples ingested."""
        from megatronapp_tpu_torch.trace.detect import stage_step_gaps
        n = 0
        by_stage = {s: g for s, g in stage_step_gaps(events).items()
                    if 0 <= s < self.pp}
        if any(by_stage.values()) and not self._trace_seen:
            # Real per-slot samples supersede the synthetic whole-step
            # split for the rest of the run (see observe_step) — drop
            # the synthetic history so this window is not judged
            # against the wrong unit.
            self._trace_seen = True
            self._ewma.clear()
            self._z.clear()
        for stage, gaps in by_stage.items():
            for g in gaps:
                self.observe_stage_time(stage, g)
                n += 1
        return n

    # -- planning ----------------------------------------------------------
    def stage_costs(self) -> List[float]:
        """Current relative per-stage costs: measured EWMAs (summed over
        vstages) when every stage has one, else the static table."""
        per_stage = [0.0] * self.pp
        seen = [False] * self.pp
        for (s, _v), val in self._ewma.items():
            per_stage[s] += val
            seen[s] = True
        if not all(seen):
            return list(self.base_costs)
        mean = sum(per_stage) / self.pp
        return ([c / mean for c in per_stage] if mean > 0
                else list(self.base_costs))

    def plan(self, num_microbatches: int) -> PipelinePlan:
        costs = self.stage_costs()
        cands: Dict[str, float] = {}
        if self.vpp > 1:
            cands["vpp"] = analytic_vpp_bubble(
                self.pp, num_microbatches, self.vpp, costs)
        else:
            scheds = (("1f1b", "zero-bubble") if self.allow_zero_bubble
                      else ("1f1b",))
            for sch in scheds:
                cands[sch] = simulate_timeline(
                    sch, self.pp, num_microbatches,
                    stage_costs=costs)["bubble_fraction"]
        best = min(cands, key=lambda k: cands[k])
        # Emit + validate the executable program for the winner before
        # recommending it (a planner must never hand the executor an
        # unvalidated program). Tables are deterministic in
        # (schedule, pp, M, vpp) and plan() runs every log interval
        # from the training hot loop, so each key is validated once.
        key = (best, num_microbatches)
        if key not in self._validated:
            fwd = forward_tables(self.pp, num_microbatches, self.vpp)
            bwd = (zb_backward_tables(self.pp, num_microbatches,
                                      self.vpp)
                   if best == "zero-bubble" else None)
            validate_programs(self.pp, num_microbatches, self.vpp, fwd,
                              bwd)
            self._validated.add(key)
        plan = PipelinePlan(schedule=best,
                            num_microbatches=num_microbatches,
                            vpp=self.vpp, bubble_fraction=cands[best],
                            candidates=cands, stage_costs=costs)
        if self.current is None:
            self.current = plan
        return plan

    def maybe_replan(self, num_microbatches: int
                     ) -> Optional[PipelinePlan]:
        """Re-plan with hysteresis: switch only when the winner differs
        from the current schedule AND the modeled bubble improves by more
        than replan_margin (absolute). Loud log + counter on switch."""
        new = self.plan(num_microbatches)
        cur = self.current
        if cur is None or cur.schedule == new.schedule:
            self.current = new
            return None
        if cur.schedule not in new.candidates:
            # The running schedule has no modeled bubble under this
            # planner configuration (e.g. zero-bubble under vpp > 1,
            # which the combined-timeline model does not cover yet) —
            # a fabricated comparison would force-switch away from a
            # user-configured schedule on no real measurement. Stay put.
            return None
        cur_bubble = new.candidates[cur.schedule]
        if cur_bubble - new.bubble_fraction <= self.replan_margin:
            # No switch — but adopt the just-computed costs/candidates
            # under the RUNNING schedule so the exported gauges track
            # the live signal instead of the startup snapshot.
            self.current = dataclasses.replace(
                new, schedule=cur.schedule, bubble_fraction=cur_bubble)
            return None
        self.replans += 1
        logger.warning(
            "pp-planner RE-PLAN: schedule %r -> %r (modeled bubble "
            "%.4f -> %.4f at M=%d, stage costs %s)", cur.schedule,
            new.schedule, cur_bubble, new.bubble_fraction,
            num_microbatches,
            [round(c, 3) for c in new.stage_costs])
        self.current = new
        return new

    # -- observability -----------------------------------------------------
    def export_metrics(self):
        """Per-(stage, vstage) EWMA + straggler-z gauges into the shared
        telemetry registry (/metrics), plus the current plan's modeled
        bubble — the planner's input signal made observable."""
        for (s, v), val in sorted(self._ewma.items()):
            telemetry.set_gauge(
                telemetry.labeled("pp_stage_step_time_ewma_ms",
                                  stage=s, vstage=v),
                round(val * 1e3, 4))
            z = self._z.get((s, v))
            if z is not None and z.last_z is not None:
                telemetry.set_gauge(
                    telemetry.labeled("pp_stage_straggler_z",
                                      stage=s, vstage=v),
                    round(z.last_z, 4))
        if self.current is not None:
            telemetry.set_gauge("pp_plan_bubble_fraction",
                                round(self.current.bubble_fraction, 4))
            telemetry.set_gauge("pp_plan_schedule_index",
                                SCHEDULES.index(self.current.schedule))
        telemetry.set_gauge("pp_planner_replans_total", self.replans)
