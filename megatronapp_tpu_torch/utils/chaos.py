"""Chaos fault-injection registry (the JAX package's utils/chaos.py, for
the sites this package has).

A small registry of NAMED fault-injection sites on the serving and
checkpoint paths.
Production code calls ``fire(site)`` at the injection point; tests
``arm()`` a site to make it raise a bounded number of times.

Design constraints:

- **Zero-cost when disabled.** The disabled path is a single truthiness
  check of a module-level dict (``if not _ARMED: return``) — no lookup,
  no lock, no allocation — so the sites can live inside the serving
  stepper without a measurable step-time change.
- **Bounded.** An armed fault fires ``times`` times (after skipping the
  first ``after`` hits) and then disarms itself: drills test recovery,
  not permanent outage.

Sites:

- ``stepper-step``  the serving stepper thread's engine.step() raises —
                    exercises the DynamicBatchingDriver watchdog (errors
                    to every waiter, pool reclaim, restart accounting).
- ``paged-evict``   the paged KV block allocator's LRU eviction fails
                    (inference/paged_cache.py _take_free) — exercises the
                    admit rollback: no leaked refcounts, audit() passes,
                    the next request succeeds.
- ``paged-cow``     the copy-on-write block copy of a fully cached prompt
                    fails (_copy_block) — exercises the admit rollback
                    with cached-prefix refs already acquired.
- ``lora-load``     a LoRA adapter fetch dies between reading the adapter's
                    weights from the registry and committing them into the
                    device banks (inference/lora.AdapterCache.acquire) —
                    exercises the cache's rollback (no slot taken, no
                    resident evicted, books unchanged, audit() clean) and
                    the engine's admission rollback (pool blocks released,
                    request requeued at the head, the retry succeeds).
- ``spec-verify``   a speculative round dies after its verify step wrote
                    every draft's KV and before anything is accepted
                    (inference/dynamic_engine.py _spec_round_inner) —
                    exercises the round's rollback: every slot rewinds to
                    its last verified length, audit() passes and the
                    retried round gives the stream a run without the
                    fault gives.
- ``checkpoint-save``        a durable checkpoint write attempt fails
                             (training/checkpointing.py CheckpointManager) —
                             exercises the bounded retry with backoff.
- ``local-checkpoint-save``  a non-persistent local save fails
                             (LocalCheckpointManager.save) — the train loop
                             warns and goes on (local saves are best-effort).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

SITES = ("stepper-step", "paged-evict", "paged-cow", "lora-load",
         "spec-verify", "checkpoint-save", "local-checkpoint-save")


class ChaosFault(RuntimeError):
    """The exception raised by an armed site."""


@dataclasses.dataclass
class _Fault:
    times: int = 1      # remaining fires (then auto-disarm)
    after: int = 0      # skip this many hits before the first fire
    hits: int = 0


_ARMED: Dict[str, _Fault] = {}
_LOCK = threading.Lock()


def arm(site: str, times: int = 1, after: int = 0) -> None:
    """Arm `site` to raise ChaosFault `times` times, skipping the first
    `after` hits."""
    if site not in SITES:
        raise ValueError(f"unknown chaos site {site!r}; known: {SITES}")
    if times < 1 or after < 0:
        raise ValueError("times must be >= 1 and after >= 0")
    with _LOCK:
        _ARMED[site] = _Fault(times=times, after=after)


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site (or all when site is None)."""
    with _LOCK:
        if site is None:
            _ARMED.clear()
        else:
            _ARMED.pop(site, None)


def active() -> bool:
    return bool(_ARMED)


def _consume(site: str) -> bool:
    with _LOCK:
        f = _ARMED.get(site)
        if f is None:
            return False
        f.hits += 1
        if f.hits <= f.after:
            return False
        f.times -= 1
        if f.times <= 0:
            del _ARMED[site]
        return True


def fire(site: str) -> None:
    """Raises ChaosFault when the armed fault fires. The disabled path is
    one dict truthiness check."""
    if not _ARMED:
        return
    if _consume(site):
        raise ChaosFault(f"chaos: injected fault at site {site!r}")
