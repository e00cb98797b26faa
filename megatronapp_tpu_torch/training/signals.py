"""Signal-based graceful exit (the JAX package's training/signals.py).

``--exit-signal-handler`` installs a SIGTERM (optionally SIGINT) handler
that sets a flag; the train loop checks it after each step, finishes the
step, force-saves an emergency checkpoint and exits cleanly.

``any_process_flag`` is the go/no-go primitive behind every collective
decision (graceful exit, checkpoint save retry, restore walk-back): on a
rank grid (``ctx``) a max all-reduce of the flags over the world group,
so a SIGTERM that reaches one rank stops every rank after the same step;
on one process, the local flag.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


def any_process_flag(local: bool, ctx=None) -> bool:
    """True when any rank's flag is set (ctx: the grid; None: this
    process alone)."""
    if ctx is None or ctx.world == 1:
        return bool(local)
    import torch
    from megatronapp_tpu_torch.parallel.collectives import all_reduce
    flag = torch.tensor([int(bool(local))], dtype=torch.int32)
    return bool(all_reduce(flag, ctx, "world", op="max").item())


class DistSignalHandler:
    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,), ctx=None):
        self._signals = tuple(signals)
        self.ctx = ctx
        self._received = threading.Event()
        self._prev = {}

    @classmethod
    def for_config(cls, sigint: bool = False,
                   ctx=None) -> "DistSignalHandler":
        """Handler for the train loop: SIGTERM always (the preemption
        notice), SIGINT too with --exit-signal-handler-sigint (an
        interactive ^C drains through the same emergency save). ctx: the
        rank grid whose ranks agree on the exit."""
        sigs = [signal.SIGTERM]
        if sigint:
            sigs.append(signal.SIGINT)
        return cls(sigs, ctx)

    def __enter__(self):
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False

    def _handle(self, signum, frame):
        self._received.set()

    def should_exit(self) -> bool:
        """The agreed exit decision (any_process_flag of the flag)."""
        return any_process_flag(self._received.is_set(), self.ctx)
