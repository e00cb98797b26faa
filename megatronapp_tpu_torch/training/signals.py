"""Signal-based graceful exit (the JAX package's training/signals.py, for
one process).

``--exit-signal-handler`` installs a SIGTERM (optionally SIGINT) handler
that sets a flag; the train loop checks it after each step, finishes the
step, force-saves an emergency checkpoint and exits cleanly.

``any_process_flag`` is the go/no-go primitive behind every collective
decision (graceful exit, checkpoint save retry, restore walk-back). The
port's trainer runs on one device in one process, so the agreed flag is
the local one; the all-gather of the multi-process JAX trainer comes with
the parallel-training slice.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


def any_process_flag(local: bool) -> bool:
    """True when any process's flag is set: on one process, `local`."""
    return bool(local)


class DistSignalHandler:
    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._received = threading.Event()
        self._prev = {}

    @classmethod
    def for_config(cls, sigint: bool = False) -> "DistSignalHandler":
        """Handler for the train loop: SIGTERM always (the preemption
        notice), SIGINT too with --exit-signal-handler-sigint (an
        interactive ^C drains through the same emergency save)."""
        sigs = [signal.SIGTERM]
        if sigint:
            sigs.append(signal.SIGINT)
        return cls(sigs)

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
        return any_process_flag(self._received.is_set())
