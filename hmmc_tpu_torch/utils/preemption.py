"""SIGTERM sets a flag (counterpart of ``hmmc_tpu/utils/preemption.py``).

A preemptible machine receives SIGTERM shortly before it is taken away.
The train loops read :attr:`PreemptionWatcher.triggered` after every step
(over all ranks: ``distributed.any_rank``, so every rank saves and stops
at the same step even where one rank alone saw the signal), write the
exact (epoch, batch_in_epoch) state and return; ``--resume`` then trains
every remaining batch of the epoch once. The handler only sets the flag:
the save runs on the loop's schedule, never in the signal's context, and
further signals while it runs are absorbed.
"""

from __future__ import annotations

import signal
import threading


class PreemptionWatcher:
    """Handlers for ``signals`` while installed; ``triggered`` turns true
    when one arrives. Installed off the main thread (where Python cannot
    route signals) it stays inert."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev = {}
        self._event = threading.Event()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _on_signal(self, signum, frame):  # noqa: ARG002
        self._event.set()

    def install(self) -> "PreemptionWatcher":
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def __enter__(self) -> "PreemptionWatcher":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False
