"""Preemption handling (counterpart of the signal part of
concepthash_tpu/utils/diagnostics.py): SIGTERM or SIGINT asks the training
loop to stop after a checkpoint. The profiler and debug flags of the
reference (``profile:``, ``debug:``) are not ported."""

from __future__ import annotations

import logging
import signal
from contextlib import contextmanager


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop; the
    training loop checks ``should_stop`` each epoch and saves 'last' before
    it exits."""

    def __init__(self):
        self.should_stop = False
        self._installed = False
        self._prev = {}

    def install(self):
        if self._installed:
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                return self
        self._installed = True
        return self

    def _handler(self, signum, frame):
        logging.warning("signal %s received: checkpoint-and-stop requested",
                        signum)
        self.should_stop = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._installed = False


@contextmanager
def guarded_training():
    guard = PreemptionGuard().install()
    try:
        yield guard
    finally:
        guard.uninstall()
