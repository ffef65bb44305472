"""Diagnostics (counterpart of concepthash_tpu/utils/diagnostics.py):

- ``StepProfiler``: a ``torch.profiler`` trace of a window of train
  dispatches, written as a Chrome trace, and the host latency of each
  dispatch;
- ``DebugFlags`` (``apply_debug_flags``): ``debug.nans`` raises
  ``FloatingPointError`` at the first non-finite loss, metric or gradient
  of a train step, as ``jax_debug_nans`` does; ``debug.disable_jit`` runs
  eager steps (``train_chunk`` 1, nothing captured into a CUDA graph), as
  ``jax_disable_jit`` runs the reference op by op. Both keep the run on
  its device. The flags belong to the experiment that reads them, not to
  the process;
- preemption handling: SIGTERM or SIGINT asks the training loop to stop
  after a checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from contextlib import contextmanager

import torch


class StepProfiler:
    """Traces train dispatches [start_step, start_step + num_steps) with
    ``torch.profiler`` (the host, and the card where there is one) and
    keeps each dispatch's host seconds in ``step_times``. Config:
    ``profile: {enabled, start_step (10), num_steps (5), dir
    (<logdir>/profile)}``; the trace is ``<dir>/steps_<a>-<b>.json``. A
    dispatch is a graphed chunk or a single step, as the reference counts
    them."""

    def __init__(self, cfg: dict | None, logdir: str):
        cfg = cfg or {}
        self.enabled = bool(cfg.get("enabled", False))
        self.start_step = int(cfg.get("start_step", 10))
        self.num_steps = int(cfg.get("num_steps", 5))
        self.dir = cfg.get("dir") or os.path.join(logdir, "profile")
        self.trace_path = None
        self._prof = None
        self._step = 0
        self._t0 = None
        self.step_times: list[float] = []

    def step_start(self):
        self._t0 = time.perf_counter()
        if self.enabled and self._step == self.start_step and \
                self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            logging.info("profiler trace started at step %d -> %s",
                         self._step, self.dir)

    def step_end(self):
        if self._t0 is not None:
            self.step_times.append(time.perf_counter() - self._t0)
        self._step += 1
        if self._prof is not None and \
                self._step >= self.start_step + self.num_steps:
            self._stop()

    def _stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.trace_path = os.path.join(
            self.dir, f"steps_{self.start_step}-{self._step - 1}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        logging.info("profiler trace stopped at step %d: %s", self._step,
                     self.trace_path)

    def close(self):
        if self._prof is not None:
            self._stop()


@dataclasses.dataclass(frozen=True)
class DebugFlags:
    nans: bool = False
    disable_jit: bool = False


def apply_debug_flags(cfg: dict | None) -> DebugFlags:
    """``debug: {nans, disable_jit}`` as the experiment's flags."""
    cfg = cfg or {}
    flags = DebugFlags(bool(cfg.get("nans", False)),
                       bool(cfg.get("disable_jit", False)))
    if flags.nans:
        logging.info("debug: a non-finite loss or gradient raises")
    if flags.disable_jit:
        logging.info("debug: eager steps, nothing captured")
    return flags


def check_finite(metrics: dict, model: torch.nn.Module) -> None:
    """Raise ``FloatingPointError`` if a metric of the step or a gradient
    it left is not finite (``debug.nans``; reads them on the host)."""
    for k, v in metrics.items():
        if torch.is_tensor(v) and not bool(torch.isfinite(v).all()):
            raise FloatingPointError(f"debug.nans: the train step's {k} is "
                                     f"not finite ({v.float().cpu()})")
    for name, p in model.named_parameters():
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            raise FloatingPointError(f"debug.nans: the gradient of {name} "
                                     "is not finite")


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
