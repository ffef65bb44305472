"""Logging setup, the experiment-history JSON writer and the config-gated
event tracker (counterpart of concepthash_tpu/utils/logger.py).

``Tracker`` stands behind the reference's ``wandb:`` key (default off): when
set, events go to ``<logdir>/events.jsonl``, one JSON object per line, and
nothing goes to a network service. ``HistoryWriter`` keeps
``train_history.json`` and ``test_history.json``, the run's record.
"""

from __future__ import annotations

import json
import logging
import os
import sys


def setup_logging(logfile: str | None = None, level=logging.INFO):
    root = logging.getLogger()
    root.setLevel(level)
    # a second call (a second run in one process) replaces the handlers
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if logfile:
        os.makedirs(os.path.dirname(logfile), exist_ok=True)
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        root.addHandler(fh)


class Tracker:
    """Config-gated experiment-event emitter (the ``wandb:`` key,
    configs/train.yaml, default False).

    ``cfg`` is the config's ``wandb`` value: falsy -> disabled (every call a
    no-op); truthy -> append events to ``<logdir>/events.jsonl``. ``log``
    accumulates fields into the pending event (wandb.log(commit=False)
    semantics); ``commit`` writes it as one JSON line.
    """

    def __init__(self, cfg, logdir: str):
        self.enabled = bool(cfg)
        self.path = os.path.join(logdir, "events.jsonl")
        self._pending: dict = {}
        if self.enabled:
            logging.info("tracker enabled -> %s", self.path)

    def log(self, d: dict):
        if self.enabled:
            self._pending.update(_to_jsonable(d))

    def commit(self):
        if self.enabled and self._pending:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(self._pending) + "\n")
            self._pending = {}


class HistoryWriter:
    """Append-only experiment history persisted as JSON
    (``<logdir>/<name>_history.json``), the reference's file layout.
    ``write=False`` keeps the history in memory only (a data-parallel
    run's ranks but the first)."""

    def __init__(self, logdir: str, name: str, tracker: Tracker | None = None,
                 write: bool = True):
        self.path = os.path.join(logdir, f"{name}_history.json")
        self.name = name
        self.tracker = tracker
        self.write = write
        self.history: list[dict] = []

    def append(self, record: dict):
        rec = _to_jsonable(record)
        self.history.append(rec)
        if self.tracker is not None:
            # wandb-style namespacing: train/loss, test/mAP, ...
            self.tracker.log({f"{self.name}/{k}": v for k, v in rec.items()})
            self.tracker.commit()
        self.save()

    def save(self):
        if not self.write:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.history, f, indent=2)


def _to_jsonable(x):
    import numpy as np
    import torch

    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        return x.item()
    if isinstance(x, (np.ndarray,)):
        return x.tolist()
    return x
