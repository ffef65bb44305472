"""Streaming scalar meters for per-epoch metric aggregation (counterpart of
concepthash_tpu/utils/meters.py).

``MeterBank.update_device`` buffers a step's metrics as they come back,
device tensors included, and ``materialize`` brings the whole epoch's
values to the host in one copy, so a train loop synchronizes with the device
once per epoch, never per step.
"""

from __future__ import annotations

from collections import defaultdict

import torch


class AverageMeter:
    """Tracks a running average of a scalar."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __repr__(self):
        return f"{self.name}: {self.avg:.6f} ({self.count})"


class MeterBank:
    """A defaultdict of AverageMeters plus a device-friendly bulk update:
    ``update_device(metrics, n)`` buffers a dict of scalars (0-d tensors on
    any device, or numbers), or of (K,) stacks with ``n`` a list of K
    counts; ``materialize()`` copies all buffered values to
    the host at once and returns ``{key: avg}``."""

    def __init__(self):
        self.meters = defaultdict(AverageMeter)
        self._pending = []  # list of (metrics_dict, n)

    def update(self, key: str, val, n: int = 1):
        self.meters[key].update(val, n)

    def update_device(self, metrics: dict, n=1):
        """Buffer one step's metrics, or a chunk's: with ``n`` a list of K
        counts, each metric is stacked (K,) and row k counts ``n[k]``."""
        if isinstance(n, (list, tuple)):
            for k, nk in enumerate(n):
                self._pending.append(({key: v[k] for key, v in
                                       metrics.items()}, nk))
            return
        self._pending.append((metrics, n))

    def materialize(self) -> dict:
        entries = [(k, v, n) for metrics, n in self._pending
                   for k, v in metrics.items()]
        self._pending.clear()
        if entries:
            vals = [torch.as_tensor(v).detach().reshape(()).double()
                    for _, v, _ in entries]
            dev = next((t.device for t in vals if t.device.type != "cpu"),
                       torch.device("cpu"))
            host = torch.stack([t.to(dev) for t in vals]).tolist()
            for (k, _, n), val in zip(entries, host):
                self.meters[k].update(val, n)
        return {k: m.avg for k, m in self.meters.items()}
