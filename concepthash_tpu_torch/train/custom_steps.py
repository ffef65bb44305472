"""Train steps of their own, for the methods whose update is not
``state.make_train_step``'s (counterpart of the ``custom_step`` and
``init_extra`` hooks of concepthash_tpu/methods.py). A run takes one of
them one step per dispatch, whatever ``train_chunk`` is, as the reference
builds no multi step for one.

HashNet (``hashnet_step``, ``hashnet_extra``): the pairwise loss on
tanh(beta * codes) with the continuation beta = sqrt(floor(ep /
step_continuation) + 1) in float32, ``ep`` the epoch of the step counter,
and, with ``criterion.keep_train_size``, a bank of every train image's
last tanh code ``U`` and label ``Y`` (the train state's ``extra``): each
step writes its batch's rows, detached, at the batch's dataset indices and
scores the batch against the whole bank. The step takes the schedule's
float32 rates as every step does (``optim.follow_schedule``).

ODC (``odc_step``, ``odc_extra``), online deep clustering on the ``ce``
head: the train state's extras hold a memory of every train image's
L2-normalized code (``features``), its pseudo-label (``labels``), the
clusters' ``centroids`` and their loss ``weights``, which the experiment
fills from a k-means of the train codes before the first epoch. A step
takes the cross-entropy against the batch's pseudo-labels, weighted by
their clusters' weights (sum(w_i ce_i) / sum(w_i)); moves the batch's
memory rows toward its new normalized codes (``criterion.memory_momentum``,
0.5); reassigns the batch's labels to the nearest current centroid; and at
every step whose count before it is a multiple of ``update_interval`` (or
``cluster_interval``) recomputes the centroids from the whole memory (an
empty cluster keeps its centroid) and the weights as N_c^-0.5 over the
non-empty clusters, normalized to sum 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch.losses.baselines import pairwise_exp_loss
from concepthash_tpu_torch.train.optim import follow_schedule


def hashnet_beta(step: int, steps_per_epoch: int,
                 step_continuation: int) -> float:
    """The continuation's beta at optimizer step ``step``, float32."""
    ep = np.float32(step // max(steps_per_epoch, 1))
    return float(np.sqrt(np.floor(ep / np.float32(step_continuation))
                         + np.float32(1.0)))


def hashnet_step(model: nn.Module, config: dict,
                 optimizer: torch.optim.Optimizer, scheduler,
                 generator: Optional[torch.Generator], steps_per_epoch: int,
                 extra: dict, mesh=None):
    """step(batch) -> metrics: HashNet's update. batch holds image (B, H,
    W, C) normalized, label (B, C) one-hot and, with the bank, index (B,)
    the dataset rows; metrics are the loss, its ``pairwise`` part, ``beta``
    and the accuracies, detached 0-d tensors. Under a ``mesh`` the batch is
    this rank's block, and the loss, the bank's rows and the metrics are
    the global batch's on every rank."""
    from concepthash_tpu_torch.train.state import (accuracy_metrics,
                                                   backward, sharded_forward)

    crit = dict(config.get("criterion", {}) or {})
    alpha = float(crit.get("alpha", 1.0))
    step_cont = int(crit.get("step_continuation", 20))
    keep = bool(int(crit.get("keep_train_size", 0)))

    def step(batch: dict) -> dict:
        beta = hashnet_beta(int(scheduler.last_epoch), steps_per_epoch,
                            step_cont)
        out, batch = sharded_forward(model, batch, mesh, train=True,
                                     generator=generator)
        y = batch["label"].float()
        u = torch.tanh(beta * out["codes"])
        if keep:
            idx = batch["index"].long()
            extra["U"].index_copy_(0, idx, u.detach())
            extra["Y"].index_copy_(0, idx, y)
            loss = pairwise_exp_loss(u, y, extra["U"], extra["Y"], alpha)
        else:
            loss = pairwise_exp_loss(u, y, u, y, alpha)
        backward(loss, optimizer, mesh)
        follow_schedule(optimizer, scheduler)
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            return {"loss": loss.detach(), "pairwise": loss.detach(),
                    "beta": torch.full_like(loss.detach(), beta),
                    **accuracy_metrics(out, y)}

    return step


def _train_size(config: dict, what: str) -> int:
    crit = dict(config.get("criterion", {}) or {})
    n = int(config.get("_train_size_", 0) or crit.get("train_size", 0))
    if n <= 0:
        raise ValueError(f"{what} needs the train-set size "
                         "(config['_train_size_'], set by the experiment)")
    return n


def hashnet_extra(config: dict, model: nn.Module) -> dict:
    """The bank of ``keep_train_size`` (zeros: U (N, nbit), Y (N, nclass)
    float32 on the model's device, N the train-set size the experiment puts
    in ``config['_train_size_']``), or nothing."""
    crit = dict(config.get("criterion", {}) or {})
    if not int(crit.get("keep_train_size", 0)):
        return {}
    n = _train_size(config, "keep_train_size")
    m = config["model"]
    dev = next(model.parameters()).device
    return {"U": torch.zeros((n, int(m["nbit"])), device=dev),
            "Y": torch.zeros((n, int(m["nclass"])), device=dev)}


def odc_settings(config: dict) -> tuple:
    """(memory momentum, centroid update interval, clusters) of ODC."""
    crit = dict(config.get("criterion", {}) or {})
    interval = crit.get("update_interval", crit.get("cluster_interval", 10))
    return (float(crit.get("memory_momentum", 0.5)), int(interval),
            int(config["model"]["nclass"]))


def odc_extra(config: dict, model: nn.Module) -> dict:
    """ODC's memory, zeros until the experiment's k-means fills it:
    ``features`` (N, nbit) and ``labels`` (N,) int64 for the N train
    images, ``centroids`` (k, nbit) and ``weights`` (k,)."""
    n = _train_size(config, "odc")
    nbit = int(config["model"]["nbit"])
    k = odc_settings(config)[2]
    dev = next(model.parameters()).device
    return {"features": torch.zeros((n, nbit), device=dev),
            "labels": torch.zeros(n, dtype=torch.long, device=dev),
            "centroids": torch.zeros((k, nbit), device=dev),
            "weights": torch.zeros(k, device=dev)}


def odc_init_weights(counts: torch.Tensor) -> torch.Tensor:
    """The weights of the initial clustering: N_c^-0.5 over the non-empty
    clusters, normalized to mean 1 over them."""
    rw = torch.where(counts > 0, 1.0 / counts.clamp_min(1.0).sqrt(), 0.0)
    nonempty = max(int((counts > 0).sum()), 1)
    return rw / max(float(rw.sum()) / nonempty, 1e-12)


def odc_step(model: nn.Module, config: dict,
             optimizer: torch.optim.Optimizer, scheduler,
             generator: Optional[torch.Generator], steps_per_epoch: int,
             extra: dict, mesh=None):
    """step(batch) -> metrics: ODC's update. batch holds image (B, H, W,
    C) normalized and index (B,) the dataset rows (distinct); metrics are
    the loss, ``ce`` and the accuracy against the pseudo-labels. Under a
    ``mesh`` the batch is this rank's block, and the loss and the memory's
    updates are the gathered global batch's on every rank."""
    from concepthash_tpu_torch.train.state import (accuracy_metrics,
                                                   backward, sharded_forward)

    momentum, interval, k = odc_settings(config)
    mem, labels = extra["features"], extra["labels"]
    cents, weights = extra["centroids"], extra["weights"]

    def step(batch: dict) -> dict:
        refresh = int(scheduler.last_epoch) % interval == 0
        out, batch = sharded_forward(model, batch, mesh, train=True,
                                     generator=generator)
        idx = batch["index"].long()
        pseudo = labels[idx]
        y = F.one_hot(pseudo, k).float()
        w = weights[pseudo]
        ce = -(y * torch.log_softmax(out["logits"].float(), -1)).sum(-1)
        loss = (ce * w).sum() / w.sum().clamp_min(1e-12)
        backward(loss, optimizer, mesh)
        follow_schedule(optimizer, scheduler)
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            feats = out["codes"].detach().float()
            feats = feats / torch.linalg.vector_norm(
                feats, dim=-1, keepdim=True).clamp_min(1e-12)
            cur = mem[idx]
            rows = cur - momentum * (cur - feats)
            mem.index_copy_(0, idx, rows)
            d = ((rows[:, None] - cents[None]) ** 2).sum(-1)
            labels.index_copy_(0, idx, d.argmin(1))
            if refresh:
                onehot = F.one_hot(labels, k).float()
                counts = onehot.sum(0)
                new = (onehot.t() @ mem) / counts.clamp_min(1.0)[:, None]
                cents.copy_(torch.where(counts[:, None] > 0, new, cents))
                rw = torch.where(counts > 0,
                                 1.0 / counts.clamp_min(1.0).sqrt(), 0.0)
                weights.copy_(rw / rw.sum().clamp_min(1e-12))
            return {"loss": loss.detach(), "ce": loss.detach(),
                    **accuracy_metrics(out, y)}

    return step
