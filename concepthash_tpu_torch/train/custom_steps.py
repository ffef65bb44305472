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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
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
                 extra: dict):
    """step(batch) -> metrics: HashNet's update. batch holds image (B, H,
    W, C) normalized, label (B, C) one-hot and, with the bank, index (B,)
    the dataset rows; metrics are the loss, its ``pairwise`` part, ``beta``
    and the accuracies, detached 0-d tensors."""
    from concepthash_tpu_torch.train.state import accuracy_metrics

    crit = dict(config.get("criterion", {}) or {})
    alpha = float(crit.get("alpha", 1.0))
    step_cont = int(crit.get("step_continuation", 20))
    keep = bool(int(crit.get("keep_train_size", 0)))

    def step(batch: dict) -> dict:
        beta = hashnet_beta(int(scheduler.last_epoch), steps_per_epoch,
                            step_cont)
        y = batch["label"].float()
        out = model(batch["image"], train=True, generator=generator)
        u = torch.tanh(beta * out["codes"])
        if keep:
            idx = batch["index"].long()
            extra["U"].index_copy_(0, idx, u.detach())
            extra["Y"].index_copy_(0, idx, y)
            loss = pairwise_exp_loss(u, y, extra["U"], extra["Y"], alpha)
        else:
            loss = pairwise_exp_loss(u, y, u, y, alpha)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        follow_schedule(optimizer, scheduler)
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            return {"loss": loss.detach(), "pairwise": loss.detach(),
                    "beta": torch.full_like(loss.detach(), beta),
                    **accuracy_metrics(out, y)}

    return step


def hashnet_extra(config: dict, device) -> dict:
    """The bank of ``keep_train_size`` (zeros: U (N, nbit), Y (N, nclass)
    float32 on ``device``, N the train-set size the experiment puts in
    ``config['_train_size_']``), or nothing."""
    crit = dict(config.get("criterion", {}) or {})
    if not int(crit.get("keep_train_size", 0)):
        return {}
    n = int(config.get("_train_size_", 0) or crit.get("train_size", 0))
    if n <= 0:
        raise ValueError("keep_train_size needs the train-set size "
                         "(config['_train_size_'], set by the experiment)")
    m = config["model"]
    return {"U": torch.zeros((n, int(m["nbit"])), device=device),
            "Y": torch.zeros((n, int(m["nclass"])), device=device)}
