"""Optimizer and LR-schedule factories and the backbone-freeze policy
(counterpart of concepthash_tpu/train/optim.py).

The schedules are epoch-granular: the LR changes once per epoch. They are a
multiplier of the base LR in the arithmetic of the epoch they are given:
double for training, float32 for the logged ``current_lr``, as the
reference's optax schedule computes it. Training applies them through
``torch.optim.lr_scheduler.LambdaLR`` stepped once per optimizer step, so
update k uses ``mult(k // steps_per_epoch)`` as the reference does.

The optimizers follow the reference's update rules: adam couples weight decay
into the gradient (``torch.optim.Adam``'s ``weight_decay`` is
``optax.add_decayed_weights`` followed by ``scale_by_adam``); adamw decouples
it; sgd adds it to the gradient before momentum (optional nesterov).

``backbone_lr_scale`` is the reference's param-group policy: a parameter
whose name starts with ``backbone.`` and contains no ``adapter`` is frozen
when the scale is 0 (``requires_grad=False`` and no optimizer state, so no
gradient is computed for it), and runs in its own group at ``lr * scale``
otherwise.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn


# ---------------------------------------------------------------------------
# epoch-granularity schedules (value = multiplier of the base lr)
# ---------------------------------------------------------------------------

def cosine_decay_linear_warmup(epochs: int,
                               warmup_epochs: int = 10) -> Callable:
    def mult(ep):
        if ep < warmup_epochs:
            return min((ep + 1.0) / max(warmup_epochs, 1), 1.0)
        span = max(epochs - warmup_epochs, 1)
        arg = np.pi * (ep - warmup_epochs) / span
        # the cosine rounded once to arg's type (XLA's float32 cosine is
        # within an ulp of that)
        return 0.5 * (1.0 + type(arg)(math.cos(arg)))

    return mult


def step_decay(step_size: int, gamma: float = 0.1) -> Callable:
    return lambda ep: gamma ** (ep // step_size)


def milestones_decay(milestones: list, gamma: float = 0.1) -> Callable:
    ms = sorted(int(m) for m in milestones)
    # the count in ep's own type: a float32 ep gives float32 arithmetic
    return lambda ep: gamma ** type(ep)(sum(bool(ep >= m) for m in ms))


def no_decay() -> Callable:
    return lambda ep: 1.0


def epoch_multiplier(scheduler_cfg: dict | None, epochs: int) -> Callable:
    """The schedule named in ``scheduler_cfg`` as mult(epoch)."""
    cfg = scheduler_cfg or {}
    name = cfg.get("name", "csw")
    if name in ("csw", "cosine", "cosine_decay_linear_warmup"):
        return cosine_decay_linear_warmup(epochs,
                                          int(cfg.get("warmup_epochs", 10)))
    if name == "step":
        return step_decay(int(cfg.get("step_size", 30)),
                          float(cfg.get("gamma", 0.1)))
    if name == "milestones":
        return milestones_decay(cfg.get("milestones", []),
                                float(cfg.get("gamma", 0.1)))
    if name in ("no_decay", "none", "constant"):
        return no_decay()
    raise ValueError(f"unknown scheduler {name!r}")


def build_schedule(scheduler_cfg: dict | None, epochs: int,
                   steps_per_epoch: int, base_lr: float) -> Callable:
    """lr(step) with the epoch-granularity multiplier."""
    mult = epoch_multiplier(scheduler_cfg, epochs)
    return lambda step: base_lr * mult(step // max(steps_per_epoch, 1))


# ---------------------------------------------------------------------------
# optimizers and the freeze policy
# ---------------------------------------------------------------------------

def is_backbone_param(name: str) -> bool:
    return name.split(".")[0] == "backbone" and "adapter" not in name


def param_labels(model: nn.Module) -> dict:
    """'backbone' for non-adapter backbone parameters, 'train' for the
    rest, by parameter name."""
    return {n: "backbone" if is_backbone_param(n) else "train"
            for n, _ in model.named_parameters()}


def _base_optimizer(optim_cfg: dict, groups: list,
                    lr: float) -> torch.optim.Optimizer:
    name = optim_cfg.get("name", "adam")
    wd = float(optim_cfg.get("weight_decay", 0.0))
    betas = (float(optim_cfg.get("beta1", 0.9)),
             float(optim_cfg.get("beta2", 0.999)))
    eps = float(optim_cfg.get("eps", 1e-8))
    if name == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=betas, eps=eps,
                                weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=betas, eps=eps,
                                 weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr,
                               momentum=float(optim_cfg.get("momentum", 0.0)),
                               nesterov=bool(optim_cfg.get("nesterov", False)),
                               weight_decay=wd)
    if name == "lars":
        raise NotImplementedError("the lars optimizer is not ported yet")
    raise ValueError(f"unknown optimizer {name!r}")


def build_optimizer(optim_cfg: dict, scheduler_cfg: dict | None, epochs: int,
                    steps_per_epoch: int, model: nn.Module,
                    backbone_lr_scale: float = 1.0):
    """(optimizer, scheduler) over ``model``'s parameters, with the freeze
    policy applied (scale 0 sets ``requires_grad=False`` on the frozen
    parameters). Step the scheduler once after every optimizer step."""
    base_lr = float(optim_cfg.get("lr", 1e-4))
    labels = param_labels(model)
    named = dict(model.named_parameters())
    train = [p for n, p in named.items() if labels[n] == "train"]
    backbone = [p for n, p in named.items() if labels[n] == "backbone"]
    if backbone_lr_scale == 1.0 or not backbone:
        groups = [{"params": train + backbone}]
    elif backbone_lr_scale == 0.0:
        for p in backbone:
            p.requires_grad_(False)
        groups = [{"params": train}]
    else:
        groups = [{"params": train},
                  {"params": backbone,
                   "lr": base_lr * float(backbone_lr_scale)}]
    optimizer = _base_optimizer(optim_cfg, groups, base_lr)
    mult = epoch_multiplier(scheduler_cfg, epochs)
    spe = max(steps_per_epoch, 1)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: mult(step // spe))
    return optimizer, scheduler


def current_lr(optim_cfg: dict, scheduler_cfg: dict | None, epochs: int,
               steps_per_epoch: int, step: int) -> float:
    """The base group's learning rate at optimizer step ``step``, for the
    logs, in float32 as the reference's optax schedule computes it (so the
    two histories carry the same numbers)."""
    mult = epoch_multiplier(scheduler_cfg, epochs)(
        np.float32(step // max(steps_per_epoch, 1)))
    return float(np.float32(float(optim_cfg.get("lr", 1e-4)))
                 * np.float32(mult))
