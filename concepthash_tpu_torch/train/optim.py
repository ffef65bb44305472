"""Optimizer and LR-schedule factories and the backbone-freeze policy
(counterpart of concepthash_tpu/train/optim.py).

The schedules are epoch-granular: the LR changes once per epoch. They are a
multiplier of the base LR in the arithmetic of the epoch they are given.
Every optimizer step, on every device and at every ``train_chunk``, takes
the float32 rate of the reference's optax schedule (``scheduled_lrs``:
``float32(mult) * float32(base)`` per group, the logged ``current_lr`` for
group 0): ``EpochLambdaLR``, stepped once per optimizer step, writes it, so
update k uses ``mult(k // steps_per_epoch)`` as the reference does. On the
card the optimizer is capturable (``make_capturable``) at every
``train_chunk``, its rates float32 device tensors that a single step sets
from ``follow_schedule`` and a graphed chunk from ``scheduled_lrs``.

The optimizers follow the reference's update rules: adam couples weight decay
into the gradient (``torch.optim.Adam``'s ``weight_decay`` is
``optax.add_decayed_weights`` followed by ``scale_by_adam``); adamw decouples
it; sgd adds it to the gradient before momentum (optional nesterov); lars
is ``optax.lars`` (``Lars``). All four can be made capturable
(``make_capturable``) for several steps per CUDA graph; sgd does so through
``CapturableSGD``, whose step reads a tensor rate on the device, and
``Lars`` reads its rate as given, a float or a device tensor.

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
        return CapturableSGD(groups, lr=lr,
                               momentum=float(optim_cfg.get("momentum", 0.0)),
                               nesterov=bool(optim_cfg.get("nesterov", False)),
                               weight_decay=wd)
    if name == "lars":
        return Lars(groups, lr=lr, weight_decay=wd,
                    momentum=float(optim_cfg.get("momentum", 0.9)))
    raise ValueError(f"unknown optimizer {name!r}")


class CapturableSGD(torch.optim.SGD):
    """``torch.optim.SGD`` whose step a CUDA graph can capture once
    ``make_capturable`` has made its rates device tensors: the stock step
    turns a tensor rate into a host number (``alpha=-lr``), which waits on
    the card. The update is the stock one (weight decay into the gradient,
    then momentum with dampening, optional nesterov, optional maximize),
    applied as ``p -= lr * d``; with float rates the stock step runs."""

    @torch.no_grad()
    def step(self, closure=None):
        if not torch.is_tensor(self.param_groups[0]["lr"]):
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["maximize"]:
                grads = torch._foreach_neg(grads)
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            momentum = group["momentum"]
            if momentum:
                bufs = []
                for p, g in zip(params, grads):
                    state = self.state[p]
                    buf = state.get("momentum_buffer")
                    if buf is None:
                        buf = state["momentum_buffer"] = g.detach().clone()
                    else:
                        buf.mul_(momentum).add_(g,
                                                alpha=1 - group["dampening"])
                    bufs.append(buf)
                grads = (torch._foreach_add(grads, bufs, alpha=momentum)
                         if group["nesterov"] else bufs)
            torch._foreach_sub_(params, torch._foreach_mul(grads,
                                                           group["lr"]))
        return loss


class Lars(torch.optim.Optimizer):
    """LARS with ``optax.lars``'s arithmetic (its defaults: trust
    coefficient 1e-3, eps 0, no nesterov), per parameter tensor:

        u = g + weight_decay * p
        u = u * (1e-3 * |p| / |u|)      (ratio 1 where |p| or |u| is 0)
        u = lr * u
        m = u + momentum * m;  p -= m

    The momentum buffer holds updates already scaled by the learning rate,
    unlike ``torch.optim.SGD``'s. ``lr`` may be a float or a device tensor
    (``make_capturable``): the step reads it on the device and waits on
    nothing, so a CUDA graph captures it as it is."""

    TRUST_COEFFICIENT = 1e-3

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 momentum: float = 0.9):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay,
                                  "momentum": momentum})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            wd, lr = group["weight_decay"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad + wd * p if wd else p.grad
                pn, un = torch.linalg.vector_norm(p), \
                    torch.linalg.vector_norm(u)
                ratio = torch.where((pn == 0) | (un == 0), 1.0,
                                    self.TRUST_COEFFICIENT * pn / un)
                u = (u * ratio) * lr
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = state["momentum_buffer"]
                buf.mul_(group["momentum"]).add_(u)
                p.sub_(buf)
        return loss


class EpochLambdaLR(torch.optim.lr_scheduler.LambdaLR):
    """``LambdaLR`` at ``mult(step // steps_per_epoch)`` that keeps the
    epoch law for ``scheduled_lrs`` (and out of its state dict) and writes
    each group the float32 rate ``scheduled_lrs`` gives, as a Python float
    (exact: a float32 value is a double), not ``LambdaLR``'s double
    product."""

    def __init__(self, optimizer, mult: Callable, steps_per_epoch: int):
        self.epoch_multiplier = mult
        self.steps_per_epoch = steps_per_epoch
        super().__init__(optimizer,
                         lambda step: mult(step // steps_per_epoch))

    def get_lr(self) -> list:
        return [float(r) for r in scheduled_lrs(self, self.last_epoch, 1)[0]]

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd.pop("epoch_multiplier", None)
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        mult = self.epoch_multiplier
        super().load_state_dict(state_dict)
        self.epoch_multiplier = mult


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
    return optimizer, EpochLambdaLR(optimizer, mult, spe)


def scheduled_lrs(scheduler, start: int, count: int) -> np.ndarray:
    """(count, groups) float32: each group's learning rate at optimizer steps
    ``start .. start + count - 1`` of a ``build_optimizer`` scheduler, in
    ``current_lr``'s float32 arithmetic (its column 0 equals
    ``current_lr`` at those steps)."""
    mult = scheduler.epoch_multiplier
    spe = scheduler.steps_per_epoch
    m = np.array([np.float32(mult(np.float32(s // spe)))
                  for s in range(start, start + count)], np.float32)
    base = np.array(scheduler.base_lrs, np.float32)
    return (m[:, None] * base[None, :]).astype(np.float32)


def make_capturable(optimizer: torch.optim.Optimizer) -> list:
    """Turn an optimizer of ``build_optimizer`` (adam, adamw, sgd or lars)
    into one whose step a CUDA graph can capture: each group's ``lr`` a
    float32 tensor on its parameters' device (which ``LambdaLR`` fills in
    place); adam and adamw also get ``capturable=True`` and their ``step``
    counters moved there (sgd and lars keep no counter). Returns the
    groups' ``lr`` tensors;
    a caller that captures the step writes them before each step, since a
    captured step reads the tensor, not a Python float. Idempotent."""
    adam = isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW))
    if not adam and not isinstance(optimizer, (CapturableSGD, Lars)):
        # a guard: build_optimizer builds none but these four
        raise NotImplementedError(
            f"several steps per dispatch on the card take adam, adamw, sgd "
            f"or lars as build_optimizer builds them; a stock "
            f"{type(optimizer).__name__} has no capturable step (ROADMAP, "
            "the deliberate differences: CapturableSGD)")
    lrs = []
    for group in optimizer.param_groups:
        dev = group["params"][0].device
        if not torch.is_tensor(group["lr"]):
            group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32,
                                       device=dev)
        lrs.append(group["lr"])
        if not adam:
            continue
        group["capturable"] = True
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st and st["step"].device != p.device:
                st["step"] = st["step"].to(p.device, torch.float32)
    return lrs


def follow_schedule(optimizer: torch.optim.Optimizer, scheduler) -> None:
    """Before a single step of a capturable optimizer: set its ``lr``
    tensors to ``scheduled_lrs`` at the schedule's step, the float32 rates a
    graphed chunk uses, so that single steps and graphed ones of one run
    share their arithmetic. An optimizer with float rates is left to
    ``EpochLambdaLR``, which writes the same float32 values."""
    if scheduler is None or not hasattr(scheduler, "epoch_multiplier"):
        return
    groups = optimizer.param_groups
    if not torch.is_tensor(groups[0]["lr"]):
        return
    rates = scheduled_lrs(scheduler, int(scheduler.last_epoch), 1)[0]
    for group, lr in zip(groups, rates):
        group["lr"].fill_(float(lr))


def set_schedule_step(optimizer: torch.optim.Optimizer, scheduler,
                      step: int) -> None:
    """Put an ``EpochLambdaLR`` schedule at optimizer step ``step`` (a
    resumed JAX run's count) and its rates into the groups, float or
    device tensor."""
    scheduler.last_epoch = int(step)
    rates = scheduler.get_lr()
    for group, lr in zip(optimizer.param_groups, rates):
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    scheduler._last_lr = rates


def current_lr(optim_cfg: dict, scheduler_cfg: dict | None, epochs: int,
               steps_per_epoch: int, step: int) -> float:
    """The base group's learning rate at optimizer step ``step``, for the
    logs, in float32 as the reference's optax schedule computes it (so the
    two histories carry the same numbers)."""
    mult = epoch_multiplier(scheduler_cfg, epochs)(
        np.float32(step // max(steps_per_epoch, 1)))
    return float(np.float32(float(optim_cfg.get("lr", 1e-4)))
                 * np.float32(mult))
