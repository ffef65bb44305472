"""The train steps of the EMA-teacher pretraining methods and of TBH
(counterpart of concepthash_tpu/train/pretrain_steps.py), for the
``custom_step`` and ``init_extra`` hooks of ``methods.py``: one step a
dispatch, whatever ``train_chunk`` is, with the train state's extras (the
teacher, DINO's center, TBH's discriminator and its optimizer) updated in
place.

MoCo v3 (``moco_step``): the teacher's projections of both views, then the
student's predictions; the symmetric InfoNCE between each view's prediction
and the other view's teacher projection; the update; then the teacher
moves toward the updated student by the cosine momentum of the step
before it (``cosine_momentum``, float32).

DINO (``dino_step``): cross-entropy between the teacher's
softmax((t - center) / tau_t) of one view and the student's
log-softmax(s / tau_s) of the other, both ways; the update; the teacher at
the constant momentum; the center toward the mean of the teacher's
projections of both views.

The teacher (``teacher_extra``) is a copy of the whole model, frozen
parameters included, and its EMA covers every parameter as
``teacher * m + student * (1 - m)``. Its forwards run in train mode without
gradients, so they take the student's route (kernels 5 and 6 under the
kernel settings). The two views are the train batch's halves, ``[v1;
v2]`` (the experiment draws them, as for every ``two_view`` method).

TBH (``tbh_step``): the actor step (the reconstruction of the detached
feature plus ``adv_weight`` times the loss of the discriminator, as it
stands, calling z real), then the critic step (the discriminator's
binary cross-entropy between a uniform prior drawn from the run's
generator, real, and the detached z, fake) with its own Adam
(``tbh_extra``: ``criterion.disc_lr``, the discriminator seeded from
``seed + 9``; capturable on the card, as the main optimizer is).
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch.models.tbh import Discriminator
from concepthash_tpu_torch.ops.numerics import l2_normalize
from concepthash_tpu_torch.train.optim import follow_schedule, make_capturable


def cosine_momentum(step: int, total_steps: int, base_m: float) -> float:
    """MoCo's teacher momentum at ``step``: from ``base_m`` up to 1 along a
    half cosine over ``total_steps``, in float32."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
    m = f32(1) - (f32(1) - f32(base_m)) * f32(0.5) * (
        f32(1) + np.cos(f32(math.pi) * frac))
    return float(m)


@torch.no_grad()
def ema_(teacher: nn.Module, student: nn.Module, m: float) -> None:
    """teacher = teacher * m + student * (1 - m), over every parameter."""
    tp, sp = list(teacher.parameters()), list(student.parameters())
    torch._foreach_mul_(tp, m)
    torch._foreach_add_(tp, torch._foreach_mul(sp, 1.0 - m))


def info_nce(q: torch.Tensor, k: torch.Tensor,
             temperature: float) -> torch.Tensor:
    """InfoNCE of the L2-normalized rows, the positives on the diagonal."""
    logits = l2_normalize(q) @ l2_normalize(k).t() / temperature
    return F.cross_entropy(logits, torch.arange(q.shape[0],
                                                device=q.device))


def teacher_extra(config: dict, model: nn.Module) -> dict:
    """MoCo's extras: ``teacher``, a frozen copy of the model."""
    teacher = copy.deepcopy(model)
    teacher.requires_grad_(False)
    return {"teacher": teacher}


def dino_extra(config: dict, model: nn.Module) -> dict:
    """DINO's extras: the teacher and ``center`` (proj_dim,) zeros."""
    dev = next(model.parameters()).device
    return {**teacher_extra(config, model),
            "center": torch.zeros(model.cfg.proj_dim, device=dev)}


def _views(batch: dict) -> tuple:
    x = batch["image"]
    B = x.shape[0] // 2
    return x[:B], x[B:]


def _update(loss, optimizer, scheduler, mesh=None) -> None:
    from concepthash_tpu_torch.train.state import backward

    backward(loss, optimizer, mesh)
    follow_schedule(optimizer, scheduler)
    optimizer.step()
    scheduler.step()


def moco_step(model: nn.Module, config: dict,
              optimizer: torch.optim.Optimizer, scheduler,
              generator: Optional[torch.Generator], steps_per_epoch: int,
              extra: dict, mesh=None):
    """step(batch) -> {loss, momentum}: MoCo v3's update. batch['image'] is
    (2B, H, W, C), the two views stacked. Under a ``mesh`` each view is
    this rank's block of the global batch's view, and the InfoNCE takes
    its negatives from the gathered global views."""
    from concepthash_tpu_torch.train.state import sharded_forward

    crit = dict(config.get("criterion", {}) or {})
    base_m = float(crit.get("momentum", 0.99))
    temperature = float(crit.get("temperature", 0.2))
    total = int(config.get("epochs", 100)) * steps_per_epoch
    teacher = extra["teacher"]

    def step(batch: dict) -> dict:
        m = cosine_momentum(int(scheduler.last_epoch), total, base_m)
        v1, v2 = _views(batch)

        def fwd(net, v):
            return sharded_forward(net, {"image": v}, mesh, train=True,
                                   generator=generator)[0]

        with torch.no_grad():
            t1 = fwd(teacher, v1)["proj"]
            t2 = fwd(teacher, v2)["proj"]
        s1 = fwd(model, v1)["pred"]
        s2 = fwd(model, v2)["pred"]
        loss = 0.5 * (info_nce(s1, t2, temperature)
                      + info_nce(s2, t1, temperature))
        _update(loss, optimizer, scheduler, mesh)
        ema_(teacher, model, m)
        loss = loss.detach()
        return {"loss": loss, "momentum": torch.full_like(loss, m)}

    return step


def dino_step(model: nn.Module, config: dict,
              optimizer: torch.optim.Optimizer, scheduler,
              generator: Optional[torch.Generator], steps_per_epoch: int,
              extra: dict, mesh=None):
    """step(batch) -> {loss}: DINO's update. batch['image'] is (2B, H, W,
    C), the two views stacked. Under a ``mesh`` each view is this rank's
    block, and the loss and the center are the gathered global batch's."""
    from concepthash_tpu_torch.train.state import sharded_forward

    crit = dict(config.get("criterion", {}) or {})
    momentum = float(crit.get("momentum", 0.996))
    center_m = float(crit.get("center_momentum", 0.9))
    tau_s = float(crit.get("tau_s", 0.1))
    tau_t = float(crit.get("tau_t", 0.04))
    teacher, center = extra["teacher"], extra["center"]

    def step(batch: dict) -> dict:
        v1, v2 = _views(batch)

        def fwd(net, v):
            return sharded_forward(net, {"image": v}, mesh, train=True,
                                   generator=generator)[0]["proj"]

        with torch.no_grad():
            t1, t2 = fwd(teacher, v1), fwd(teacher, v2)
            pt1 = torch.softmax((t1 - center) / tau_t, dim=-1)
            pt2 = torch.softmax((t2 - center) / tau_t, dim=-1)
        s1, s2 = fwd(model, v1), fwd(model, v2)
        l12 = -(pt1 * torch.log_softmax(s2 / tau_s, -1)).sum(-1).mean()
        l21 = -(pt2 * torch.log_softmax(s1 / tau_s, -1)).sum(-1).mean()
        loss = 0.5 * (l12 + l21)
        _update(loss, optimizer, scheduler, mesh)
        ema_(teacher, model, momentum)
        with torch.no_grad():
            batch_center = torch.cat([t1, t2]).mean(dim=0)
            center.copy_(center * center_m + batch_center * (1 - center_m))
        return {"loss": loss.detach()}

    return step


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross-entropy with logits against a constant target."""
    return (torch.relu(logits) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def uniform_prior(z: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """The critic's real samples: U(0, 1) of z's shape, from
    ``generator``."""
    return torch.rand(z.shape, generator=generator, device=z.device)


def tbh_extra(config: dict, model: nn.Module) -> dict:
    """TBH's extras: ``disc``, the discriminator seeded from ``seed + 9``,
    and ``disc_opt``, its Adam at ``criterion.disc_lr`` (capturable on the
    card)."""
    m = config["model"]
    zdim = int(m.get("zdim", m["nbit"]))
    dev = next(model.parameters()).device
    disc = Discriminator(zdim, device=dev, generator=torch.Generator()
                         .manual_seed(int(config.get("seed", 42)) + 9))
    crit = dict(config.get("criterion", {}) or {})
    opt = torch.optim.Adam(disc.parameters(),
                           lr=float(crit.get("disc_lr", 1e-4)))
    if dev.type == "cuda":
        make_capturable(opt)
    return {"disc": disc, "disc_opt": opt}


def tbh_step(model: nn.Module, config: dict,
             optimizer: torch.optim.Optimizer, scheduler,
             generator: Optional[torch.Generator], steps_per_epoch: int,
             extra: dict, mesh=None):
    """step(batch) -> {loss, rec, adv, disc}: TBH's actor step, then its
    critic step. Under a ``mesh`` the batch is this rank's block: both
    losses read the gathered global batch, the prior is drawn at its
    shape, the model's gradients are summed over the ranks, and the
    discriminator, which the loss reaches after the gather, takes on
    every rank the gradient every rank computes whole."""
    from concepthash_tpu_torch.train.state import sharded_forward

    crit = dict(config.get("criterion", {}) or {})
    adv_weight = float(crit.get("adv_weight", 1.0))
    disc, disc_opt = extra["disc"], extra["disc_opt"]

    def step(batch: dict) -> dict:
        out, _ = sharded_forward(model, batch, mesh, train=True,
                                 generator=generator)
        rec = ((out["recon"] - out["features"].detach()) ** 2).mean()
        adv = _bce(disc(out["z"]), 1.0)
        loss = rec + adv_weight * adv
        _update(loss, optimizer, scheduler, mesh)

        z = out["z"].detach()
        dloss = _bce(disc(uniform_prior(z, generator)), 1.0) \
            + _bce(disc(z), 0.0)
        disc_opt.zero_grad(set_to_none=True)
        dloss.backward()
        disc_opt.step()
        return {"loss": loss.detach(), "rec": rec.detach(),
                "adv": adv.detach(), "disc": dloss.detach()}

    return step
