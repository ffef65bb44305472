"""The supervised baselines' objectives (counterpart of
concepthash_tpu/losses/baselines.py, the ``sgd``-regime losses).

Each loss is ``fn(outputs, onehot, **cfg) -> (total, parts)`` over the
model's output dict (codes and the head's logits), in f32. DTSH's triplets
are vectorized with masks, as the reference does. The unsupervised,
asymmetric and fine-grained objectives (``unsup_greedyhash_loss``,
``adsh_loss``, ``soften_sim``, ``solve_dcc``, ``a2net_ce_loss``,
``semicon_ce_loss``) wait for their regimes (ROADMAP Queue 1 items 6-7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from concepthash_tpu_torch.losses.common import (
    arc_margin_logits, binary_cross_entropy_with_logits, margin_logits,
    quantization_cosine, soft_cross_entropy)
from concepthash_tpu_torch.ops.hamming import get_hamm_dist
from concepthash_tpu_torch.ops.retrieval import get_sim, log_trick


def _row_normalized(onehot: torch.Tensor) -> torch.Tensor:
    return onehot / torch.clamp(onehot.sum(-1, keepdim=True), min=1e-12)


def _margin(logits, onehot, m, s, m_type):
    return (margin_logits(logits, onehot, m, s) if m_type == "cos"
            else arc_margin_logits(logits, onehot, m, s))


def hamming_accuracy(codes, codebook, onehot) -> torch.Tensor:
    """The share of codes whose nearest codebook row in Hamming distance
    is their class (ties to the lowest class), detached."""
    with torch.no_grad():
        dist = get_hamm_dist(codes.detach(), codebook)
        return (dist.argmin(-1) == onehot.argmax(-1)).float().mean()


def orthohash_loss(outputs, onehot, ce: float = 1.0, s: float = 8.0,
                   m: float = 0.2, m_type: str = "cos", quan: float = 0.0,
                   quan_type: str = "cs", multiclass: bool = False,
                   multiclass_loss: str = "label_smoothing", codebook=None,
                   bcs_scale: float = 0.0, **_):
    """Margin CE on the cosine logits (``m_type`` 'cos' or 'arc'), with an
    optional quantization term; ``bcs_scale`` blends the sign-centroid
    logits (orthohash_bcs's ``logits2``) into the CE."""
    logits, codes = outputs["logits"], outputs["codes"]
    if bcs_scale and "logits2" in outputs:
        logits = (logits + bcs_scale * outputs["logits2"]) / (1.0 + bcs_scale)
    ml = _margin(logits, onehot, m, s, m_type)
    if not multiclass:
        loss_ce = soft_cross_entropy(ml, onehot)
    elif multiclass_loss == "bce":
        loss_ce = binary_cross_entropy_with_logits(ml, onehot)
    else:   # label_smoothing[_unscaled]
        y = onehot if "unscaled" in multiclass_loss else \
            _row_normalized(onehot)
        loss_ce = -(y * torch.log_softmax(ml, -1)).sum(-1).mean()
    if quan:
        sg = torch.sign(codes).detach()
        if quan_type == "cs":
            q = quantization_cosine(codes)
        elif quan_type == "l1":
            q = (codes - sg).abs().mean()
        else:
            q = ((codes - sg) ** 2).mean()
    else:
        q = torch.zeros((), device=codes.device)
    parts = {"ce": loss_ce, "quan": q}
    if codebook is not None:
        parts["hacc"] = hamming_accuracy(codes, codebook, onehot)
    return ce * loss_ce + quan * q, parts


def csq_loss(outputs, onehot, codebook, lambda_q: float = 1e-4,
             multiclass: bool = False, **_):
    """BCE of tanh(codes) towards the class's hash center, plus the
    quantization term. A multi-label row's center is the sign of its
    classes' sum, a zero sum going to +1 (the reference's deterministic
    tie rule)."""
    codes = torch.tanh(outputs["codes"])
    if multiclass:
        center = torch.where(onehot @ codebook < 0, -1.0, 1.0)
    else:
        center = codebook[onehot.argmax(-1)]
    p = 0.5 * (codes + 1)
    t = 0.5 * (center + 1)
    eps = 1e-7
    loss_c = -(t * torch.log(torch.clamp(p, eps, 1.0))
               + (1 - t) * torch.log(torch.clamp(1 - p, eps, 1.0))).mean()
    loss_q = ((codes.abs() - 1.0) ** 2).mean()
    parts = {"center": loss_c, "quant": loss_q,
             "hacc": hamming_accuracy(codes, codebook, onehot)}
    return loss_c + lambda_q * loss_q, parts


def dpn_loss(outputs, onehot, codebook, sl: float = 1.0, margin: float = 1.0,
             reg: float = 0.1, multiclass: bool = False, **_):
    """Hinge of the codes against their class's hash center, plus an L2
    regulariser."""
    codes = outputs["codes"]
    if multiclass:
        hinge = F.relu(margin - codes[:, None, :] * codebook[None])
        loss_sl = (hinge.sum(-1) * onehot).sum(-1).mean()
    else:
        center = codebook[onehot.argmax(-1)]
        loss_sl = F.relu(margin - codes * center).sum(-1).mean()
    loss_reg = (codes ** 2).mean()
    parts = {"sl": loss_sl, "reg": loss_reg,
             "hacc": hamming_accuracy(codes, codebook, onehot)}
    return sl * loss_sl + reg * loss_reg, parts


def pairwise_exp_loss(u, y, U, Y, alpha: float) -> torch.Tensor:
    """HashNet's weighted pairwise likelihood of ``u`` against ``U`` (the
    batch itself, or the train-set bank), positives and negatives
    re-weighted to equal mass."""
    sim = get_sim(y, Y).float()
    dot = alpha * (u @ U.t())
    exp_loss = log_trick(dot) - sim * dot
    s1 = torch.clamp(sim.sum(), min=1.0)
    s0 = torch.clamp((1 - sim).sum(), min=1.0)
    s = s1 + s0
    w = torch.where(sim > 0, s / s1, s / s0)
    return (exp_loss * w).sum() / s


def hashnet_loss(outputs, onehot, beta: float = 1.0, alpha: float = 1.0,
                 **_):
    """The in-batch pairwise loss on tanh(beta * codes): the eval-side
    criterion. Training takes ``train.custom_steps.hashnet_step`` (the beta
    continuation and the opt-in train-set bank)."""
    u = torch.tanh(beta * outputs["codes"])
    loss = pairwise_exp_loss(u, onehot, u, onehot, alpha)
    return loss, {"pairwise": loss}


def dpsh_loss(outputs, onehot, alpha: float = 1.0,
              imbalance_scheme: str = "hashnet", **_):
    u = outputs["codes"]
    sim = get_sim(onehot, onehot).float()
    dot = (u @ u.t()) / 2.0
    likelihood = log_trick(dot) - sim * dot
    if imbalance_scheme == "hashnet":
        s1 = torch.clamp(sim.sum(), min=1.0)
        s0 = torch.clamp((1 - sim).sum(), min=1.0)
        s = s1 + s0
        w = torch.where(sim > 0, s / s1, s / s0)
        likelihood = (likelihood * w).sum() / s
    else:
        likelihood = likelihood.mean()
    quan = ((u - torch.sign(u)) ** 2).mean()
    return likelihood + alpha * quan, {"likelihood": likelihood,
                                       "quan": quan}


def dtsh_loss(outputs, onehot, alpha: float = 5.0, lmbd: float = 1.0, **_):
    """Triplet likelihood over every (anchor, positive, negative) of the
    batch, averaged per anchor and over the anchors that have both a
    positive and a negative (0 when none has)."""
    u = outputs["codes"]
    ip = u @ u.t()
    pos = get_sim(onehot, onehot)
    mask = (pos[:, :, None] & ~pos[:, None, :]).float()
    triple = torch.clamp(ip[:, :, None] - ip[:, None, :] - alpha, -100.0,
                         50.0)
    term = -(triple - torch.log1p(torch.exp(triple)))
    cnt = mask.sum(dim=(1, 2))
    per_row = torch.where(cnt > 0, (term * mask).sum(dim=(1, 2))
                          / torch.clamp(cnt, min=1.0), 0.0)
    used = (cnt > 0).sum()
    loss1 = torch.where(used > 0, per_row.sum() / torch.clamp(used, min=1),
                        0.0)
    loss2 = ((u - torch.sign(u)) ** 2).mean()
    return loss1 + lmbd * loss2, {"likelihood": loss1, "quan": loss2}


def greedyhash_loss(outputs, onehot, alpha: float = 1.0, pow: float = 3.0,
                    multiclass: bool = False, **_):
    logits, code_logits = outputs["logits"], outputs["codes"]
    if multiclass:
        loss1 = binary_cross_entropy_with_logits(logits, onehot)
    else:
        loss1 = soft_cross_entropy(logits, _row_normalized(onehot))
    loss2 = ((code_logits.abs() - 1.0).abs() ** pow).mean()
    return loss1 + alpha * loss2, {"ce": loss1, "quan": loss2}


def ce_loss(outputs, onehot, multiclass: bool = False, margin: float = 0.0,
            scale: float = 1.0, m_type: str = "ce", **_):
    """Cross-entropy on the logits (``m_type`` 'ce'; BCE when multiclass),
    or margin CE on cosine logits ('cos', 'arc')."""
    logits = outputs["logits"]
    if m_type == "ce":
        if multiclass:
            loss = binary_cross_entropy_with_logits(logits, onehot)
        else:
            loss = soft_cross_entropy(logits, _row_normalized(onehot))
    else:
        loss = soft_cross_entropy(_margin(logits, onehot, margin, scale,
                                          m_type), onehot)
    return loss, {"ce": loss}
