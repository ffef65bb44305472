"""The supervised baselines' objectives (counterpart of
concepthash_tpu/losses/baselines.py): the ``sgd``-regime losses, the
fine-grained ones (``a2net_ce_loss``, ``semicon_ce_loss``) and the ``adsh``
regime's asymmetric objective with its similarity rebalance and its
database-code update (``adsh_loss``, ``soften_sim``, ``solve_dcc``).

Each loss is ``fn(outputs, onehot, **cfg) -> (total, parts)`` over the
model's output dict (codes and the head's logits), in f32. DTSH's triplets
are vectorized with masks, as the reference does. ``unsup_greedyhash_loss``
is the unsupervised GreedyHash objective, which Bi-half shares
(``losses/unsupervised.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from concepthash_tpu_torch.losses.common import (
    arc_margin_logits, binary_cross_entropy_with_logits, margin_logits,
    quantization_cosine, soft_cross_entropy)
from concepthash_tpu_torch.losses.unsupervised import structure_matching
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


def unsup_greedyhash_loss(outputs, onehot, alpha: float = 1.0,
                          pow: float = 3.0, **_):
    """Unsupervised: the cosine structure between the batch halves'
    binary codes matched to their features'."""
    return structure_matching(outputs["features"], outputs["codes"],
                              outputs["codes_bin"], alpha, pow)


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


# ---------------------------------------------------------------------------
# the adsh regime: ADSH's and SEMICON's asymmetric objective
# ---------------------------------------------------------------------------

def adsh_loss(outputs, batch_codes_targets, gamma: float = 200.0,
              nbit: int = 64, apply_tanh: bool = True, **_):
    """(nbit S - u V^T)^2 + gamma ||u - V_omega||^2 against the stored
    database codes V, both sums over (B * N) and scaled by 12 / nbit, as
    the reference's executable criterion is. ``batch_codes_targets`` holds
    S (B, N) soft similarity, V (N, nbit) and V_omega (B, nbit), the stored
    codes of the batch's rows. ``apply_tanh=False`` for codes already
    tanh-activated (SEMICON's)."""
    u = torch.tanh(outputs["codes"]) if apply_tanh else outputs["codes"]
    S = batch_codes_targets["S"]
    V = batch_codes_targets["V"]
    V_omega = batch_codes_targets["V_omega"]
    denom = u.shape[0] * V.shape[0]
    hash_loss = ((nbit * S - u @ V.t()) ** 2).sum() / denom / nbit * 12
    quan = ((u - V_omega) ** 2).sum() / denom * gamma / nbit * 12
    return hash_loss + quan, {"hash": hash_loss, "quan": quan}


def soften_sim(S):
    """The soft-similarity rebalance of the hard {-1, +1} pair matrix:
    ``r = S.sum() / (1 - S).sum(); S * (1 + r) - r``. Positives stay +1,
    negatives move to -(1 + 2r). An all-positive S (no negative mass)
    keeps its values: the denominator is guarded, and any finite r is the
    identity on +1. NumPy arrays or tensors; returns the same kind."""
    neg_mass = (1.0 - S).sum()
    r = S.sum() / (neg_mass + (neg_mass == 0))
    return S * (1.0 + r) - r


def solve_dcc(V: torch.Tensor, U: torch.Tensor, S: torch.Tensor, omega,
              gamma: float, nbit: int) -> torch.Tensor:
    """Discrete cyclic coordinate descent over the bits: the database codes
    V (N, nbit) given the subset's continuous codes U (M, nbit) at rows
    ``omega`` and their soft similarity S (M, N), one bit after another;
    a zero argument keeps the old bit. Returns a new V on V's device."""
    omega = torch.as_tensor(omega, device=V.device, dtype=torch.long)
    expand_U = torch.zeros_like(V)
    expand_U[omega] = U
    Q = (nbit * S).t() @ U + gamma * expand_U          # (N, nbit)
    V = V.clone()
    for bit in range(nbit):
        V_ = torch.cat([V[:, :bit], V[:, bit + 1:]], dim=1)
        U_ = torch.cat([U[:, :bit], U[:, bit + 1:]], dim=1)
        v_new = torch.sign(Q[:, bit] - V_ @ (U_.t() @ U[:, bit]))
        V[:, bit] = torch.where(v_new == 0, V[:, bit], v_new)
    return V


# ---------------------------------------------------------------------------
# the fine-grained heads
# ---------------------------------------------------------------------------

def a2net_ce_loss(outputs, onehot, gamma: float = 1.0, hash: float = 1.0,
                  decorr: float = 0.1, **_):
    """A2-Net-CE: CE on the logits, a decorrelation term on the tanh
    codes' Gram matrix, and the reconstruction of the (detached) part
    features through the tied hash layer plus the codes' tanh gap."""
    codes, codes_tanh = outputs["codes"], outputs["codes_tanh"]
    hash_loss = soft_cross_entropy(outputs["logits"], _row_normalized(onehot))
    corr = codes_tanh.t() @ codes_tanh
    n, nbit = codes_tanh.shape
    decorr_loss = ((corr - torch.eye(nbit, device=corr.device) * n) ** 2) \
        .mean()
    rec_loss = (((outputs["rec_all_x"] - outputs["all_x"].detach()) ** 2)
                .mean() + gamma * ((codes - codes_tanh) ** 2).mean())
    total = hash * hash_loss + decorr * decorr_loss + rec_loss
    return total, {"hash": hash_loss, "decorr": decorr_loss, "rec": rec_loss}


def semicon_ce_loss(outputs, onehot, gamma: float = 0.1,
                    loss_method: str = "ce", **_):
    """SEMICON-CE: CE on the logits (``loss_method`` 'ce', else margin CE
    at m 0.2, s 8) plus gamma times the codes' squared gap to their
    signs."""
    codes, logits = outputs["codes"], outputs["logits"]
    norm = _row_normalized(onehot)
    if loss_method == "ce":
        hash_loss = soft_cross_entropy(logits, norm)
    else:
        hash_loss = soft_cross_entropy(margin_logits(logits, onehot, 0.2,
                                                     8.0), norm)
    quan = ((codes - torch.sign(codes)) ** 2).mean()
    return hash_loss + gamma * quan, {"hash": hash_loss, "quan": quan}
