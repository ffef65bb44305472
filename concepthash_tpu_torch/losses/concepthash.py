"""ConceptHash (LGH) training objective, a pure function (counterpart of
concepthash_tpu/losses/concepthash.py).

A weighted sum gated by ``loss_scales``: margin CE on the continuous-center
logits, on the binary-center logits, per-concept CE, optionally the blended
cont/bin softmax ("hash_logits") and the attention diversity. The
quantization gap is reported but carries no gradient. The canonical config
switches on bin, cont and concept at 1, margin 0.2, scale 8.
"""

from __future__ import annotations

import torch

from concepthash_tpu_torch.losses.common import (margin_ce, margin_logits,
                                                 quantization_cosine)
from concepthash_tpu_torch.ops.numerics import l2_normalize

DEFAULT_SCALES = {
    "logits": 0.0,
    "hash_logits": 0.0,
    "bin_logits": 1.0,
    "cont_logits": 1.0,
    "concept_logits": 1.0,
    "attn_div_loss": 0.0,
    "filip_logits": 0.0,
}


def _normed(onehot: torch.Tensor) -> torch.Tensor:
    return onehot / torch.clamp(onehot.sum(dim=-1, keepdim=True), min=1e-12)


def lgh_loss(outputs: dict, onehot: torch.Tensor, margin: float = 0.2,
             scale: float = 8.0, loss_scales: dict | None = None,
             lmbd: float = 0.5, avg_before_softmax: bool = False,
             div_method: int = 1, div_min: float = 0.0, ncontext: int = 4,
             nregs: int = 0, avg_attn: bool = False,
             concept_cossim: bool = True, exponential_scale: float = 0.0,
             **_ignored):
    """Returns (total, parts): the weighted loss and each switched-on term,
    plus ``quan`` (detached)."""
    scales = dict(DEFAULT_SCALES)
    scales.update(loss_scales or {})
    parts = {}
    total = 0.0

    parts["quan"] = quantization_cosine(outputs["codes"]).detach()

    def on(key):
        return scales.get(key, 0.0) != 0.0

    if on("logits"):
        parts["aux"] = margin_ce(outputs["logits"], onehot, margin, scale)
        total = total + scales["logits"] * parts["aux"]

    if on("concept_logits"):
        lc = outputs["logits_concept"].float()               # (Q, B, C)
        if concept_cossim:
            lc = margin_logits(lc, onehot[None], margin, scale)
        logp = torch.log_softmax(lc, dim=-1)
        per_concept = -(_normed(onehot)[None] * logp).sum(-1).mean(-1)  # (Q,)
        if exponential_scale > 0:
            # later concepts weighted higher
            w = torch.exp(-torch.arange(ncontext - 1, -1, -1,
                                        device=lc.device) / exponential_scale)
            parts["concept"] = (w * per_concept).sum()
        else:
            parts["concept"] = per_concept.mean()
        total = total + scales["concept_logits"] * parts["concept"]

    if on("filip_logits"):
        f = 0.5 * (margin_ce(outputs["logits_filip_i2t"], onehot, margin, scale)
                   + margin_ce(outputs["logits_filip_t2i"], onehot, margin,
                               scale))
        parts["filip"] = f
        total = total + scales["filip_logits"] * f

    if on("hash_logits"):
        parts["hash"] = _blended_hash_loss(outputs["logits_cont"],
                                           outputs["logits_bin"], onehot,
                                           margin, scale, lmbd,
                                           avg_before_softmax)
        total = total + scales["hash_logits"] * parts["hash"]

    if on("cont_logits"):
        parts["cont"] = margin_ce(outputs["logits_cont"], onehot, margin, scale)
        total = total + scales["cont_logits"] * parts["cont"]

    if on("bin_logits"):
        parts["bin"] = margin_ce(outputs["logits_bin"], onehot, margin, scale)
        total = total + scales["bin_logits"] * parts["bin"]

    if on("attn_div_loss") and "attn_cache" in outputs:
        # eval forwards skip the attention maps (opt-in only)
        parts["attn_div"] = attention_diversity(
            outputs["attn_cache"], ncontext, nregs, div_method, div_min,
            avg_attn)
        total = total + scales["attn_div_loss"] * parts["attn_div"]

    return total, parts


def _blended_hash_loss(logits_1, logits_2, onehot, margin, scale, lmbd,
                       avg_before_softmax):
    """lmbd-blend of the cont and bin class probabilities before the log."""
    if avg_before_softmax:
        return margin_ce(lmbd * logits_1 + (1 - lmbd) * logits_2, onehot,
                         margin, scale)
    ml1 = margin_logits(logits_1, onehot, margin, scale)
    ml2 = margin_logits(logits_2, onehot, margin, scale)
    prob = (lmbd * torch.softmax(ml1, -1)
            + (1 - lmbd) * torch.softmax(ml2, -1))
    logp = torch.log(torch.clamp(prob, min=1e-7))
    return -(_normed(onehot) * logp).sum(-1).mean()


def attention_diversity(attn_cache, ncontext: int, nregs: int = 0,
                        div_method: int = 1, div_min: float = 0.0,
                        avg_attn: bool = False) -> torch.Tensor:
    """Mean upper-triangular cosine among the concept tokens'
    patch-attention maps. attn_cache: tuple of (B, H, L, L) per layer; uses
    the last (or the mean over layers)."""
    attn = (torch.stack(tuple(attn_cache)).mean(0) if avg_attn
            else attn_cache[-1])
    if nregs:
        maps = attn[:, :, -(ncontext + nregs):-nregs, 1:-(ncontext + nregs)]
    else:
        maps = attn[:, :, -ncontext:, 1:-ncontext]
    maps = l2_normalize(maps.mean(dim=1))                # (B, Q, P)
    cos = torch.einsum("bqp,bkp->bqk", maps, maps)
    if div_method == 0:
        cos = torch.relu(cos - div_min)
    cos = cos.mean(dim=0)                                # (Q, Q)
    q = cos.shape[0]
    triu = torch.triu(torch.ones(q, q, dtype=torch.bool, device=cos.device),
                      diagonal=1)
    return (cos * triu).sum() / max(int(triu.sum()), 1)
