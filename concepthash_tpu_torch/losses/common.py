"""Shared loss math: margin cross-entropy on cosine logits (additive and
ArcFace-style), soft-target CE, binary CE on logits, the quantization gap
(counterpart of concepthash_tpu/losses/common.py).

Pure functions over one-hot labels, in f32."""

from __future__ import annotations

import torch

from concepthash_tpu_torch.ops.numerics import l2_normalize


def soft_cross_entropy(logits: torch.Tensor,
                       soft_labels: torch.Tensor) -> torch.Tensor:
    """-sum(p * log_softmax(logits)) averaged over the batch; soft_labels
    rows should sum to 1."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(soft_labels * logp).sum(dim=-1).mean()


def margin_logits(logits: torch.Tensor, onehot: torch.Tensor, margin: float,
                  scale: float) -> torch.Tensor:
    """Cosine margin: scale * (logits - margin * onehot)."""
    return scale * (logits.float() - margin * onehot)


def margin_ce(logits: torch.Tensor, onehot: torch.Tensor, margin: float,
              scale: float) -> torch.Tensor:
    """Margin CE over (B, C) or per-concept (Q, B, C) logits; labels (B, C)
    one-hot (rows normalized for multi-label)."""
    norm = onehot / torch.clamp(onehot.sum(dim=-1, keepdim=True), min=1e-12)
    if logits.dim() == 3:
        ml = margin_logits(logits, onehot[None], margin, scale)
        logp = torch.log_softmax(ml, dim=-1)
        return -(norm[None] * logp).sum(dim=-1).mean()
    return soft_cross_entropy(margin_logits(logits, onehot, margin, scale),
                              norm)


def arc_margin_logits(logits: torch.Tensor, onehot: torch.Tensor,
                      margin: float, scale: float) -> torch.Tensor:
    """ArcFace-style margin on cosine logits:
    scale * cos(arccos(clip(logits)) + margin * onehot)."""
    theta = torch.arccos(torch.clamp(logits.float(), -0.99999, 0.99999))
    return scale * torch.cos(theta + margin * onehot)


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    """Mean over every element of the stable BCE on logits."""
    logits = logits.float()
    return (torch.relu(logits) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def quantization_cosine(codes: torch.Tensor) -> torch.Tensor:
    """1 - cos(codes, sign(codes)), averaged: the quantization gap."""
    codes = codes.float()
    s = torch.sign(codes)
    num = (l2_normalize(codes) * s).sum(dim=-1)
    den = torch.sqrt((s != 0).sum(dim=-1).float() + 1e-12)
    return (1.0 - num / den).mean()
