"""Numerically safe primitives shared by models and losses
(counterpart of concepthash_tpu/ops/numerics.py)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x / ||x||`` with a NaN-free gradient at ``x == 0``: eps sits inside
    the rsqrt, so the backward never differentiates a norm at zero (the
    projected class centers are exactly zero at step 0 when the codebook is
    zero)."""
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)
