"""Shared model layers: cosine classifier, sign straight-through estimator,
code batch-norm (eval form), small MLP (counterpart of
concepthash_tpu/models/layers.py, the paths the canonical ConceptHash uses).

Parameters are float32; ``dtype`` is the compute dtype, as in the reference.
Initial values are drawn from a ``torch.Generator`` with the reference's
scales (flax's draws differ; weights carried across by ``weights.from_flax``
reproduce the reference function).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch.ops.numerics import l2_normalize


def normal_(t: torch.Tensor, std: float, generator=None) -> torch.Tensor:
    with torch.no_grad():
        return t.copy_(torch.randn(t.shape, generator=generator) * std)


def linear(in_features: int, out_features: int, bias: bool = True,
           generator=None, zero: bool = False) -> nn.Linear:
    """nn.Linear with flax Dense's initial scale: lecun-normal weights
    (std 1/sqrt(fan_in)), zero bias; ``zero`` zero-inits the weights."""
    lin = nn.Linear(in_features, out_features, bias=bias)
    with torch.no_grad():
        if zero:
            lin.weight.zero_()
        else:
            normal_(lin.weight, 1.0 / math.sqrt(in_features), generator)
        if bias:
            lin.bias.zero_()
    return lin


def dense(mod: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``mod`` applied in the compute dtype (flax Dense(dtype=...))."""
    b = None if mod.bias is None else mod.bias.to(dtype)
    return F.linear(x.to(dtype), mod.weight.to(dtype), b)


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with f32 statistics, output in the compute dtype."""
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight.float(),
                        mod.bias.float(), mod.eps).to(dtype)


class CosSim(nn.Module):
    """Cosine-similarity classifier: normalize(x) @ normalize(centroids)^T,
    f32 logits."""

    def __init__(self, nfeat: int, nclass: int, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.centroids = nn.Parameter(
            normal_(torch.empty(nclass, nfeat), 1.0, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = l2_normalize(x.to(self.dtype))
        cn = l2_normalize(self.centroids.to(self.dtype))
        return xn.float() @ cn.float().t()


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """sign() forward, identity backward (straight-through estimator)."""
    return x + (torch.sign(x) - x).detach()


class CodeBatchNorm(nn.Module):
    """BatchNorm over hash codes, eval form: running statistics, eps 1e-5.
    Training (batch statistics, momentum) comes with the training port."""

    def __init__(self, num_features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(
                "CodeBatchNorm(train=True) needs batch statistics, which "
                "come with the training port")
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=1e-5).to(self.dtype)


class MLP(nn.Module):
    """Dense stack with ReLU between layers, e.g. the text_projection
    center_dim -> 512 -> nbit of the canonical ConceptHash config."""

    def __init__(self, in_features: int, features: tuple,
                 final_bias: bool = True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        dims = (in_features, *features)
        self.layers = nn.ModuleList(
            linear(dims[i], dims[i + 1],
                   bias=final_bias or i < len(features) - 1,
                   generator=generator)
            for i in range(len(features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = dense(lin, x, self.dtype)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
