"""Shared model layers: cosine classifier, sign straight-through estimator,
code batch-norm and its decorrelated (whitening) form, flax-style dropout,
small MLP (counterpart of concepthash_tpu/models/layers.py, the paths
ConceptHash and the supervised baselines use).

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
    """``t`` set to ``torch.randn(t.shape, generator=generator) * std``; in
    place where ``t`` is a contiguous float32 CPU tensor (the same draws:
    ``randn`` is ``normal_(0, 1)`` of a fresh tensor)."""
    with torch.no_grad():
        if (t.device.type == "cpu" and t.dtype == torch.float32
                and t.is_contiguous() and (generator is None
                                           or generator.device.type == "cpu")):
            return t.normal_(0.0, 1.0, generator=generator).mul_(std)
        return t.copy_(torch.randn(t.shape, generator=generator) * std)


def empty_linear(in_features: int, out_features: int,
                 bias: bool = True) -> nn.Linear:
    """nn.Linear on the CPU with its values left unset, for callers that set
    every one: torch's default init would draw them from the global
    generator only to be overwritten."""
    return nn.Linear(in_features, out_features, bias=bias,
                     device="meta").to_empty(device="cpu")


def linear(in_features: int, out_features: int, bias: bool = True,
           generator=None, zero: bool = False) -> nn.Linear:
    """nn.Linear with flax Dense's initial scale: lecun-normal weights
    (std 1/sqrt(fan_in)), zero bias; ``zero`` zero-inits the weights."""
    lin = empty_linear(in_features, out_features, bias=bias)
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
    f32 logits. ``x`` keeps its own dtype (the reference normalizes it as
    given); the centroids are cast to the compute dtype.

    ``codebook``: fixed (nclass, nfeat) initial centroids (otherwise drawn
    from N(0, 1)); ``learn_cent`` False keeps them as the ``centroids``
    buffer (the reference's ``constants`` collection) instead of a
    parameter. ``forward(x, sign_centroids=True)`` scores against the
    centroids' signs (orthohash_bcs's second head). ``group``,
    ``single_quan`` and ``input_group``, which no module or config of the
    reference reaches, are not ported (ROADMAP Queue 1 item 1, what
    remains)."""

    def __init__(self, nfeat: int, nclass: int, dtype=torch.float32,
                 generator=None, *, codebook=None, learn_cent: bool = True,
                 group: int = 1, single_quan: bool = False,
                 input_group: int = 1):
        super().__init__()
        if group != 1 or single_quan or input_group != 1:
            raise NotImplementedError(
                "CosSim's group, single_quan and input_group are not ported "
                "yet (ROADMAP Queue 1 item 1, what remains)")
        self.dtype = dtype
        cent = (torch.as_tensor(codebook, dtype=torch.float32).cpu().clone()
                if codebook is not None
                else normal_(torch.empty(nclass, nfeat), 1.0, generator))
        if learn_cent:
            self.centroids = nn.Parameter(cent)
        else:
            self.register_buffer("centroids", cent)

    def forward(self, x: torch.Tensor,
                sign_centroids: bool = False) -> torch.Tensor:
        cent = self.centroids.to(self.dtype)
        if sign_centroids:
            cent = torch.sign(cent)
        xn = l2_normalize(x)
        cn = l2_normalize(cent)
        return xn.float() @ cn.float().t()


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """sign() forward, identity backward (straight-through estimator)."""
    return x + (torch.sign(x) - x).detach()


class CodeBatchNorm(nn.Module):
    """BatchNorm with flax ``nn.BatchNorm``'s semantics (momentum 0.9, eps
    1e-5), not torch's, over (B, C) codes or (B, C, H, W) feature maps: the
    statistics are per channel (dim 1), over every other dim.

    Eval uses the running statistics. Training normalizes with the batch
    mean and the biased batch variance, both in f32 and the variance as
    flax takes it (``max(0, E[x^2] - E[x]^2)``), and updates the running
    statistics in place as ``r = 0.9 r + 0.1 batch_stat`` with that biased
    variance (``F.batch_norm(training=True)`` would store the unbiased one).
    ``track_batches`` adds torch's ``num_batches_tracked`` counter (the
    CNN trunks keep torchvision's buffers), which a train forward
    increments in place."""

    def __init__(self, num_features: int, dtype=torch.float32,
                 track_batches: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        if track_batches:
            self.register_buffer("num_batches_tracked",
                                 torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # statistics in at least float32, as flax's
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not train:
            return F.batch_norm(xf, self.running_mean.to(xf.dtype),
                                self.running_var.to(xf.dtype),
                                self.weight.to(xf.dtype),
                                self.bias.to(xf.dtype), training=False,
                                eps=1e-5).to(self.dtype)
        dims = [d for d in range(x.dim()) if d != 1]
        mean = xf.mean(dim=dims)
        var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
        with torch.no_grad():
            m = 0.9
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            if hasattr(self, "num_batches_tracked"):
                self.num_batches_tracked.add_(1)
        view = (1, -1) + (1,) * (x.dim() - 2)
        y = ((xf - mean.view(view))
             * (torch.rsqrt(var + 1e-5) * self.weight).view(view)
             + self.bias.view(view))
        return y.to(self.dtype)


class DecorrelatedBN(nn.Module):
    """Grouped decorrelated (whitening) batch norm over hash codes, the
    ``add_bn: 'dbn'`` option: ``groups`` contiguous groups of
    ``num_features // groups`` bits, each whitened by Sigma^{-1/2} from 5
    Newton-Schulz iterations (IterNorm) in float32.

    Training whitens with the batch's mean and covariance and updates the
    running ``mean`` (G, d) and ``whiten`` (G, d, d) buffers as
    ``r = 0.9 r + 0.1 batch_value``; eval uses them. There is no
    initialising forward here, so the buffers hold their initial values
    (zeros, identities) until the first training forward, as the reference's
    init pass leaves them."""

    MOMENTUM, ITERS, EPS = 0.9, 5, 1e-5

    def __init__(self, num_features: int, groups: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.groups = groups
        d = num_features // groups
        self.register_buffer("mean", torch.zeros(groups, d))
        self.register_buffer("whiten",
                             torch.eye(d).expand(groups, d, d).clone())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        B, nbit = x.shape
        G = self.groups
        xg = x.float().reshape(B, G, nbit // G)
        if train:
            d = xg.shape[-1]
            eye = torch.eye(d, device=x.device)
            mean = xg.mean(dim=0)                               # (G, d)
            xc = xg - mean[None]
            cov = torch.einsum("bgi,bgj->gij", xc, xc) / B + self.EPS * eye
            tr = cov.diagonal(dim1=1, dim2=2).sum(-1)[:, None, None]
            sigma_n = cov / tr
            p = eye.expand(G, d, d)
            for _ in range(self.ITERS):
                p = 1.5 * p - 0.5 * (p @ p @ p @ sigma_n)
            whiten = p / torch.sqrt(tr)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.whiten.copy_(m * self.whiten + (1 - m) * whiten)
        else:
            whiten = self.whiten
            xc = xg - self.mean[None]
        out = torch.einsum("bgi,gij->bgj", xc, whiten)
        return out.reshape(B, nbit).to(self.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            broadcast_dims: tuple = ()) -> torch.Tensor:
    """flax-style dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The mask has size 1 along
    ``broadcast_dims`` (flax attention drops its weights with one mask for
    every batch element and head) and is drawn from ``generator``, a
    ``torch.Generator`` on x's device: the draws are explicit, and a fixed
    generator state gives the same mask again."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    shape = tuple(1 if i in broadcast_dims else n
                  for i, n in enumerate(x.shape))
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


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
