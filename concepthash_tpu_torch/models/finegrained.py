"""The fine-grained local + global hashing heads over a trunk's
tokens (the CLIP-adapter tower's patch tokens, or another family's grid;
counterpart of concepthash_tpu/models/finegrained.py):

- ``A2NetCE``: A attention maps gate the tokens into part descriptors;
  [parts; global] -> one tied f32 hash layer (``hash_w``: codes =
  all_x @ hash_w, the reconstruction tanh(codes) @ hash_w^T), and a
  classifier on tanh(codes);
- ``Semicon`` (trained under the ``adsh`` regime): iterative
  suppression-attention maps over a running copy of the tokens, each
  gating the original tokens into a local branch (LayerNorm, one 4-head
  self-attention, token mean, Dense to nbit / 2A, tanh), plus a global
  branch to the rest of the bits; its codes are already tanh-activated
  (``codes_activated``);
- ``SemiconCE``: the same branches with the erasure applied inside the
  loop, and a classifier on the codes.

The classifier is a Dense to nclass, or ``TempCE`` (a temperature-scaled
cosine classifier against an MLP projection of fixed centers, kept as the
``ce_fc.center`` buffer) when the method is given centers.

The suppression mask standardizes the softmax map by the population std
of the whole batch, so a batch's codes depend on every row in it: the
experiment encodes each batch as the reference does. The maps' LayerNorm
(``sem_norm_i``) normalizes over the P patch tokens with a scale and a
bias of length P, the trunk's token count. The heads' attention
(head width D / 4 = 192 at ViT-B) takes the einsum path, as the
reference's ``auto`` does; kernels 1, 5 and 6 run in the trunk.

Parameters are float32 on ``device`` (CUDA unless asked otherwise);
``dtype`` is the compute dtype; codes, logits and the A2-Net features come
back in float32. The heads are sized by the trunk's tokens (their width
and count); a trunk without tokens (alexnet, identity) raises the
reference's ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                               ClipVisionConfig,
                                               MultiHeadAttention,
                                               check_kernel_dtype)
from concepthash_tpu_torch.models.layers import (MLP, dense, layer_norm,
                                                 linear, normal_)
from concepthash_tpu_torch.models.trunk import model_trunk
from concepthash_tpu_torch.ops.numerics import l2_normalize

# flax LayerNorm's default epsilon, which the heads' LayerNorms keep
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class FineGrainedConfig:
    nbit: int = 64
    nclass: int = 200
    num_attns: int = 4
    with_softplus: bool = False
    temp: float = 10.0


class TempCE(nn.Module):
    """temp * cos(x, MLP(center)): a cosine classifier against fixed
    (nclass, cdim) centers projected to nbit by ``tp`` (cdim -> cdim ->
    nbit with ``nonlinear``, else one Dense)."""

    def __init__(self, center, nbit: int, temp: float = 10.0,
                 nonlinear: bool = True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.temp, self.dtype = temp, dtype
        center = torch.as_tensor(center, dtype=torch.float32).cpu().clone()
        self.register_buffer("center", center)
        cdim = center.shape[1]
        dims = (cdim, nbit) if nonlinear else (nbit,)
        self.tp = MLP(cdim, dims, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.tp(self.center.to(self.dtype))
        return self.temp * (l2_normalize(x).float()
                            @ l2_normalize(w).float().t())


def _mask(y: torch.Tensor) -> torch.Tensor:
    """The suppression mask of a (B, P) branch activation: its softmax
    over P, standardized by the batch's mean and population std ** 0.3,
    plus 1, clipped to [0, 2], detached."""
    a = torch.softmax(y, dim=1)
    std = a.std(correction=0) + 1e-6
    a = (a - a.mean()) / std ** 0.3 + 1.0
    return torch.clamp(a, 0.0, 2.0).detach()


class _FineGrained(nn.Module):
    """The trunk and the classifier the three heads share."""

    def __init__(self, vision_cfg: Optional[ClipVisionConfig],
                 cfg: FineGrainedConfig, adapters: Optional[AdapterConfig],
                 fixed_center, backbone_cfg: Optional[dict], dtype, device,
                 generator):
        super().__init__()
        dev = resolve_device(device)
        self.backbone = model_trunk(vision_cfg, adapters, backbone_cfg, dtype,
                                    generator)
        if self.backbone.tokens_size is None:
            raise ValueError("fine-grained heads need a token/feature-map "
                             f"trunk (got family {backbone_cfg})")
        self.vision_cfg = vcfg = self.backbone.vision_cfg
        if vcfg is not None:
            check_kernel_dtype(vcfg, dtype, dev.type)
        self.cfg, self.dtype, self._device = cfg, dtype, dev
        # the tokens' width and count (SEMICON's map LayerNorm is over P)
        self.token_dim = self.backbone.tokens_size
        self.num_patches = self.backbone.num_tokens

    def _classifier(self, fixed_center, generator) -> nn.Module:
        c = self.cfg
        if fixed_center is not None:
            return TempCE(fixed_center, c.nbit, c.temp, dtype=self.dtype,
                          generator=generator)
        return linear(c.nbit, c.nclass, generator=generator)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.ce_fc, TempCE):
            return self.ce_fc(x)
        return dense(self.ce_fc, x, self.dtype).float()

    def tokens(self, images: torch.Tensor, train: bool,
               generator=None) -> torch.Tensor:
        """(B, P, D) tokens of the trunk, in the compute dtype (a VGG16
        trunk draws its dropout from ``generator``)."""
        return self.backbone(images, train=train,
                             generator=generator)["tokens"]


class A2NetCE(_FineGrained):
    """Part-attention hashing: ``forward`` returns codes (B, nbit),
    codes_tanh, logits, all_x ((B, (A+1) D) part and global features) and
    rec_all_x (their reconstruction), in float32; with
    ``output_attentions`` also attn_maps (B, P, A)."""

    def __init__(self, vision_cfg: Optional[ClipVisionConfig],
                 cfg: FineGrainedConfig = FineGrainedConfig(),
                 adapters: Optional[AdapterConfig] = AdapterConfig(), *,
                 fixed_center=None, backbone_cfg: Optional[dict] = None,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(vision_cfg, cfg, adapters, fixed_center,
                         backbone_cfg, dtype, device, generator)
        g, D, A = generator, self.token_dim, cfg.num_attns
        self.attn_conv = linear(D, A, generator=g)
        self.local_conv = linear(D, D, generator=g)
        self.global_conv = linear(D, D, generator=g)
        # the tied hash layer, float32 at every compute dtype
        self.hash_w = nn.Parameter(normal_(torch.empty((A + 1) * D, cfg.nbit),
                                           1.0 / math.sqrt((A + 1) * D), g))
        self.ce_fc = self._classifier(fixed_center, g)
        self.to(self._device)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        dt = self.dtype
        tokens = self.tokens(images, train, generator)         # (B, P, D)
        B = tokens.shape[0]
        attn = dense(self.attn_conv, tokens, dt)               # (B, P, A)
        if self.cfg.with_softplus:
            attn = F.softplus(attn)
        gated = tokens[:, :, None, :] * attn[:, :, :, None]    # (B, P, A, D)
        local = dense(self.local_conv, gated, dt).mean(dim=1)  # (B, A, D)
        glob = dense(self.global_conv, tokens, dt).mean(dim=1, keepdim=True)
        all_x = torch.cat([local, glob], dim=1).reshape(B, -1).float()
        codes = all_x @ self.hash_w
        codes_tanh = torch.tanh(codes)
        out = {"codes": codes, "codes_tanh": codes_tanh,
               "logits": self._logits(codes_tanh), "all_x": all_x,
               "rec_all_x": codes_tanh @ self.hash_w.t()}
        if output_attentions:
            out["attn_maps"] = attn
        return out


class _SemiconBranches(_FineGrained):
    """SEMICON's attention maps (``sem_attn_i``, ``sem_norm_i``) and its
    local and global branches (``icon_ln_*``, ``icon_*``, ``hash_fc_*``)."""

    def __init__(self, vision_cfg, cfg, adapters, fixed_center, backbone_cfg,
                 dtype, device, generator):
        super().__init__(vision_cfg, cfg, adapters, fixed_center,
                         backbone_cfg, dtype, device, generator)
        g, D, A, P = (generator, self.token_dim, cfg.num_attns,
                      self.num_patches)
        local_bits = cfg.nbit // (2 * A)
        self.sem_attn = nn.ModuleList(linear(D, 1, bias=False, generator=g)
                                      for _ in range(A))
        self.sem_norm = nn.ModuleList(nn.LayerNorm(P, eps=LN_EPS)
                                      for _ in range(A))
        self.icon_ln = nn.ModuleList(nn.LayerNorm(D, eps=LN_EPS)
                                     for _ in range(A))
        self.icon = nn.ModuleList(MultiHeadAttention(D, 4, dtype, g)
                                  for _ in range(A))
        self.hash_fc = nn.ModuleList(linear(D, local_bits, generator=g)
                                     for _ in range(A))
        self.icon_ln_global = nn.LayerNorm(D, eps=LN_EPS)
        self.icon_global = MultiHeadAttention(D, 4, dtype, g)
        self.hash_fc_global = linear(D, cfg.nbit - local_bits * A,
                                     generator=g)

    def _map(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """relu(LayerNorm over P (sem_attn_i(x))): (B, P)."""
        y = dense(self.sem_attn[i], x, self.dtype)[..., 0]
        return F.relu(layer_norm(self.sem_norm[i], y, self.dtype))

    def _sub_code(self, ln: nn.LayerNorm, mha: MultiHeadAttention,
                  fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """tanh(fc(token mean of self-attention over LayerNorm(x)))."""
        mixed, _ = mha(layer_norm(ln, x, self.dtype))
        return torch.tanh(dense(fc, mixed.mean(dim=1), self.dtype))

    def _global_code(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._sub_code(self.icon_ln_global, self.icon_global,
                              self.hash_fc_global, tokens)


class Semicon(_SemiconBranches):
    """SEMICON: ``forward`` returns codes (B, nbit), float32 tanh sub-codes
    (A local of nbit / 2A bits, then the global rest); with
    ``output_attentions`` also attn_maps (B, A, P) and suppress (B, A-1,
    P). No classifier: the ``adsh`` regime trains it."""

    codes_activated = True  # the adsh regime must not apply tanh again

    def __init__(self, vision_cfg: Optional[ClipVisionConfig],
                 cfg: FineGrainedConfig = FineGrainedConfig(),
                 adapters: Optional[AdapterConfig] = AdapterConfig(), *,
                 fixed_center=None, backbone_cfg: Optional[dict] = None,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(vision_cfg, cfg, adapters, fixed_center,
                         backbone_cfg, dtype, device, generator)
        self.to(self._device)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        A = self.cfg.num_attns
        tokens = self.tokens(images, train, generator)
        # the maps come from an erased running copy; the branches gate the
        # original tokens with each map
        x, maps, suppressions = tokens, [], []
        for i in range(A):
            y = self._map(i, x)
            maps.append(y)
            if i != A - 1:
                suppress = 2.0 - _mask(y)
                suppressions.append(suppress)
                x = x * suppress[:, :, None]
        subs = [self._sub_code(self.icon_ln[i], self.icon[i],
                               self.hash_fc[i], tokens * y[:, :, None])
                for i, y in enumerate(maps)]
        subs.append(self._global_code(tokens))
        out = {"codes": torch.cat(subs, dim=1).float()}
        if output_attentions:
            out["attn_maps"] = torch.stack(maps, dim=1)
            if suppressions:
                out["suppress"] = torch.stack(suppressions, dim=1)
        return out


class SemiconCE(_SemiconBranches):
    """SEMICON-CE: ``forward`` returns codes (B, nbit) float32 tanh
    sub-codes and logits; with ``output_attentions`` also attn_maps (B, A,
    P)."""

    def __init__(self, vision_cfg: Optional[ClipVisionConfig],
                 cfg: FineGrainedConfig = FineGrainedConfig(),
                 adapters: Optional[AdapterConfig] = AdapterConfig(), *,
                 fixed_center=None, backbone_cfg: Optional[dict] = None,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(vision_cfg, cfg, adapters, fixed_center,
                         backbone_cfg, dtype, device, generator)
        self.ce_fc = self._classifier(fixed_center, generator)
        self.to(self._device)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        A = self.cfg.num_attns
        tokens = self.tokens(images, train, generator)
        B, P = tokens.shape[:2]
        x, subs, maps = tokens, [], []
        suppress = torch.ones(B, P, dtype=self.dtype, device=tokens.device)
        for i in range(A):
            x = x * suppress[:, :, None]
            y = self._map(i, x)
            maps.append(y)
            if i != A - 1:
                suppress = 2.0 - _mask(y)
            subs.append(self._sub_code(self.icon_ln[i], self.icon[i],
                                       self.hash_fc[i], x * y[:, :, None]))
        subs.append(self._global_code(tokens))
        codes = torch.cat(subs, dim=1).float()
        out = {"codes": codes, "logits": self._logits(codes)}
        if output_attentions:
            out["attn_maps"] = torch.stack(maps, dim=1)
        return out


HEADS = {"a2net_ce": A2NetCE, "semicon_ce": SemiconCE, "semicon": Semicon}
