"""The supervised baselines over a backbone trunk (counterpart of
concepthash_tpu/models/baselines.py).

Every baseline has one shape: the trunk's feature (the post-LayerNorm CLS
token of the adapter-tuned CLIP tower, or another family's feature,
``models/trunk.py``) -> a linear hash layer -> the method's head. Heads:

- ``orthohash``: the code BatchNorm (``hash_bn``) and a cosine classifier
  against the fixed signed codebook (``ce_fc.centroids``, a buffer), with
  ``bcs`` a second one against the centroids' signs (``logits2``);
- ``csq``, ``dpn`` and ``pairwise`` (hashnet, dpsh, dtsh): codes only; the
  pairwise hash layer keeps torch's default init, U(+-1/sqrt(fan_in)) for
  the kernel and the bias, which the reference matched on purpose;
- ``ce``: a linear classifier, or a cosine one (``ce_cossim``);
- ``greedyhash``: a linear classifier on the sign of the codes
  (straight-through);
- ``descriptor``: the feature itself as the code;
- ``clip``: the projected CLS feature against the fixed class-text
  centers, scaled by ``exp(logit_scale)`` (initialised to log(1/0.07));
- ``nsh``: a projector MLP (``latent_fc1`` to 2 * latent_dim, ReLU,
  ``latent_fc2``) to the continuous latents, then a hash layer without
  bias on them; it returns the feature, the latents and the codes;
- ``unsup_greedyhash``: a biased hash layer, with the feature and the
  codes' straight-through sign (``codes_bin``) beside the codes.

Parameters are float32 on ``device`` (CUDA unless asked otherwise);
``dtype`` is the compute dtype; codes, latents and logits come back in
float32 (features in the compute dtype).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                               ClipVisionConfig,
                                               check_kernel_dtype)
from concepthash_tpu_torch.models.layers import (CodeBatchNorm, CosSim,
                                                 dense, empty_linear, linear,
                                                 sign_ste)
from concepthash_tpu_torch.models.trunk import (model_trunk,
                                                trunk_features_size)
from concepthash_tpu_torch.ops.numerics import l2_normalize

HEADS = ("orthohash", "csq", "dpn", "pairwise", "ce", "greedyhash",
         "unsup_greedyhash", "nsh", "descriptor", "clip")


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    nbit: int = 64
    nclass: int = 200
    head: str = "orthohash"
    add_bn: bool = True       # the code BatchNorm (orthohash)
    hash_bias: bool = False   # a biased hash layer (always for pairwise,
                              # ce and greedyhash)
    ce_cossim: bool = False   # ce head: cosine classifier, not linear
    latent_dim: int = 128     # nsh head: the continuous latents' width
    bcs: bool = False         # orthohash: the sign-centroid logits head


def _torch_default_linear(fan_in: int, fan_out: int, generator) -> nn.Linear:
    """nn.Linear with torch's default init drawn from ``generator``:
    U(+-1/sqrt(fan_in)) for the weight and the bias."""
    lin = empty_linear(fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        for t in (lin.weight, lin.bias):
            t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1)
                    * bound)
    return lin


class BaselineHashNet(nn.Module):
    """A baseline over NHWC images (normalized float); ``forward`` returns
    ``codes`` (B, nbit) f32 and the head's outputs (``logits``,
    ``logits2``, ``codes_bin``). ``codebook``: the fixed (nclass, nbit)
    signed codebook of orthohash, or the (nclass, proj) class-text centers
    of clip. ``backbone_cfg``: the backbone group, whose ``family`` picks
    the trunk (``models/trunk.py``); the hash layer is sized by the
    trunk's feature width."""

    def __init__(self, vision_cfg: Optional[ClipVisionConfig],
                 cfg: BaselineConfig = BaselineConfig(),
                 adapters: Optional[AdapterConfig] = AdapterConfig(), *,
                 codebook=None, backbone_cfg: Optional[dict] = None,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.head not in HEADS:
            raise ValueError(f"unknown head {cfg.head!r}")
        g = generator
        self.backbone = model_trunk(vision_cfg, adapters, backbone_cfg, dtype,
                                    g)
        self.vision_cfg = vcfg = self.backbone.vision_cfg
        if vcfg is not None:
            check_kernel_dtype(vcfg, dtype, dev.type)
        self.cfg, self.dtype = cfg, dtype
        head = cfg.head
        cb = (torch.as_tensor(codebook, dtype=torch.float32)
              if codebook is not None else None)
        if head == "clip":
            self.logit_scale = nn.Parameter(
                torch.tensor(math.log(1 / 0.07), dtype=torch.float32))
            # the class-text centers: a constant of the config, outside the
            # state dict, as the reference keeps them outside its variables
            self.register_buffer("text_centers", cb.clone(),
                                 persistent=False)
        elif head == "nsh":
            D, Z = trunk_features_size(self.backbone), cfg.latent_dim
            self.latent_fc1 = linear(D, 2 * Z, generator=g)
            self.latent_fc2 = linear(2 * Z, Z, generator=g)
            self.hash_fc = linear(Z, cfg.nbit, bias=False, generator=g)
        elif head != "descriptor":
            D = trunk_features_size(self.backbone)
            bias = cfg.hash_bias or head in ("pairwise", "ce", "greedyhash",
                                             "unsup_greedyhash")
            self.hash_fc = (_torch_default_linear(D, cfg.nbit, g)
                            if head == "pairwise"
                            else linear(D, cfg.nbit, bias=bias, generator=g))
            self.hash_bn = (CodeBatchNorm(cfg.nbit, dtype)
                            if cfg.add_bn and head == "orthohash" else None)
            if head == "orthohash":
                self.ce_fc = CosSim(cfg.nbit, cfg.nclass, dtype, g,
                                    codebook=cb, learn_cent=cb is None)
            elif head == "ce" and cfg.ce_cossim:
                self.ce_fc = CosSim(cfg.nbit, cfg.nclass, dtype, g)
            elif head in ("ce", "greedyhash"):
                self.ce_fc = linear(cfg.nbit, cfg.nclass, generator=g)
        self.to(dev)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        """``train=True``: batch statistics in orthohash's code BatchNorm
        (and a ResNet trunk's), whose running statistics it updates; an
        AlexNet or VGG16 trunk draws its dropout from ``generator``."""
        return self.head(self.backbone(images, train=train,
                                       output_attentions=output_attentions,
                                       generator=generator),
                         train)

    def head(self, enc: dict, train: bool = False) -> dict:
        """The head over the trunk's outputs ``enc``."""
        c, dt = self.cfg, self.dtype
        feat = enc["features"]
        if c.head == "descriptor":
            return {"codes": feat}
        if c.head == "clip":
            pooled = enc["pooled"].float()
            logits = torch.exp(self.logit_scale) * (
                l2_normalize(pooled) @ l2_normalize(self.text_centers).t())
            return {"codes": pooled, "logits": logits}
        if c.head == "nsh":
            z = torch.relu(dense(self.latent_fc1, feat, dt))
            z = dense(self.latent_fc2, z, dt).float()
            return {"features": feat, "latents": z,
                    "codes": dense(self.hash_fc, z, dt).float()}
        codes = dense(self.hash_fc, feat, dt)
        if self.hash_bn is not None:
            codes = self.hash_bn(codes, train)
        codes = codes.float()
        out = {"codes": codes}
        if c.head == "orthohash":
            out["logits"] = self.ce_fc(codes)
            if c.bcs:
                out["logits2"] = self.ce_fc(codes, sign_centroids=True)
        elif c.head == "ce":
            out["logits"] = (self.ce_fc(codes) if c.ce_cossim
                             else dense(self.ce_fc, codes, dt).float())
        elif c.head == "greedyhash":
            b = sign_ste(codes)
            out["codes_bin"] = b
            out["logits"] = dense(self.ce_fc, b, dt).float()
        elif c.head == "unsup_greedyhash":
            out["features"] = feat
            out["codes_bin"] = sign_ste(codes)
        return out
