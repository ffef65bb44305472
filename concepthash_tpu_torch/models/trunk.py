"""The backbone trunk: images -> {'features': (B, D) f32[, 'tokens': ...]}
(counterpart of concepthash_tpu/models/trunk.py). Families:

- ``clip``: the CLIP vision tower with its adapters; ``features`` is the
  post-LayerNorm CLS token (Hugging Face's ``pooler_output``), ``tokens``
  the patch grid of the last hidden state, and the tower's own outputs
  (``pooled``, the projected CLS, among them) pass through;
- ``vit``: the same tower as a generic ViT (exact GELU, a biased patch
  embedding, no pre-LayerNorm, the group's LayerNorm eps, 1e-6 unless it
  says otherwise), with its adapters;
- ``resnet``: ResNet-18/34/50/101 (``models/resnet.py``), the global mean;
- ``swin``: Swin tiny/small/base (``models/swin.py``), LayerNorm + mean;
- ``alexnet``, ``vgg16``: torchvision geometry (``models/convnets.py``),
  fc7;
- ``identity``: the input rows are the features (precomputed vectors,
  ``data.pipeline.array_loader``).

The heads size their layers from the trunk (``features_size``,
``tokens_size``; ``num_tokens``, the token count, for SEMICON's map
LayerNorm): flax's Dense infers its input width, torch's Linear is built
with it. ``identity`` takes its width from the group's ``hidden_size``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                               ClipVisionConfig,
                                               ClipVisionTower)

FAMILIES = ("clip", "vit", "resnet", "swin", "alexnet", "vgg16", "identity")
# the families whose geometry follows the images they are fed
IMAGE_FAMILIES = ("resnet", "swin", "alexnet", "vgg16")


class Trunk(nn.Module):
    """A backbone tower and the sizes its heads are built from:
    ``features_size``, and ``tokens_size`` and ``num_tokens`` (None for a
    trunk without tokens). ``tower`` is a ``ClipVisionTower`` (clip, vit), a
    ``ResNet``, a ``SwinTransformer``, an ``AlexNet`` or a ``VGG16``;
    identity has none."""

    def __init__(self, family: str, tower: Optional[nn.Module],
                 features_size: Optional[int],
                 tokens_size: Optional[int] = None,
                 num_tokens: Optional[int] = None):
        super().__init__()
        if family not in FAMILIES:
            raise ValueError(f"unknown backbone family {family!r}")
        self.family = family
        self.tower = tower
        self.features_size = features_size
        self.tokens_size = tokens_size
        self.num_tokens = num_tokens

    @property
    def vision_cfg(self) -> Optional[ClipVisionConfig]:
        """The tower's ClipVisionConfig (clip, vit), else None."""
        return self.tower.cfg if self.family in ("clip", "vit") else None

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False, generator=None) -> dict:
        """``generator``: the dropout generator (AlexNet and VGG16 draw from
        it in training)."""
        if self.family == "identity":
            return {"features": images.float()}
        if self.family not in ("clip", "vit"):
            return self.tower(images, train=train, generator=generator)
        enc = self.tower(images, output_attentions=output_attentions,
                         train=train)
        out = dict(enc)
        out["features"] = enc["cls_postnorm"].float()
        out["tokens"] = enc["last_hidden_state"][:, 1:, :]
        return out


def clip_trunk(vision_cfg: Optional[ClipVisionConfig],
               adapters: Optional[AdapterConfig] = None,
               dtype=torch.float32, generator=None,
               family: str = "clip") -> Trunk:
    """A clip or vit trunk: the vision tower of ``vision_cfg`` (the
    default ViT-B/32 where None) with its adapters."""
    vcfg = vision_cfg or ClipVisionConfig()
    return Trunk(family, ClipVisionTower(vcfg, adapters, dtype, generator),
                 vcfg.hidden_size, vcfg.hidden_size, vcfg.num_patches)


def trunk_from_config(backbone_cfg: dict, adapters=None, dtype=torch.float32,
                      generator=None,
                      vision_cfg: Optional[ClipVisionConfig] = None) -> Trunk:
    """The trunk of a backbone group (configs/backbone/*.yaml): ``family``
    and its keys (``depth``, ``frozen_bn``, ``variant``, ``image_size``,
    ``window_size``, ``layer_norm_eps``; ``hidden_size`` for identity). A
    vit trunk starts from ``vision_cfg`` where given (the group's geometry
    with a caller's kernel settings), else from the group."""
    from concepthash_tpu_torch.models.backbone_factory import \
        vision_config_from_backbone_cfg

    family = backbone_cfg.get("family", "clip")
    image_size = int(backbone_cfg.get("image_size", 224))
    g = generator
    if family == "resnet":
        from concepthash_tpu_torch.models.resnet import ResNet, ResNetConfig

        cfg = ResNetConfig(int(backbone_cfg.get("depth", 50)),
                           frozen_bn=bool(backbone_cfg.get("frozen_bn",
                                                           False)))
        return Trunk(family, ResNet(cfg, dtype, g), cfg.features_size,
                     cfg.features_size, ResNet.grid(image_size) ** 2)
    if family == "swin":
        from concepthash_tpu_torch.models.swin import (SwinConfig,
                                                       SwinTransformer)

        cfg = SwinConfig(variant=backbone_cfg.get("variant", "base"),
                         image_size=image_size,
                         window_size=int(backbone_cfg.get("window_size", 7)))
        return Trunk(family, SwinTransformer(cfg, dtype, g),
                     cfg.features_size, cfg.features_size,
                     cfg.grids()[-1] ** 2)
    if family == "alexnet":
        from concepthash_tpu_torch.models.convnets import AlexNet

        return Trunk(family, AlexNet(dtype, g), AlexNet.features_size)
    if family == "vgg16":
        from concepthash_tpu_torch.models.convnets import VGG16

        # tokens: the last pooled grid, 512 channels at 1/32 the side
        return Trunk(family, VGG16(dtype, g), VGG16.features_size, 512,
                     (image_size // 32) ** 2)
    if family == "identity":
        width = backbone_cfg.get("hidden_size")
        return Trunk(family, None, int(width) if width else None)
    if family not in ("clip", "vit"):
        raise ValueError(f"unknown backbone family {family!r}")
    vcfg = vision_config_from_backbone_cfg(backbone_cfg)
    if family == "vit":
        # timm ViTs use eps 1e-6, Hugging Face ViTModel checkpoints 1e-12
        vcfg = dataclasses.replace(
            vision_cfg or vcfg, hidden_act="gelu", patch_bias=True,
            use_pre_layernorm=False,
            layer_norm_eps=float(backbone_cfg.get("layer_norm_eps", 1e-6)))
    return clip_trunk(vcfg, adapters, dtype, generator, family)


def model_trunk(vision_cfg: Optional[ClipVisionConfig],
                adapters: Optional[AdapterConfig],
                backbone_cfg: Optional[dict], dtype=torch.float32,
                generator=None) -> Trunk:
    """A model's trunk: the backbone group's when it names a family other
    than clip (``trunk_from_config``; a vit tower takes ``vision_cfg``'s
    kernel settings), else the clip trunk of ``vision_cfg``."""
    if backbone_cfg is not None and \
            backbone_cfg.get("family", "clip") != "clip":
        return trunk_from_config(backbone_cfg, adapters, dtype, generator,
                                 vision_cfg)
    return clip_trunk(vision_cfg, adapters, dtype, generator)


def trunk_features_size(trunk: Trunk) -> int:
    """The trunk's feature width, for a head's first layer; identity's
    comes from the group's ``hidden_size``."""
    if trunk.features_size is None:
        raise ValueError("the identity backbone needs backbone.hidden_size, "
                         "the width of its precomputed feature vectors")
    return trunk.features_size
