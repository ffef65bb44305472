"""The baselines' backbone trunk: images -> {'features': (B, D), ...}
(counterpart of concepthash_tpu/models/trunk.py, the clip family).

The clip family is the CLIP vision tower with its adapters; ``features``
is the post-LayerNorm CLS token in float32 (Hugging Face's
``pooler_output``), ``tokens`` the patch grid of the last hidden state,
and the tower's own outputs (``pooled``, the projected CLS, among them)
pass through. The other families of the reference (``vit``, ``resnet``,
``swin``, ``alexnet``, ``vgg16``, ``identity``) are not ported (ROADMAP
Queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                               ClipVisionConfig,
                                               ClipVisionTower)


def _unported_family(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"backbone family {family!r} is not ported yet (ROADMAP Queue 1 "
        "item 4); the port's trunk takes the clip family")


class Trunk(nn.Module):
    """The clip trunk: ``tower`` is a ``ClipVisionTower``."""

    def __init__(self, family: str = "clip",
                 vision_cfg: Optional[ClipVisionConfig] = None,
                 adapters: Optional[AdapterConfig] = None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if family != "clip":
            raise _unported_family(family)
        self.family = family
        self.tower = ClipVisionTower(vision_cfg or ClipVisionConfig(),
                                     adapters, dtype, generator)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False) -> dict:
        enc = self.tower(images, output_attentions=output_attentions,
                         train=train)
        out = dict(enc)
        out["features"] = enc["cls_postnorm"].float()
        out["tokens"] = enc["last_hidden_state"][:, 1:, :]
        return out


def trunk_from_config(backbone_cfg: dict, adapters=None, dtype=torch.float32,
                      generator=None) -> Trunk:
    """The trunk of a backbone group (configs/backbone/*.yaml)."""
    from concepthash_tpu_torch.models.backbone_factory import \
        vision_config_from_backbone_cfg

    family = backbone_cfg.get("family", "clip")
    if family != "clip":
        raise _unported_family(family)
    return Trunk("clip", vision_config_from_backbone_cfg(backbone_cfg),
                 adapters, dtype, generator)


def model_trunk(vision_cfg: Optional[ClipVisionConfig],
                adapters: Optional[AdapterConfig],
                backbone_cfg: Optional[dict], dtype=torch.float32,
                generator=None) -> Trunk:
    """A model's trunk: the backbone group's when it names a family other
    than clip (``trunk_from_config``), else the clip trunk of
    ``vision_cfg``."""
    if backbone_cfg is not None and \
            backbone_cfg.get("family", "clip") != "clip":
        return trunk_from_config(backbone_cfg, adapters, dtype, generator)
    return Trunk("clip", vision_cfg, adapters, dtype, generator)
