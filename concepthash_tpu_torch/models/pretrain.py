"""The self-supervised pretraining nets: the trunk, a projector and, for
MoCo v3's student, a predictor (counterpart of
concepthash_tpu/models/pretrain.py).

``ProjectorNet``: the trunk's feature (the post-LayerNorm CLS token of the
CLIP-adapter tower) -> ``proj_fc1`` -> tanh-approximated GELU (flax's
``nn.gelu``) -> ``proj_fc2``, the projection, which doubles as the codes so
that the eval and extract paths run unchanged; with the predictor,
``pred_fc1`` -> GELU -> ``pred_fc2`` on the projection. Parameters are
float32 on ``device`` (CUDA unless asked otherwise); ``dtype`` is the
compute dtype; projections come back in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                               ClipVisionConfig,
                                               check_kernel_dtype)
from concepthash_tpu_torch.models.layers import dense, linear
from concepthash_tpu_torch.models.trunk import model_trunk


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    proj_dim: int = 64
    hidden_dim: int = 256
    with_predictor: bool = False  # MoCo v3's student predictor


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ProjectorNet(nn.Module):
    """Trunk + projector (+ predictor) over NHWC images; ``forward``
    returns ``features``, ``proj`` (= ``codes``) and, with the predictor,
    ``pred``."""

    def __init__(self, vision_cfg: Optional[ClipVisionConfig],
                 cfg: PretrainConfig = PretrainConfig(),
                 adapters: Optional[AdapterConfig] = None, *,
                 backbone_cfg: Optional[dict] = None, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        g = generator
        self.backbone = model_trunk(vision_cfg, adapters, backbone_cfg, dtype,
                                    g)
        self.vision_cfg = vcfg = self.backbone.tower.cfg
        check_kernel_dtype(vcfg, dtype, dev.type)
        self.cfg, self.dtype = cfg, dtype
        D = vcfg.hidden_size
        self.proj_fc1 = linear(D, cfg.hidden_dim, generator=g)
        self.proj_fc2 = linear(cfg.hidden_dim, cfg.proj_dim, generator=g)
        if cfg.with_predictor:
            self.pred_fc1 = linear(cfg.proj_dim, cfg.hidden_dim, generator=g)
            self.pred_fc2 = linear(cfg.hidden_dim, cfg.proj_dim, generator=g)
        self.to(dev)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        """No part of the net draws random numbers; ``generator`` is not
        read."""
        dt = self.dtype
        feat = self.backbone(images, train=train,
                             output_attentions=output_attentions)["features"]
        h = gelu_tanh(dense(self.proj_fc1, feat, dt))
        proj = dense(self.proj_fc2, h, dt).float()
        out = {"features": feat, "proj": proj, "codes": proj}
        if self.cfg.with_predictor:
            p = gelu_tanh(dense(self.pred_fc1, proj, dt))
            out["pred"] = dense(self.pred_fc2, p, dt).float()
        return out
