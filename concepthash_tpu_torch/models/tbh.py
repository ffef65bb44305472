"""TBH, auto-encoding twin-bottleneck hashing, and its discriminator
(counterpart of concepthash_tpu/models/tbh.py).

``TBHNet``: the trunk's feature -> ``enc_fc`` -> tanh-approximated GELU
(flax's ``nn.gelu``) -> two bottlenecks: the binary one, bits ``b`` =
[sigmoid(``enc_b``) > 0.5] with the sigmoid's gradient passed straight
through, and the continuous one, z = sigmoid(``enc_z``). The batch's code
similarity graph ``sim = (b b^T + (1 - b)(1 - b)^T) / nbit`` (float32), row
normalized, mixes z through one GCN layer (``gcn``, ReLU); ``dec``
reconstructs the feature from [z_mix, b]. Codes are 2b - 1.

``Discriminator``: ``fc1`` (128) -> leaky ReLU (slope 0.01) -> ``fc2`` (1),
float32; it tells the uniform prior from z.
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
from concepthash_tpu_torch.models.pretrain import gelu_tanh
from concepthash_tpu_torch.models.trunk import (model_trunk,
                                                trunk_features_size)
from concepthash_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class TBHConfig:
    nbit: int = 64
    zdim: int = 64
    hidden: int = 256


class TBHNet(nn.Module):
    """The twin-bottleneck auto-encoder over NHWC images; ``forward``
    returns ``codes`` (2b - 1), ``b_logits``, ``z``, ``recon`` and
    ``features``, all float32."""

    def __init__(self, vision_cfg: Optional[ClipVisionConfig],
                 cfg: TBHConfig = TBHConfig(),
                 adapters: Optional[AdapterConfig] = None, *,
                 backbone_cfg: Optional[dict] = None, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        g = generator
        self.backbone = model_trunk(vision_cfg, adapters, backbone_cfg, dtype,
                                    g)
        self.vision_cfg = vcfg = self.backbone.vision_cfg
        if vcfg is not None:
            check_kernel_dtype(vcfg, dtype, dev.type)
        self.cfg, self.dtype = cfg, dtype
        D = trunk_features_size(self.backbone)
        self.enc_fc = linear(D, cfg.hidden, generator=g)
        self.enc_b = linear(cfg.hidden, cfg.nbit, generator=g)
        self.enc_z = linear(cfg.hidden, cfg.zdim, generator=g)
        self.gcn = linear(cfg.zdim, cfg.zdim, generator=g)
        self.dec = linear(cfg.zdim + cfg.nbit, D, generator=g)
        self.to(dev)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        """Only an AlexNet or VGG16 trunk draws random numbers (its
        dropout, from ``generator``)."""
        c, dt = self.cfg, self.dtype
        feat = self.backbone(images, train=train,
                             output_attentions=output_attentions,
                             generator=generator)["features"]
        h = gelu_tanh(dense(self.enc_fc, feat, dt))
        b_logits = dense(self.enc_b, h, dt).float()
        p = torch.sigmoid(b_logits)
        b = (p > 0.5).float() + (p - p.detach())     # straight through
        z = torch.sigmoid(dense(self.enc_z, h, dt).float())
        # the graph over the batch: in a data-parallel forward, this rank's
        # rows of it over the global batch
        b_all, z_all = (collectives.gather_batch_rows(t) for t in (b, z))
        sim = (b @ b_all.t() + (1 - b) @ (1 - b_all).t()) / c.nbit
        deg = sim.sum(dim=1, keepdim=True).clamp_min(1e-6)
        z_mix = torch.relu(dense(self.gcn, (sim / deg) @ z_all, dt).float())
        rec = dense(self.dec, torch.cat([z_mix, b], dim=-1), dt)
        return {"codes": 2 * b - 1, "b_logits": b_logits, "z": z,
                "recon": rec.float(), "features": feat.float()}


class Discriminator(nn.Module):
    """fc1 -> leaky ReLU -> fc2, float32: (B, zdim) -> (B,) logits."""

    def __init__(self, zdim: int, hidden: int = 128, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = linear(zdim, hidden, generator=generator)
        self.fc2 = linear(hidden, 1, generator=generator)
        self.to(resolve_device(device))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.fc1(z), 0.01)
        return self.fc2(h)[..., 0]
