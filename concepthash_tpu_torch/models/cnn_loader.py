"""torchvision-layout state dicts onto the port's CNN trunks (counterpart of
concepthash_tpu/models/cnn_loader.py).

The port's ResNet, AlexNet and VGG16 (``models/resnet.py``,
``models/convnets.py``) keep torchvision's module names and its (O, I, kh,
kw) kernels, so a torchvision state dict (also the layout inside reference
checkpoints: the reference's ResNet wrapper keeps the torchvision module
under ``self.model``, its AlexNet and VGG16 wrappers re-attach ``features``
and the penultimate classifier slice as ``fc``) maps by name: a ResNet's
keys as they are (BatchNorm running statistics and ``num_batches_tracked``
included, the final ``fc`` dropped), AlexNet's and VGG16's ``features.*``
as they are and the two penultimate Linears into ``fc6`` and ``fc7``.
Values come in as numpy arrays or tensors and go out as tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from concepthash_tpu_torch.models.convnets import ALEXNET_CONVS, VGG16_CONVS
from concepthash_tpu_torch.models.resnet import STAGES


def _tensor(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().cpu().clone()
    return torch.from_numpy(np.array(v))


def resnet_depth_from_torch(sd: Dict) -> int:
    """18/34/50/101 from the state dict's block kind and counts."""
    kind = "bottleneck" if "layer1.0.conv3.weight" in sd else "basic"
    counts = []
    for li in range(1, 5):
        n = 0
        while f"layer{li}.{n}.conv1.weight" in sd:
            n += 1
        counts.append(n)
    for depth, (k, stages) in STAGES.items():
        if k == kind and tuple(counts) == stages:
            return depth
    raise ValueError(f"unrecognized ResNet layout: {kind} blocks {counts}")


def _bn(out: dict, sd: Dict, key: str) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{key}.{leaf}"] = _tensor(sd[f"{key}.{leaf}"])
    nbt = f"{key}.num_batches_tracked"
    out[nbt] = (_tensor(sd[nbt]) if nbt in sd
                else torch.zeros((), dtype=torch.long))


def resnet_state_from_torch(sd: Dict, depth: int) -> dict:
    """A ``models.resnet.ResNet`` state dict from a torchvision one."""
    kind, stages = STAGES[depth]
    n_convs = 2 if kind == "basic" else 3
    out = {"conv1.weight": _tensor(sd["conv1.weight"])}
    _bn(out, sd, "bn1")
    for si, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            t = f"layer{si + 1}.{bi}"
            for ci in range(1, n_convs + 1):
                out[f"{t}.conv{ci}.weight"] = _tensor(
                    sd[f"{t}.conv{ci}.weight"])
                _bn(out, sd, f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                out[f"{t}.downsample.0.weight"] = _tensor(
                    sd[f"{t}.downsample.0.weight"])
                _bn(out, sd, f"{t}.downsample.1")
    return out


def _convnet_state(sd: Dict, convs, fc_prefix: str,
                   fc_idx: Tuple[int, int]) -> dict:
    out = {}
    for t in convs:
        for leaf in ("weight", "bias"):
            out[f"features.{t}.{leaf}"] = _tensor(sd[f"features.{t}.{leaf}"])
    for name, i in zip(("fc6", "fc7"), fc_idx):
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = _tensor(sd[f"{fc_prefix}.{i}.{leaf}"])
    return out


def alexnet_state_from_torch(sd: Dict, fc_prefix: str = "fc",
                             fc_idx: Tuple[int, int] = (1, 4)) -> dict:
    """A ``models.convnets.AlexNet`` state dict. ``fc_prefix`` / ``fc_idx``
    name the two penultimate Linears: the reference wrapper's ``fc.1`` /
    ``fc.4``, or a raw torchvision dict's ``classifier`` / (1, 4)."""
    return _convnet_state(sd, ALEXNET_CONVS, fc_prefix, fc_idx)


def vgg16_state_from_torch(sd: Dict, fc_prefix: str = "fc",
                           fc_idx: Tuple[int, int] = (0, 3)) -> dict:
    """A ``models.convnets.VGG16`` state dict (the reference wrapper's
    ``fc.0`` / ``fc.3``, or torchvision's ``classifier`` / (0, 3))."""
    return _convnet_state(sd, VGG16_CONVS, fc_prefix, fc_idx)
