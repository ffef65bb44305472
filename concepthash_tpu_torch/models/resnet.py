"""ResNet-18/34/50/101 trunk in torchvision's geometry (counterpart of
concepthash_tpu/models/resnet.py).

Images are NHWC; the trunk runs the convolutions on their NCHW view
(channels-last in memory, which cuDNN takes as it is). Padding is
torchvision's, explicit: the stem 7x7/2 at 3, the max-pool 3x3/2 at 1, every
3x3 at 1; a bottleneck strides its 3x3. The module names are torchvision's
(``conv1``, ``bn1``, ``layer{1-4}.{i}.conv{j}`` / ``bn{j}``,
``downsample.{0,1}``), so a torchvision state dict loads by name
(``models/cnn_loader.py``).

Every BatchNorm has flax's semantics (``layers.CodeBatchNorm``: running
statistics ``0.9 r + 0.1 stat`` with the biased batch variance, statistics
in float32) and torchvision's buffers, ``num_batches_tracked`` included.
``frozen_bn`` (the reference's ResNet-18 wrapper) keeps every BatchNorm in
eval mode in training: it normalizes with the running statistics, which
never change.

``features`` is the global mean of the last grid in float32; ``tokens`` the
(B, H*W, C) grid in row-major (H, W) order, in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch.models.layers import CodeBatchNorm, normal_

STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    frozen_bn: bool = False

    @property
    def features_size(self) -> int:
        return 512 * (4 if STAGES[self.depth][0] == "bottleneck" else 1)


def conv2d(c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0,
           bias: bool = False, generator=None) -> nn.Conv2d:
    """nn.Conv2d with flax Conv's initial scale: lecun-normal weights (std
    1/sqrt(fan_in)), zero bias."""
    conv = nn.Conv2d(c_in, c_out, k, stride, padding, bias=bias,
                     device="meta").to_empty(device="cpu")
    normal_(conv.weight, 1.0 / math.sqrt(c_in * k * k), generator)
    if bias:
        with torch.no_grad():
            conv.bias.zero_()
    return conv


def conv(mod: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``mod`` applied in the compute dtype."""
    b = None if mod.bias is None else mod.bias.to(dtype)
    return F.conv2d(x, mod.weight.to(dtype), b, mod.stride, mod.padding)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int, dtype,
                 generator=None):
        super().__init__()
        g = generator
        self.dtype = dtype
        self.conv1 = conv2d(c_in, filters, 3, stride, 1, generator=g)
        self.bn1 = CodeBatchNorm(filters, dtype, track_batches=True)
        self.conv2 = conv2d(filters, filters, 3, 1, 1, generator=g)
        self.bn2 = CodeBatchNorm(filters, dtype, track_batches=True)
        self.downsample = _downsample(c_in, filters, stride, dtype, g)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(conv(self.conv1, x, dt), train))
        y = self.bn2(conv(self.conv2, y, dt), train)
        return F.relu(_residual(self.downsample, x, train, dt) + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int, dtype,
                 generator=None):
        super().__init__()
        g = generator
        self.dtype = dtype
        self.conv1 = conv2d(c_in, filters, 1, generator=g)
        self.bn1 = CodeBatchNorm(filters, dtype, track_batches=True)
        self.conv2 = conv2d(filters, filters, 3, stride, 1, generator=g)
        self.bn2 = CodeBatchNorm(filters, dtype, track_batches=True)
        self.conv3 = conv2d(filters, 4 * filters, 1, generator=g)
        self.bn3 = CodeBatchNorm(4 * filters, dtype, track_batches=True)
        self.downsample = _downsample(c_in, 4 * filters, stride, dtype, g)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(conv(self.conv1, x, dt), train))
        y = F.relu(self.bn2(conv(self.conv2, y, dt), train))
        y = self.bn3(conv(self.conv3, y, dt), train)
        return F.relu(_residual(self.downsample, x, train, dt) + y)


def _downsample(c_in: int, c_out: int, stride: int, dtype, generator):
    """The 1x1 projection and its BatchNorm where the block changes the
    shape (the reference projects when ``res.shape != y.shape``)."""
    if stride == 1 and c_in == c_out:
        return None
    return nn.Sequential(conv2d(c_in, c_out, 1, stride, generator=generator),
                         CodeBatchNorm(c_out, dtype, track_batches=True))


def _residual(down, x, train: bool, dtype) -> torch.Tensor:
    if down is None:
        return x
    return down[1](conv(down[0], x, dtype), train)


class ResNet(nn.Module):
    """images (B, H, W, 3) -> {'features': (B, C) f32, 'tokens':
    (B, H'*W', C)}."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig(),
                 dtype=torch.float32, generator=None):
        super().__init__()
        kind, stages = STAGES[cfg.depth]
        Block = BasicBlock if kind == "basic" else Bottleneck
        g = generator
        self.cfg, self.dtype = cfg, dtype
        self.conv1 = conv2d(3, 64, 7, 2, 3, generator=g)
        self.bn1 = CodeBatchNorm(64, dtype, track_batches=True)
        c_in = 64
        for i, n_blocks in enumerate(stages):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(Block(c_in, 64 * 2 ** i, stride, dtype, g))
                c_in = 64 * 2 ** i * Block.expansion
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))

    @staticmethod
    def grid(image_size: int) -> int:
        """The side of the last grid at ``image_size``."""
        s = (image_size + 6 - 7) // 2 + 1         # stem 7x7/2, pad 3
        s = (s + 2 - 3) // 2 + 1                  # max-pool 3x3/2, pad 1
        for _ in range(3):                         # three stride-2 stages
            s = (s + 2 - 3) // 2 + 1
        return s

    def forward(self, images: torch.Tensor, train: bool = False, **_) -> dict:
        train = train and not self.cfg.frozen_bn
        dt = self.dtype
        x = images.to(dt).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(conv(self.conv1, x, dt), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                x = block(x, train)
        B, C, H, W = x.shape
        return {"features": x.float().mean(dim=(2, 3)),
                "tokens": x.permute(0, 2, 3, 1).reshape(B, H * W, C)}
