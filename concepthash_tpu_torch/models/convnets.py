"""AlexNet and VGG16 trunks in torchvision's geometry (counterpart of
concepthash_tpu/models/convnets.py): ``features`` is the 4096-wide fc7
activation in float32.

Images are NHWC; the convolutions run on their NCHW view. The module names
are torchvision's: ``features.{i}`` at the Sequential indices of its
convolutions, and ``fc6`` / ``fc7`` for the two penultimate Linears of its
classifier (``models/cnn_loader.py`` maps ``fc.*`` / ``classifier.*``).
The adaptive average pool is ``F.adaptive_avg_pool2d`` and the flatten
before fc6 is NCHW's own (C, H, W) order, as torchvision's.

Dropout (rate 0.5) sits where the reference has it, drawn from the run's
dropout generator: AlexNet before fc6 and before fc7, VGG16 after fc6 and
after fc7. VGG16's ``tokens`` is its last pooled grid (B, H*W, 512), taken
before the adaptive pool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch.models.layers import dense, dropout, linear
from concepthash_tpu_torch.models.resnet import conv, conv2d

DROPOUT = 0.5
# torchvision Sequential indices of the conv layers
ALEXNET_CONVS = (0, 3, 6, 8, 10)
VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                (512, 512, 512))


def _drop(x, train: bool, generator):
    return dropout(x, DROPOUT, generator) if train else x


class _ConvNet(nn.Module):
    features_size = 4096

    def _convs(self, specs, dtype, generator) -> None:
        """``features.{i}`` convolutions from (index, c_in, c_out, k,
        stride, padding) rows."""
        self.features = nn.ModuleDict({
            str(i): conv2d(c_in, c_out, k, s, p, bias=True,
                           generator=generator)
            for i, c_in, c_out, k, s, p in specs})


class AlexNet(_ConvNet):
    """images (B, H, W, 3) -> {'features': (B, 4096) f32}."""

    def __init__(self, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self._convs(zip(ALEXNET_CONVS, (3, 64, 192, 384, 256),
                        (64, 192, 384, 256, 256), (11, 5, 3, 3, 3),
                        (4, 1, 1, 1, 1), (2, 2, 1, 1, 1)), dtype, generator)
        self.fc6 = linear(256 * 6 * 6, 4096, generator=generator)
        self.fc7 = linear(4096, 4096, generator=generator)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator=None, **_) -> dict:
        dt = self.dtype
        c = [self.features[str(i)] for i in ALEXNET_CONVS]
        x = images.to(dt).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(conv(c[0], x, dt)), 3, 2)
        x = F.max_pool2d(F.relu(conv(c[1], x, dt)), 3, 2)
        x = F.relu(conv(c[2], x, dt))
        x = F.relu(conv(c[3], x, dt))
        x = F.max_pool2d(F.relu(conv(c[4], x, dt)), 3, 2)
        x = F.adaptive_avg_pool2d(x, 6).flatten(1)
        x = F.relu(dense(self.fc6, _drop(x, train, generator), dt))
        x = F.relu(dense(self.fc7, _drop(x, train, generator), dt))
        return {"features": x.float()}


class VGG16(_ConvNet):
    """images (B, H, W, 3) -> {'features': (B, 4096) f32, 'tokens':
    (B, H'*W', 512)}."""

    def __init__(self, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        chans = [c for stage in VGG16_STAGES for c in stage]
        self._convs(((i, c_in, c_out, 3, 1, 1) for i, c_in, c_out in
                     zip(VGG16_CONVS, [3] + chans[:-1], chans)), dtype,
                    generator)
        self.fc6 = linear(512 * 7 * 7, 4096, generator=generator)
        self.fc7 = linear(4096, 4096, generator=generator)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator=None, **_) -> dict:
        dt = self.dtype
        x = images.to(dt).permute(0, 3, 1, 2)
        k = 0
        for stage in VGG16_STAGES:
            for _ in stage:
                x = F.relu(conv(self.features[str(VGG16_CONVS[k])], x, dt))
                k += 1
            x = F.max_pool2d(x, 2, 2)
        B, C, H, W = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        x = F.adaptive_avg_pool2d(x, 7).flatten(1)
        x = _drop(F.relu(dense(self.fc6, x, dt)), train, generator)
        x = _drop(F.relu(dense(self.fc7, x, dt)), train, generator)
        return {"features": x.float(), "tokens": tokens}
