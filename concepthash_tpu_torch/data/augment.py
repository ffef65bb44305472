"""TrivialAugment on device tensors (counterpart of
concepthash_tpu/data/augment.py): one op per image at a signed random
magnitude, on float32 (B, H, W, C) images in [0, 255] before normalization.

The reference selects each image's op with ``jax.lax.switch`` under
``vmap``. Here the batch is grouped by op: one gather puts the images of each
op side by side, each op runs once on its group, and one scatter puts them
back. The op indices live on the CPU (drawn from a CPU generator), so the
grouping never waits on the device.

The ops, their magnitude laws and their edge rules are the reference's:
geometric ops warp with ``map_coordinates(order=1, mode='constant')``, which
zero-pads each bilinear corner outside the image (``preprocess.bilinear``
with ``border=False``); ``equalize`` is approximated by
autocontrast, as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from concepthash_tpu_torch.data.preprocess import bilinear


def _per_image(m: torch.Tensor) -> torch.Tensor:
    return m[:, None, None, None]


def _blend(a, b, t):
    return a + (b - a) * t


def _identity(im, m):
    return im


def _brightness(im, m):
    return (im * (1.0 + _per_image(m))).clamp(0, 255)


def _saturation(im, m):
    gray = im.mean(dim=-1, keepdim=True)
    return _blend(gray, im, 1.0 + _per_image(m)).clamp(0, 255)


def _contrast(im, m):
    mean = im.mean(dim=(1, 2, 3), keepdim=True)
    return _blend(mean, im, 1.0 + _per_image(m)).clamp(0, 255)


def _sharpness(im, m):
    B, H, W, C = im.shape
    k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32,
                     device=im.device) / 13.0
    planes = im.permute(0, 3, 1, 2).reshape(B * C, 1, H, W)
    blurred = F.conv2d(planes, k[None, None], padding=1)
    blurred = blurred.reshape(B, C, H, W).permute(0, 2, 3, 1)
    return _blend(blurred, im, 1.0 + _per_image(m)).clamp(0, 255)


def _posterize(im, m):
    # |m| in [0, 1) keeps 8..3 bits; the sign is ignored (a negative shift
    # would black the image out)
    shift = torch.floor(m.abs() * 6).to(torch.uint8)
    q = im.to(torch.uint8)
    q = (q >> _per_image(shift)) << _per_image(shift)
    return q.to(torch.float32)


def _solarize(im, m):
    thresh = 255.0 * (1.0 - _per_image(m).abs())
    return torch.where(im >= thresh, 255.0 - im, im)


def _autocontrast(im, _m):
    lo = im.amin(dim=(1, 2), keepdim=True)
    hi = im.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-5)
    return ((im - lo) * scale).clamp(0, 255)


def _affine(im, mat, offset):
    """Inverse-affine warp per image: output(y, x) = input(mat @ [y, x] +
    offset) about the image centre, bilinear, zero outside. ``mat`` (B, 2,
    2), ``offset`` (B, 2)."""
    B, H, W, _ = im.shape
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=im.device),
        torch.arange(W, dtype=torch.float32, device=im.device), indexing="ij")
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    y, x = yy - cy, xx - cx

    def row(r):
        return (mat[:, r, 0, None, None] * y + mat[:, r, 1, None, None] * x
                + offset[:, r, None, None])

    return bilinear(im, row(0) + cy, row(1) + cx, border=False)


def _mats(a, b, c, d):
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)


def _rotate(im, m):
    theta = m * math.pi * (135.0 / 180.0) / 2
    c, s = torch.cos(theta), torch.sin(theta)
    return _affine(im, _mats(c, -s, s, c), torch.zeros(len(m), 2,
                                                       device=im.device))


def _shear_x(im, m):
    one, zero = torch.ones_like(m), torch.zeros_like(m)
    return _affine(im, _mats(one, zero, m, one), torch.zeros(
        len(m), 2, device=im.device))


def _shear_y(im, m):
    one, zero = torch.ones_like(m), torch.zeros_like(m)
    return _affine(im, _mats(one, m, zero, one), torch.zeros(
        len(m), 2, device=im.device))


def _translate_x(im, m):
    one, zero = torch.ones_like(m), torch.zeros_like(m)
    return _affine(im, _mats(one, zero, zero, one),
                   torch.stack([zero, m * im.shape[2] * 0.3], -1))


def _translate_y(im, m):
    one, zero = torch.ones_like(m), torch.zeros_like(m)
    return _affine(im, _mats(one, zero, zero, one),
                   torch.stack([m * im.shape[1] * 0.3, zero], -1))


# the reference's op order (concepthash_tpu/data/augment.py _OPS)
OPS = (
    _identity,
    _brightness,
    _saturation,
    _contrast,
    _sharpness,
    _posterize,
    _solarize,
    _autocontrast,
    _autocontrast,             # equalize -> autocontrast approximation
    _rotate,
    _shear_x,
    _shear_y,
    _translate_x,
    _translate_y,
)


def sample_ops(batch: int, generator: torch.Generator,
               op_generator: torch.Generator):
    """(op, magnitude): op indices uniform over ``OPS``, int64 (B,) on the
    CPU from ``op_generator``; magnitudes uniform in [0, 1) with a sign
    drawn at rate 0.5, (B,) on ``generator``'s device."""
    op = torch.randint(0, len(OPS), (batch,), generator=op_generator)
    dev = generator.device
    mag = torch.rand(batch, generator=generator, device=dev)
    sign = torch.where(torch.rand(batch, generator=generator, device=dev)
                       < 0.5, 1.0, -1.0)
    return op, mag * sign


def trivial_augment_batch(images: torch.Tensor, op: torch.Tensor,
                          magnitude: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) float32 [0, 255] -> the same, image b through
    ``OPS[op[b]]`` at ``magnitude[b]``. ``op`` is a CPU int64 tensor."""
    op = op.cpu()
    order = torch.argsort(op, stable=True)
    sizes = torch.bincount(op, minlength=len(OPS)).tolist()
    if images.is_cuda:
        order = order.pin_memory()
    perm = order.to(images.device, non_blocking=True)
    grouped, mags = images[perm], magnitude[perm]
    parts, start = [], 0
    for fn, n in zip(OPS, sizes):
        if n:
            parts.append(fn(grouped[start:start + n], mags[start:start + n]))
        start += n
    out = torch.empty_like(images)
    out[perm] = torch.cat(parts)
    return out
