"""Image preprocessing (counterpart of concepthash_tpu/data/preprocess.py).

The host decodes an image and short-side-resizes and center-crops it to a
fixed ``resize`` square (``load_image_host``). Everything else runs batched on
the images' device: random resized crop, horizontal flip, TrivialAugment
(``data/augment.py``) and normalization for training; center crop and
normalization for eval (configs/transforms/*.yaml).

Random draws come from a ``torch.Generator`` on the images' device in place
of the reference's jax key (the jax streams cannot be reproduced), except
TrivialAugment's op indices, which a CPU generator draws so that grouping the
batch by op never waits on the device. ``sample_params`` draws them and
``apply_params`` applies them, so a test can fix every draw.

The crop-resize reproduces ``jax.image.scale_and_translate(..., 'bilinear',
antialias=False)``: output pixel centre ``i + 0.5`` samples the input at
``top + (i + 0.5) * h / out``, and the tent weights are renormalized over the
pixels inside the image, which for bilinear sampling is clamping the source
coordinate (``bilinear`` with ``border=True``).

Normalization codes: 0 -> /255 only, 1 -> mean .5 / std .5, 2 -> ImageNet
statistics, 3 -> CLIP statistics. Images are NHWC.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NORM_STATS = {
    0: ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    1: ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    2: ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),                # ImageNet
    3: ((0.48145466, 0.4578275, 0.40821073),
        (0.26862954, 0.26130258, 0.27577711)),                        # CLIP
}

# augment names that crop with the random-resized-crop law, and those that
# add TrivialAugment after it
_RRC = ("rrc", "trivial", "simple", "trivialaugment")
_TRIVIAL = ("trivial", "trivialaugment")


def normalize(images: torch.Tensor, norm: int = 2) -> torch.Tensor:
    """uint8 or float (B, H, W, C) -> normalized float32, on the images'
    device."""
    mean, std = NORM_STATS[int(norm)]
    x = images.to(torch.float32) / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean_t) / std_t


def center_crop(images: torch.Tensor, crop: int) -> torch.Tensor:
    h, w = images.shape[1], images.shape[2]
    top, left = (h - crop) // 2, (w - crop) // 2
    return images[:, top:top + crop, left:left + crop, :]


def _sample_rrc_params(generator: torch.Generator, batch: int, in_size: int,
                       scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """Random-resized-crop boxes (torchvision's RandomResizedCrop law: area
    fraction uniform in ``scale``, log aspect ratio uniform in ``ratio``) as
    (top, left, h, w) float32 pixel tensors of shape (batch,), drawn on the
    generator's device."""
    dev = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=dev)

    area = in_size * in_size * uniform(scale[0], scale[1])
    r = torch.exp(uniform(math.log(ratio[0]), math.log(ratio[1])))
    w = torch.sqrt(area * r).clamp(1.0, in_size)
    h = torch.sqrt(area / r).clamp(1.0, in_size)
    top = uniform(0.0, 1.0) * (in_size - h)
    left = uniform(0.0, 1.0) * (in_size - w)
    return top, left, h, w


def bilinear(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
             border: bool) -> torch.Tensor:
    """Bilinear samples of float (B, H, W, C) images at pixel-index
    coordinates ``ys``, ``xs`` (B, Ho, Wo) -> (B, Ho, Wo, C). ``border``
    clamps the coordinates to the image; otherwise each of the four corners
    outside the image contributes zero."""
    B, H, W, C = images.shape
    if border:
        ys, xs = ys.clamp(0, H - 1), xs.clamp(0, W - 1)
    y0, x0 = ys.floor(), xs.floor()
    wy, wx = ys - y0, xs - x0
    flat = images.reshape(B, H * W, C)
    out = torch.zeros(*ys.shape, C, dtype=images.dtype, device=images.device)
    for yi, wyi in ((y0, 1.0 - wy), (y0 + 1, wy)):
        for xi, wxi in ((x0, 1.0 - wx), (x0 + 1, wx)):
            weight = wyi * wxi
            if not border:
                weight = weight * ((yi >= 0) & (yi < H) & (xi >= 0)
                                   & (xi < W))
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            v = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
            out += weight[..., None] * v.reshape(out.shape)
    return out


def _crop_resize(images: torch.Tensor, boxes, out_size: int) -> torch.Tensor:
    """Bilinear crop + resize of float (B, H, W, C) images to (B, out, out,
    C), box b = (top[b], left[b], h[b], w[b]) in pixels, as
    ``jax.image.scale_and_translate(..., 'bilinear', antialias=False)``
    computes it (source coordinates clamped to the image)."""
    top, left, h, w = (torch.as_tensor(t, dtype=torch.float32,
                                       device=images.device) for t in boxes)
    B = images.shape[0]
    i = torch.arange(out_size, dtype=torch.float32, device=images.device) + 0.5

    def coords(start, extent):
        # scale_and_translate's own f32 arithmetic: scale out/extent,
        # translation -start*out/extent, sample (i+0.5)/scale - t/scale - 0.5
        inv = 1.0 / (out_size / extent)
        trans = -start * out_size / extent
        return (i * inv[:, None] - (trans * inv)[:, None]) - 0.5  # (B, out)

    ys, xs = coords(top, h), coords(left, w)
    return bilinear(images, ys[:, :, None].expand(B, out_size, out_size),
                    xs[:, None, :].expand(B, out_size, out_size), border=True)


def _random_crop(images: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
                 crop: int) -> torch.Tensor:
    """Per-image (crop, crop) windows at integer (top, left)."""
    r = torch.arange(crop, device=images.device)
    b = torch.arange(images.shape[0], device=images.device)
    rows = (top[:, None] + r)[:, :, None]
    cols = (left[:, None] + r)[:, None, :]
    return images[b[:, None, None], rows, cols]


def sample_params(batch: int, in_size: int, crop: int, augment: Optional[str],
                  generator: torch.Generator,
                  op_generator: Optional[torch.Generator] = None) -> dict:
    """The random draws of one train batch: the crop (``boxes`` for the
    random-resized-crop augments, ``corner`` for 'randcrop'), ``flip``
    (bool (B,)) and, for TrivialAugment, ``op`` (int64 (B,) on the CPU, from
    ``op_generator``) and ``magnitude`` (signed, (B,)). Everything but
    ``op`` is drawn on the generator's device."""
    from concepthash_tpu_torch.data.augment import sample_ops

    dev = generator.device
    params: dict = {}
    if augment in _RRC:
        params["boxes"] = _sample_rrc_params(generator, batch, in_size)
    elif augment == "randcrop":
        params["corner"] = tuple(
            torch.randint(0, in_size - crop + 1, (batch,), generator=generator,
                          device=dev) for _ in range(2))
    params["flip"] = torch.rand(batch, generator=generator, device=dev) < 0.5
    if augment in _TRIVIAL:
        if op_generator is None:
            raise ValueError("TrivialAugment draws its op indices from "
                             "op_generator, a CPU torch.Generator")
        params["op"], params["magnitude"] = sample_ops(batch, generator,
                                                       op_generator)
    return params


def apply_params(images: torch.Tensor, params: dict, crop: int = 224,
                 norm: int = 2) -> torch.Tensor:
    """uint8 (B, S, S, C) -> normalized float32 (B, crop, crop, C) under the
    train draws ``params`` (``sample_params``)."""
    from concepthash_tpu_torch.data.augment import trivial_augment_batch

    x = images.to(torch.float32)
    if "boxes" in params:
        x = _crop_resize(x, params["boxes"], crop)
    elif "corner" in params:
        x = _random_crop(x, *params["corner"], crop)
    else:
        x = center_crop(x, crop)
    x = torch.where(params["flip"][:, None, None, None], x.flip(2), x)
    if "op" in params:
        x = trivial_augment_batch(x, params["op"], params["magnitude"])
    return normalize(x, norm)


def take_rows(params: dict, rows: slice) -> dict:
    """The draws of ``sample_params`` for the batch rows ``rows``."""
    def take(v):
        return tuple(take(x) for x in v) if isinstance(v, tuple) else v[rows]

    return {k: take(v) for k, v in params.items()}


def preprocess_batch(images: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     crop: int = 224, norm: int = 2, train: bool = False,
                     augment: Optional[str] = "rrc",
                     op_generator: Optional[torch.Generator] = None,
                     mesh=None) -> torch.Tensor:
    """uint8 (B, S, S, C) -> normalized float32 (B, crop, crop, C), on the
    images' device.

    train and augment 'rrc'/'simple': random resized crop + flip;
    'trivial'/'trivialaugment': then TrivialAugment; 'randcrop': a random
    crop + flip; any other augment: center crop + flip. Eval: center crop.
    ``mesh`` (``parallel.mesh.Mesh``): the images are this rank's block of
    the global batch, whose draws are made at its size and sliced.
    """
    if not train:
        return normalize(center_crop(images, crop), norm)
    B = images.shape[0]
    W = 1 if mesh is None else mesh.size
    params = sample_params(B * W, images.shape[1], crop, augment,
                           generator, op_generator)
    if mesh is not None:
        params = take_rows(params, mesh.rows(B))
    return apply_params(images, params, crop, norm)


# ---------------------------------------------------------------------------
# host-side decode (PIL): short-side resize + center crop to a static square
# ---------------------------------------------------------------------------

def load_image_host(path: str, resize: int = 256,
                    use_native: bool = False) -> np.ndarray:
    """Decode + bicubic short-side resize + center crop to a uint8 (resize,
    resize, 3) array. Centered crops commute, so a later center crop to
    ``crop`` equals torchvision Resize(resize) + CenterCrop(crop).
    ``use_native`` takes the C++ libjpeg/libpng route (``native``: bilinear,
    DCT-scaled JPEG decode, the reference's bytes); a file it cannot decode,
    or a machine where it cannot be built, goes to PIL as in the
    reference."""
    if use_native:
        from concepthash_tpu_torch import native

        with open(path, "rb") as f:
            arr = native.decode_resize_crop(f.read(), resize)
        if arr is not None:
            return arr
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        if w <= h:
            nw, nh = resize, max(resize, int(round(h * resize / w)))
        else:
            nw, nh = max(resize, int(round(w * resize / h))), resize
        im = im.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - resize) // 2, (nh - resize) // 2
        im = im.crop((left, top, left + resize, top + resize))
        return np.asarray(im, dtype=np.uint8)
