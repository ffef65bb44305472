"""Eval-time image preprocessing on device tensors (counterpart of the eval
subset of concepthash_tpu/data/preprocess.py).

Normalization codes: 0 -> /255 only, 1 -> mean .5 / std .5, 2 -> ImageNet
statistics, 3 -> CLIP statistics. Images are NHWC.
"""

from __future__ import annotations

import torch

NORM_STATS = {
    0: ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    1: ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    2: ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),                # ImageNet
    3: ((0.48145466, 0.4578275, 0.40821073),
        (0.26862954, 0.26130258, 0.27577711)),                        # CLIP
}


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
