"""Swin Transformer trunk, tiny / small / base and a miniature ``test``
variant (counterpart of concepthash_tpu/models/swin.py): a 4x4 patch
embedding, windowed self-attention with a relative-position bias, shifted
windows in every second block, and patch merging between stages.
``features`` is the mean of the LayerNorm'd last tokens in float32,
``tokens`` those (B, H*W, 8 * embed_dim) tokens.

The module names are timm's (``patch_embed.{proj,norm}``,
``layers.{s}.blocks.{b}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}``, ``norm``), with
the patch merging at the start of the stage it feeds
(``layers.{s}.downsample.{norm,reduction}``, s >= 1), where timm 0.9 puts
it. The relative-position index and the shift masks (-1e9 between
positions from different pre-shift regions) are built once on the host,
from ``SwinConfig.image_size``, as non-persistent buffers. A stage whose
grid is no larger than the window takes the whole grid as its window
(``min(window, H, W)``, whose bias table is sized to it) and no shift.

Arithmetic as the reference's: LayerNorm eps 1e-5 with float32 statistics,
exact (erf) GELU, attention logits in the compute dtype plus the float32
bias (so float32 from there), softmax in float32 cast back to the compute
dtype. The window attention is plain torch, as it is plain jnp in the
reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch.models.layers import (dense, layer_norm, linear,
                                                 normal_)
from concepthash_tpu_torch.models.resnet import conv, conv2d

VARIANTS = {
    # timm swin_*_patch4_window7_224: (embed_dim, depths, num_heads)
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    # the reference's miniature for CPU tests (not a timm geometry)
    "test": (16, (2, 2, 1, 1), (2, 2, 2, 2)),
}
LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    variant: str = "base"
    image_size: int = 224
    patch_size: int = 4
    window_size: int = 7
    mlp_ratio: float = 4.0

    @property
    def dims(self):
        return VARIANTS[self.variant]

    @property
    def features_size(self) -> int:
        return self.dims[0] * 8

    def grids(self) -> list:
        """The side of each stage's grid."""
        side = self.image_size // self.patch_size
        out = []
        for si in range(4):
            if si > 0:
                if side < 2:
                    raise ValueError(
                        f"Swin grid exhausted before stage {si} ({side}x"
                        f"{side}); image_size/patch_size must be >= "
                        f"{self.patch_size * 8}")
                side //= 2
            out.append(side)
        return out


def relative_position_index(ws: int) -> np.ndarray:
    """timm's (ws^2, ws^2) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, L, L) additive mask of a shifted block: -1e9 between positions
    of different pre-shift regions, 0 elsewhere."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, :, None] != win[:, None, :]
    return np.where(diff, -1e9, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(w: torch.Tensor, ws: int, B: int, H: int,
                   W: int) -> torch.Tensor:
    C = w.shape[-1]
    x = w.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int, dtype,
                 generator=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = linear(dim, 3 * dim, generator=generator)
        self.proj = linear(dim, dim, generator=generator)
        # the reference's truncated normal (0.02): a normal at 0.02 here
        self.relative_position_bias_table = nn.Parameter(normal_(
            torch.empty((2 * ws - 1) ** 2, num_heads), 0.02, generator))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(ws).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        """x: (Bw, L, C) windows; mask: (nW, L, L) additive, or None."""
        Bw, L, C = x.shape
        nh = self.num_heads
        hd = C // nh
        q, k, v = (t.reshape(Bw, L, nh, hd).transpose(1, 2)
                   for t in dense(self.qkv, x, self.dtype).chunk(3, dim=-1))
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2)      # (Bw, nh, L, L)
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(L, L, nh)
        logits = logits + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            logits = (logits.reshape(Bw // nW, nW, nh, L, L)
                      + mask[None, :, None].to(logits.dtype)
                      ).reshape(Bw, nh, L, L)
        p = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        o = (p @ v).transpose(1, 2).reshape(Bw, L, C)
        return dense(self.proj, o, self.dtype)


class SwinMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = linear(dim, hidden, generator=generator)
        self.fc2 = linear(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.fc2, F.gelu(dense(self.fc1, x, self.dtype)),
                     self.dtype)


class SwinBlock(nn.Module):
    """One block on a ``grid`` x ``grid`` map; ``shift`` applies only where
    the window is smaller than the grid."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, grid: int, mlp_ratio: float, dtype,
                 generator=None):
        super().__init__()
        ws = min(window_size, grid)
        if grid % ws:
            raise ValueError(
                f"Swin grid {grid}x{grid} not divisible by window {ws}; pick "
                f"an image size with grids divisible by the window at every "
                f"stage (224/patch4/window7 is the canonical geometry)")
        self.ws, self.grid, self.dtype = ws, grid, dtype
        self.shift = shift if ws < grid else 0
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, ws, dtype, generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = SwinMLP(dim, int(dim * mlp_ratio), dtype, generator)
        self.register_buffer(
            "attn_mask", torch.from_numpy(shift_attn_mask(
                grid, grid, ws, self.shift)) if self.shift else None,
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if (H, W) != (self.grid, self.grid):
            raise ValueError(f"Swin block built for a {self.grid}^2 grid "
                             f"got {H}x{W}: set backbone.image_size to the "
                             "crop")
        s, ws = self.shift, self.ws
        y = layer_norm(self.norm1, x, self.dtype)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws),
                                     self.attn_mask), ws, B, H, W)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp(layer_norm(self.norm2, x, self.dtype))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in timm's order (x[0::2, 0::2],
    x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]), LayerNorm, then a Linear
    to twice the width without bias."""

    def __init__(self, dim: int, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = linear(4 * dim, 2 * dim, bias=False,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        return dense(self.reduction, layer_norm(self.norm, x, self.dtype),
                     self.dtype)


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, grid: int,
                 cfg: SwinConfig, merge: bool, dtype, generator=None):
        super().__init__()
        self.downsample = (PatchMerging(dim // 2, dtype, generator)
                           if merge else None)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, cfg.window_size,
                      0 if bi % 2 == 0 else cfg.window_size // 2, grid,
                      cfg.mlp_ratio, dtype, generator)
            for bi in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        self.proj = conv2d(3, dim, patch, patch, bias=True,
                           generator=generator)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = conv(self.proj, images.to(self.dtype).permute(0, 3, 1, 2),
                 self.dtype)
        return layer_norm(self.norm, x.permute(0, 2, 3, 1), self.dtype)


class SwinTransformer(nn.Module):
    """images (B, H, W, 3) at ``cfg.image_size`` -> {'features':
    (B, 8 * embed_dim) f32, 'tokens': (B, L, 8 * embed_dim)}."""

    def __init__(self, cfg: SwinConfig = SwinConfig(), dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        embed_dim, depths, heads = cfg.dims
        self.patch_embed = PatchEmbed(cfg.patch_size, embed_dim, dtype,
                                      generator)
        self.layers = nn.ModuleList(
            SwinStage(embed_dim * 2 ** si, depth, nh, grid, cfg, si > 0,
                      dtype, generator)
            for si, (depth, nh, grid) in enumerate(
                zip(depths, heads, cfg.grids())))
        self.norm = nn.LayerNorm(embed_dim * 8, eps=LN_EPS)

    def forward(self, images: torch.Tensor, train: bool = False, **_) -> dict:
        x = self.patch_embed(images)
        for stage in self.layers:
            x = stage(x)
        B, H, W, C = x.shape
        tokens = layer_norm(self.norm, x.reshape(B, H * W, C), self.dtype)
        return {"features": tokens.float().mean(dim=1), "tokens": tokens}
