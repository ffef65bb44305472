"""The masked autoencoder (counterpart of concepthash_tpu/models/mae.py),
which the ``mae`` method trains and the ``autoencoder`` method trains at
``mask_ratio`` 0.

A ViT over the image's patches (flattened in (ph, pw, C) order): a biased
``patch_embed``, the learned ``enc_pos``, ``enc_layers`` encoder layers
(``models/clip.py`` ``EncoderLayer``: pre-LN, LayerNorm eps 1e-5, exact
GELU, no adapters) and ``enc_norm`` (LayerNorm eps 1e-6, flax's). The
features, which double as the codes, are the mean of the encoded tokens.
In training a random ``n_keep = max(1, int(P (1 - mask_ratio)))`` of each
image's P patches are encoded, ordered by an argsort of a uniform draw; the
decoder (``dec_embed``, the learned ``mask_token`` at the masked positions,
``dec_pos``, ``dec_layers`` layers, ``dec_norm``, ``dec_pred``) predicts
every patch's pixels, against per-patch-normalized targets. The eval
forward returns no reconstruction, and ``mae_loss`` is 0 there.

The encoder layers are built with the default settings, as the
reference's are, and dispatch as every encoder layer of the port does
(``whole_layer_route``): an inference forward takes the whole-layer kernel
on the card at bfloat16; a train forward the discrete path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.models.clip import EncoderLayer
from concepthash_tpu_torch.models.layers import (dense, layer_norm, linear,
                                                 normal_)
from concepthash_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    image_size: int = 224
    patch_size: int = 16
    enc_dim: int = 768
    enc_layers: int = 12
    enc_heads: int = 12
    dec_dim: int = 256
    dec_layers: int = 4
    dec_heads: int = 8
    mask_ratio: float = 0.75

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3

    @property
    def n_keep(self) -> int:
        """The patches a training forward encodes."""
        return max(1, int(self.num_patches * (1.0 - self.mask_ratio)))


class MAE(nn.Module):
    """The masked autoencoder over NHWC images; ``forward`` returns
    ``features`` (= ``codes``) and, in training, ``recon``, ``target`` and
    ``mask`` (1 = masked), all float32. Parameters are float32 on
    ``device`` (CUDA unless asked otherwise); ``dtype`` is the compute
    dtype."""

    def __init__(self, cfg: MAEConfig = MAEConfig(), *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        g, P = generator, cfg.num_patches

        def layers(dim, heads, n):
            return nn.ModuleList(
                EncoderLayer(dim, heads, 4 * dim, act="gelu", dtype=dtype,
                             generator=g) for _ in range(n))

        self.patch_embed = linear(cfg.patch_dim, cfg.enc_dim, generator=g)
        self.enc_pos = nn.Parameter(normal_(torch.empty(P, cfg.enc_dim),
                                            0.02, g))
        self.enc = layers(cfg.enc_dim, cfg.enc_heads, cfg.enc_layers)
        self.enc_norm = nn.LayerNorm(cfg.enc_dim, eps=1e-6)
        self.dec_embed = linear(cfg.enc_dim, cfg.dec_dim, generator=g)
        self.mask_token = nn.Parameter(normal_(torch.empty(1, 1, cfg.dec_dim),
                                               0.02, g))
        self.dec_pos = nn.Parameter(normal_(torch.empty(P, cfg.dec_dim),
                                            0.02, g))
        self.dec = layers(cfg.dec_dim, cfg.dec_heads, cfg.dec_layers)
        self.dec_norm = nn.LayerNorm(cfg.dec_dim, eps=1e-6)
        self.dec_pred = linear(cfg.dec_dim, cfg.patch_dim, generator=g)
        self.to(dev)

    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, P, p*p*C), patches in row-major order."""
        c = self.cfg
        B, H, W, C = images.shape
        g, p = H // c.patch_size, c.patch_size
        x = images.reshape(B, g, p, g, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, g * g, c.patch_dim)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> dict:
        """``train``: the mask's order from ``noise`` (B, P), or a uniform
        draw from ``generator``. Attention maps are not returned."""
        c, dt = self.cfg, self.dtype
        B, P = images.shape[0], c.num_patches
        patches = self.patchify(images.to(dt))
        x = dense(self.patch_embed, patches, dt) + self.enc_pos.to(dt)[None]
        if train:
            if noise is None:   # at the global batch's shape, sliced
                noise = collectives.rows_of(lambda n: torch.rand(
                    (n, P), generator=generator, device=images.device), B)
            order = torch.argsort(noise, dim=1, stable=True)
            keep_idx = order[:, :c.n_keep]
            mask = torch.ones((B, P), device=images.device).scatter(
                1, keep_idx, 0.0)
            x = torch.gather(x, 1, keep_idx[..., None].expand(
                -1, -1, c.enc_dim))
        for layer in self.enc:
            x, _ = layer(x, train=train)
        x = layer_norm(self.enc_norm, x, dt)
        feat = x.mean(dim=1).float()
        out = {"features": feat, "codes": feat}
        if not train:
            return out

        y_vis = dense(self.dec_embed, x, dt)
        y = self.mask_token.to(dt).expand(B, P, c.dec_dim)
        y = torch.scatter(y, 1, keep_idx[..., None].expand(-1, -1, c.dec_dim),
                          y_vis)
        y = y + self.dec_pos.to(dt)[None]
        for layer in self.dec:
            y, _ = layer(y, train=train)
        y = layer_norm(self.dec_norm, y, dt)
        recon = dense(self.dec_pred, y, dt).float()
        # per-patch normalized pixel targets (statistics in float32, as
        # jnp.mean and jnp.var compute a half-precision input's)
        pf = patches.float()
        mean = pf.mean(dim=-1, keepdim=True).to(dt)
        var = pf.var(dim=-1, unbiased=False, keepdim=True).to(dt)
        target = ((patches - mean) / torch.sqrt(var + 1e-6)).float()
        out.update({"recon": recon, "target": target, "mask": mask})
        return out


def mae_loss(outputs: dict) -> tuple:
    """The mean squared error over the masked patches; 0 for an eval
    forward, which returns no reconstruction."""
    if "recon" not in outputs:
        return outputs["codes"].new_zeros(()), {}
    mask = outputs["mask"]
    err = ((outputs["recon"] - outputs["target"]) ** 2).mean(dim=-1)
    loss = (err * mask).sum() / mask.sum().clamp_min(1.0)
    return loss, {"recon_mse": loss}


def autoencoder_loss(outputs: dict) -> tuple:
    """The mean squared error over every patch; 0 for an eval forward."""
    if "recon" not in outputs:
        return outputs["codes"].new_zeros(()), {}
    err = ((outputs["recon"] - outputs["target"]) ** 2).mean()
    return err, {"recon_mse": err}

