"""CLIP vision tower with parallel bottleneck adapters (counterpart of the
vision part of concepthash_tpu/models/clip.py).

Images are NHWC. The patch embedding is a matmul over patches flattened in
(ph, pw, C) order, with its kernel stored in HWIO form (p, p, C, D), as in
the reference. ``EncoderLayer`` dispatches as the reference does:

- the whole-layer kernel (``ops.fused_layer.encoder_layer``: the CUDA kernel
  on the card, its plain version on the CPU) for inference forwards under
  ``fused_ln='auto'`` (the port's counterpart of the reference's "auto on
  TPU"; on the card only at bfloat16, the one dtype the kernel takes), and
  under 'pallas_layer' in inference and in training (its backward
  recomputes the layer in plain PyTorch, as the reference's does in XLA),
  whenever the adapters take a LayerNorm on their input, are not
  per-projection (q/k/v/out) adapters, and no attention probabilities are
  asked for (``whole_layer_route``);
- otherwise the discrete path (training forwards but under 'pallas_layer',
  attention maps, q/k/v/out adapters): separate LayerNorm, attention, MLP
  and adapter modules, where
  ``fused_ln='pallas'`` runs LN1 -> q|k|v and LN2 -> fc1 through
  ``ops.fused_ln.ln_matmul`` (not in a layer with q/k/v/out adapters, which
  read the normalized input, as in the reference) and
  ``attention_impl='pallas'`` runs attention through
  ``ops.attention.fused_attention`` (CUDA kernels on the card).

The tower also takes per-layer position prompts on its trailing tokens
(``vpt_tokens``) and, with ``remat``, recomputes each layer's activations in
the backward (``torch.utils.checkpoint``; a whole-layer forward recomputes
in its own backward already and takes no checkpoint).

The CUDA kernels take bfloat16 only: on the card the explicit kernel
settings at another compute dtype raise when the model is built
(``check_kernel_dtype``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.models.layers import (dense, empty_linear,
                                                 layer_norm, linear, normal_)
from concepthash_tpu_torch.ops.attention import attention
from concepthash_tpu_torch.ops.fused_layer import (AdapterWeights,
                                                   LayerWeights, activation,
                                                   encoder_layer)
from concepthash_tpu_torch.ops.fused_ln import ln_matmul, resolve_fused_ln


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    patch_bias: bool = False
    use_pre_layernorm: bool = True
    attention_impl: str = "auto"  # 'auto' | 'pallas' | 'xla' (ops/attention.py)
    fused_ln: str = "auto"        # 'auto' | 'pallas' | 'pallas_mlp' | 'xla' |
                                  # 'pallas_layer' (ops/fused_ln.py)
    remat: bool = False           # recompute encoder layers in the backward

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1


# the settings that ask for the CUDA kernels by name
_KERNEL_FUSED_LN = ("pallas", "pallas_mlp", "pallas_layer")


def whole_layer_route(fused_ln: str, train: bool, fusable: bool,
                      dtype: torch.dtype, device_type: str) -> bool:
    """Whether an encoder layer's forward takes the whole-layer function
    (``ops.fused_layer.encoder_layer``) rather than the discrete path.
    'pallas_layer' asks for it, in inference and in training (the backward
    of ``ops.fused_layer.EncoderLayerFn`` recomputes the layer from its
    inputs). 'auto' takes it for inference forwards: on the card at bfloat16
    only, the one dtype its kernel takes, and the discrete path computes the
    same layer at any other; on the CPU its plain version at any dtype, as
    the tests hold it against the reference. A layer whose adapters take no
    LayerNorm on their input, or that carries q/k/v/out adapters
    (``fusable`` False), never takes it."""
    if not fusable:
        return False
    if fused_ln == "pallas_layer":
        return True
    if fused_ln != "auto" or train:
        return False
    return device_type != "cuda" or dtype == torch.bfloat16


def check_kernel_dtype(cfg: "ClipVisionConfig", dtype: torch.dtype,
                       device_type: str) -> None:
    """Raise for a setting that asks for the CUDA kernels by name
    (``fused_ln`` 'pallas', 'pallas_mlp' or 'pallas_layer', or
    ``attention_impl='pallas'``) at a compute dtype other than bfloat16 on
    the card: the kernels take bfloat16 only. On the CPU every setting runs
    the kernels' plain versions, at any dtype."""
    if device_type != "cuda" or dtype == torch.bfloat16:
        return
    asked = []
    if cfg.fused_ln in _KERNEL_FUSED_LN:
        asked.append(f"fused_ln={cfg.fused_ln!r}")
    if cfg.attention_impl == "pallas":
        asked.append("attention_impl='pallas'")
    if asked:
        raise ValueError(
            f"{' and '.join(asked)} runs the port's CUDA kernels, which take "
            f"bfloat16 only, but the compute dtype is {dtype} on cuda: build "
            f"the model with dtype=torch.bfloat16, or use 'auto' or 'xla'")


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """Bottleneck adapters added in parallel to the attention and MLP branch
    outputs; ``attention_qkvo`` puts one on each of the q, k, v and out
    projections' inputs instead (and none after attention or the MLP)."""

    bottleneck_dim: int = 384
    after_attention: bool = True
    after_mlp: bool = True
    layernorm_in: bool = True
    attention_qkvo: bool = False


class Adapter(nn.Module):
    """LN in -> down -> exact GELU -> up (zero-init) -> learnable scale."""

    def __init__(self, cfg: AdapterConfig, dim: int, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.ln = nn.LayerNorm(dim, eps=1e-5) if cfg.layernorm_in else None
        self.down = linear(dim, cfg.bottleneck_dim, generator=generator)
        self.up = linear(cfg.bottleneck_dim, dim, zero=True)
        self.scale = nn.Parameter(torch.ones(1))

    def weights(self, dtype: torch.dtype) -> AdapterWeights:
        return AdapterWeights(self.ln.weight, self.ln.bias, self.down.weight,
                              self.down.bias, self.up.weight, self.up.bias,
                              self.scale).cast(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ln is not None:
            x = layer_norm(self.ln, x, self.dtype)
        h = F.gelu(dense(self.down, x, self.dtype))
        h = dense(self.up, h, self.dtype)
        return h * self.scale.to(self.dtype)


class PatchEmbedding(nn.Module):
    """Patch projection: (B, P, p*p*C) @ kernel.reshape(p*p*C, D)."""

    def __init__(self, features: int, patch_size: int, in_channels: int = 3,
                 use_bias: bool = False, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        fan_in = patch_size * patch_size * in_channels
        self.weight = nn.Parameter(normal_(
            torch.empty(patch_size, patch_size, in_channels, features),
            1.0 / math.sqrt(fan_in), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(-1, self.weight.shape[-1]).to(self.dtype)
        out = patches.to(self.dtype) @ w
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


class MultiHeadAttention(nn.Module):
    """CLIP-style attention with biased q|k|v and out projections (q, k, v
    concatenated into one (3D, D) weight). Returns (out, probs or None).

    ``attention_impl``: 'pallas' runs ``ops.attention.fused_attention`` (the
    kernel), 'xla' and 'auto' the einsum path, which attention maps always
    take. ``ln``: the preceding LayerNorm module; when given, x is not
    normalized yet and q|k|v come from one ``ln_matmul`` (the fused
    LN -> matmul kernel). ``adapters`` (q/k/v/out adapters, an
    ``AdapterConfig`` with ``attention_qkvo``): each projection's output
    gains a parallel adapter of that projection's input."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 generator=None, attention_impl: str = "auto",
                 adapters: Optional["AdapterConfig"] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.qkv_proj = empty_linear(dim, 3 * dim)
        with torch.no_grad():
            normal_(self.qkv_proj.weight, 1.0 / math.sqrt(dim), generator)
            self.qkv_proj.bias.zero_()
        self.out_proj = linear(dim, dim, generator=generator)
        self.qkvo = adapters is not None
        if self.qkvo:
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(self, f"adapter_{name}",
                        Adapter(adapters, dim, dtype, generator))

    def forward(self, x: torch.Tensor, output_attentions: bool = False,
                ln: Optional[nn.LayerNorm] = None):
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        if ln is not None:
            qkv = ln_matmul(x, ln.weight, ln.bias,
                            self.qkv_proj.weight.to(self.dtype),
                            self.qkv_proj.bias, eps=ln.eps, impl="pallas")
        else:
            qkv = dense(self.qkv_proj, x, self.dtype)
        if self.qkvo:
            qkv = qkv + torch.cat([self.adapter_q_proj(x),
                                   self.adapter_k_proj(x),
                                   self.adapter_v_proj(x)], dim=-1)
        # views of qkv: the kernel reads them in place
        q, k, v = (t.reshape(B, L, H, hd) for t in qkv.split(D, -1))
        probs = None
        if output_attentions or self.attention_impl != "pallas":
            logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
            probs = torch.softmax(logits.float(), dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, D)
        else:
            out = attention(q, k, v, impl="pallas").reshape(B, L, D)
        h = dense(self.out_proj, out, self.dtype)
        if self.qkvo:
            h = h + self.adapter_out_proj(out)
        return h, (probs if output_attentions else None)


class EncoderLayer(nn.Module):
    """Pre-LN transformer block with optional parallel adapters:
    x = residual + branch(ln(x)) + adapter(branch(ln(x)))."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 eps: float = 1e-5, act: str = "quick_gelu",
                 adapters: Optional[AdapterConfig] = None,
                 dtype=torch.float32, generator=None,
                 attention_impl: str = "auto", fused_ln: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.act = act
        self.dtype = dtype
        self.fused_ln = fused_ln
        # q/k/v/out adapters read the normalized input: no fusion there
        self.qkvo = adapters is not None and adapters.attention_qkvo
        self.fusable = adapters is None or (adapters.layernorm_in
                                            and not self.qkvo)
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.self_attn = MultiHeadAttention(
            dim, num_heads, dtype, generator, attention_impl,
            adapters if self.qkvo else None)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = linear(dim, intermediate_size, generator=generator)
        self.fc2 = linear(intermediate_size, dim, generator=generator)
        branch = adapters is not None and not self.qkvo
        self.adapter_attn = (Adapter(adapters, dim, dtype, generator)
                             if branch and adapters.after_attention else None)
        self.adapter_mlp = (Adapter(adapters, dim, dtype, generator)
                            if branch and adapters.after_mlp else None)

    def layer_weights(self, dtype: torch.dtype) -> LayerWeights:
        a = self.self_attn
        return LayerWeights(
            self.layer_norm1.weight, self.layer_norm1.bias,
            a.qkv_proj.weight, a.qkv_proj.bias, a.out_proj.weight,
            a.out_proj.bias, self.layer_norm2.weight, self.layer_norm2.bias,
            self.fc1.weight, self.fc1.bias, self.fc2.weight,
            self.fc2.bias).cast(dtype)

    def takes_whole_layer(self, train: bool, device_type: str,
                          output_attentions: bool = False) -> bool:
        """Whether this forward goes through ``encoder_layer`` (see
        ``whole_layer_route``); attention maps take the discrete path."""
        return not output_attentions and whole_layer_route(
            self.fused_ln, train, self.fusable, self.dtype, device_type)

    def forward(self, x: torch.Tensor, output_attentions: bool = False,
                train: bool = False):
        if self.takes_whole_layer(train, x.device.type, output_attentions):
            out = encoder_layer(
                x, self.layer_weights(self.dtype), num_heads=self.num_heads,
                eps=self.eps, act=self.act,
                adapter_attn=(self.adapter_attn.weights(self.dtype)
                              if self.adapter_attn is not None else None),
                adapter_mlp=(self.adapter_mlp.weights(self.dtype)
                             if self.adapter_mlp is not None else None))
            return out, None
        fused = resolve_fused_ln(self.fused_ln) and not self.qkvo
        if fused and self.fused_ln != "pallas_mlp":
            h, probs = self.self_attn(x, output_attentions,
                                      ln=self.layer_norm1)
        else:
            h, probs = self.self_attn(
                layer_norm(self.layer_norm1, x, self.dtype), output_attentions)
        if self.adapter_attn is not None:
            h = h + self.adapter_attn(h)
        x = x + h
        if fused:
            ln2 = self.layer_norm2
            h = ln_matmul(x, ln2.weight, ln2.bias, self.fc1.weight.to(self.dtype),
                          self.fc1.bias, eps=ln2.eps, impl="pallas")
        else:
            h = dense(self.fc1, layer_norm(self.layer_norm2, x, self.dtype),
                      self.dtype)
        h = dense(self.fc2, activation(self.act, h), self.dtype)
        if self.adapter_mlp is not None:
            h = h + self.adapter_mlp(h)
        return x + h, probs


def _torch_bicubic_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """(n_out, n_in) matrix replaying torch F.interpolate(mode='bicubic',
    align_corners=False): cubic kernel a=-0.75, source coordinate
    (i+0.5)/scale - 0.5, edge clamping."""
    a = -0.75

    def w(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2:
            return a * (x ** 3 - 5 * x ** 2 + 8 * x - 4)
        return 0.0

    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        c = (i + 0.5) / scale - 0.5
        i0 = math.floor(c)
        t = c - i0
        for k, dx in zip((i0 - 1, i0, i0 + 1, i0 + 2),
                         (1 + t, t, 1 - t, 2 - t)):
            m[i, min(max(k, 0), n_in - 1)] += w(dx)
    return m.astype(np.float32)


def resize_position_embedding(pos: torch.Tensor,
                              num_patches: int) -> torch.Tensor:
    """Bicubic-resize the grid part of a (1+N, D) position embedding to a new
    patch count, with the (side_new + 0.1) / side_old scale of the
    reference."""
    n_old = pos.shape[0] - 1
    if n_old == num_patches:
        return pos
    side_old = int(math.sqrt(n_old))
    side_new = int(math.sqrt(num_patches))
    scale = (side_new + 0.1) / side_old
    m = torch.from_numpy(_torch_bicubic_matrix(side_old, side_new, scale)).to(
        pos.device)
    grid = pos[1:].reshape(side_old, side_old, -1).float()
    grid = torch.einsum("oi,ijd->ojd", m, grid)
    grid = torch.einsum("pj,ojd->opd", m, grid).to(pos.dtype)
    return torch.cat([pos[:1], grid.reshape(side_new * side_new, -1)])


class ClipVisionTower(nn.Module):
    """CLIP vision transformer over NHWC pixels, with extra (concept) tokens
    appended after the patch sequence. Returns a dict: last_hidden_state
    (B, L[+M], D), pooled (B, proj), cls_prenorm, cls_postnorm, and
    attentions when asked.

    ``vpt_tokens`` T > 0: before every encoder layer, a learned position
    prompt ``vpt_pe[i]`` (1, T, D) is added to the last T positions.
    ``cfg.remat``: in a forward that records gradients and asks for no
    attention maps, each encoder layer on the discrete path runs under
    ``torch.utils.checkpoint`` (non-reentrant), its activations recomputed
    in the backward; the layers draw no random numbers, so no generator
    state is saved (a CUDA graph captures it as it is). A layer on the
    whole-layer route runs as it is: ``EncoderLayerFn`` saves only its
    inputs and recomputes in its backward, so a checkpoint would only run
    its forward, and the kernel, a second time."""

    def __init__(self, cfg: ClipVisionConfig,
                 adapters: Optional[AdapterConfig] = None,
                 dtype=torch.float32, generator=None, vpt_tokens: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.vpt_tokens = vpt_tokens
        D = cfg.hidden_size
        self.patch_embedding = PatchEmbedding(D, cfg.patch_size, 3,
                                              cfg.patch_bias, dtype, generator)
        self.class_embedding = nn.Parameter(
            normal_(torch.empty(D), 0.02, generator))
        self.position_embedding = nn.Parameter(
            normal_(torch.empty(cfg.seq_len, D), 0.02, generator))
        self.pre_layernorm = (nn.LayerNorm(D, eps=cfg.layer_norm_eps)
                              if cfg.use_pre_layernorm else None)
        self.layers = nn.ModuleList(
            EncoderLayer(D, cfg.num_heads, cfg.intermediate_size,
                         cfg.layer_norm_eps, cfg.hidden_act, adapters, dtype,
                         generator, cfg.attention_impl, cfg.fused_ln)
            for _ in range(cfg.num_layers))
        self.vpt_pe = (nn.ParameterList(
            nn.Parameter(normal_(torch.empty(1, vpt_tokens, D), 0.02,
                                 generator))
            for _ in range(cfg.num_layers)) if vpt_tokens else None)
        self.post_layernorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.visual_projection = linear(D, cfg.projection_dim, bias=False,
                                        generator=generator)

    def forward(self, pixel_values: torch.Tensor,
                extra_tokens: Optional[torch.Tensor] = None,
                output_attentions: bool = False,
                project_extra: bool = False, train: bool = False) -> dict:
        c = self.cfg
        dt = self.dtype
        B, Hh, Ww, C = pixel_values.shape
        p = c.patch_size
        gh, gw = Hh // p, Ww // p
        patches = pixel_values.to(dt).reshape(B, gh, p, gw, p, C)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
            B, gh * gw, p * p * C)
        x = self.patch_embedding(patches)
        cls = self.class_embedding.to(dt).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = resize_position_embedding(self.position_embedding, gh * gw)
        x = x + pos.to(dt)[None]
        if extra_tokens is not None:
            x = torch.cat([x, extra_tokens.to(dt)], dim=1)
        if self.pre_layernorm is not None:
            x = layer_norm(self.pre_layernorm, x, dt)
        attns = []
        remat = (c.remat and not output_attentions
                 and torch.is_grad_enabled())
        T = self.vpt_tokens
        for i, layer in enumerate(self.layers):
            if T:
                x = torch.cat([x[:, :-T], x[:, -T:] + self.vpt_pe[i].to(dt)],
                              dim=1)
            if remat and not layer.takes_whole_layer(train, x.device.type):
                x, probs = checkpoint(layer, x, False, train,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                x, probs = layer(x, output_attentions, train)
            if output_attentions:
                attns.append(probs)
        cls_out = x[:, 0, :]
        cls_postnorm = layer_norm(self.post_layernorm, cls_out, dt)
        out = {"last_hidden_state": x,
               "pooled": dense(self.visual_projection, cls_postnorm, dt),
               "cls_prenorm": cls_out, "cls_postnorm": cls_postnorm}
        if project_extra and extra_tokens is not None:
            n_extra = extra_tokens.shape[1]
            out["extra_projected"] = dense(
                self.visual_projection,
                layer_norm(self.post_layernorm, x[:, -n_extra:, :], dt), dt)
        if output_attentions:
            out["attentions"] = tuple(attns)
        return out


# ---------------------------------------------------------------------------
# the CLIP text tower (the language-guided codebook)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 12
    num_heads: int = 8
    max_position_embeddings: int = 77
    vocab_size: int = 49408
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407


class _CausalEncoderLayer(nn.Module):
    """Pre-LN causal transformer block with separate q, k, v projections;
    masked logits take float32's most negative value and the softmax runs
    in float32."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 eps: float, act: str, dtype=torch.float32, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.act = act
        self.dtype = dtype
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.q_proj = linear(dim, dim, generator=generator)
        self.k_proj = linear(dim, dim, generator=generator)
        self.v_proj = linear(dim, dim, generator=generator)
        self.out_proj = linear(dim, dim, generator=generator)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = linear(dim, intermediate_size, generator=generator)
        self.fc2 = linear(intermediate_size, dim, generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H, dt = self.num_heads, self.dtype
        hd = D // H
        h = layer_norm(self.layer_norm1, x, dt)
        q, k, v = (dense(p, h, dt).reshape(B, L, H, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k).float()
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(dt)
        h = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, D)
        x = x + dense(self.out_proj, h, dt)
        h = dense(self.fc1, layer_norm(self.layer_norm2, x, dt), dt)
        return x + dense(self.fc2, activation(self.act, h), dt)


class ClipTextTower(nn.Module):
    """CLIP text transformer. ``forward(input_ids=...)`` pools the hidden
    state at each row's first eos token (position 0 in a row without one);
    ``forward(inputs_embeds=...)`` takes embeddings as token embeddings
    (through ``embeds_adapter`` when their width ``embeds_dim`` differs from
    the tower's), keeps the position embedding and the causal mask, and
    pools the last position. Returns last_hidden_state, pooled (before the
    projection) and text_embeds.

    Parameters are float32 on ``device`` (CUDA unless asked otherwise);
    ``dtype`` is the compute dtype. Initial values come from ``generator``
    (a CPU ``torch.Generator``)."""

    def __init__(self, cfg: ClipTextConfig, *,
                 embeds_dim: Optional[int] = None, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.hidden_size
        self.token_embedding = nn.Parameter(
            normal_(torch.empty(cfg.vocab_size, D), 0.02, generator))
        self.position_embedding = nn.Parameter(
            normal_(torch.empty(cfg.max_position_embeddings, D), 0.02,
                    generator))
        self.embeds_adapter = (linear(embeds_dim, D, generator=generator)
                               if embeds_dim not in (None, D) else None)
        self.layers = nn.ModuleList(
            _CausalEncoderLayer(D, cfg.num_heads, cfg.intermediate_size,
                                cfg.layer_norm_eps, cfg.hidden_act, dtype,
                                generator)
            for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.text_projection = linear(D, cfg.projection_dim, bias=False,
                                      generator=generator)
        self.to(dev)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None) -> dict:
        c, dt = self.cfg, self.dtype
        if inputs_embeds is not None:
            B, L = inputs_embeds.shape[:2]
            emb = (dense(self.embeds_adapter, inputs_embeds, dt)
                   if self.embeds_adapter is not None
                   else inputs_embeds.to(dt))
        else:
            B, L = input_ids.shape
            emb = self.token_embedding[input_ids].to(dt)
        x = emb + self.position_embedding[:L].to(dt)[None]
        mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        for layer in self.layers:
            x = layer(x, mask)
        x = layer_norm(self.final_layer_norm, x, dt)
        if input_ids is not None:
            eos = (input_ids == c.eos_token_id).to(torch.int32).argmax(dim=-1)
        else:
            eos = torch.full((B,), L - 1, dtype=torch.long, device=x.device)
        pooled = x[torch.arange(B, device=x.device), eos]
        return {"last_hidden_state": x, "pooled": pooled,
                "text_embeds": dense(self.text_projection, pooled, dt)}
