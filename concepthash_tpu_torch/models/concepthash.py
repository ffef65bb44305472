"""ConceptHash, the flagship model, inference and training forward
(counterpart of concepthash_tpu/models/concepthash.py).

M learnable concept queries are refined by one self-attention block,
projected into the vision width, appended to the CLIP patch sequence and
contextualized by the adapter-tuned encoder; each concept's output token maps
to an nbit/M sub-code; the sub-codes concatenate and batch-normalize into the
code. Class centers are fixed language embeddings (the ``center`` buffer,
``constants/center`` in the reference) projected by the ``text_projection``
MLP.

Every option of the reference: the canonical configuration
(configs/model/concepthash.yaml) — multi hash queries, hash_pe, concat
ensemble, BatchNorm on codes, fixed centers, CosSim concept classifier,
use_before_projection — and the mean ensemble, registers, the
learnable-center fallback, the decorrelated code BatchNorm
(``add_bn='dbn'``), per-layer prompts on the concept tokens (``vpt_pe``),
sub-codes from the projected concept tokens (``use_before_projection``
False), the SelfAttention-at-last layer with Gaussian masking
(``self_attn_at_last``, configs/model/concepthash_sa.yaml) and FILIP's
token-level logits against fixed class-text token embeddings
(``token_embeds``, configs/model/concepthash_filip.yaml); ``train=True``
(dropout in the hash-query block from an explicit generator, batch
statistics in the code BatchNorm).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                               ClipVisionConfig,
                                               ClipVisionTower,
                                               check_kernel_dtype)
from concepthash_tpu_torch.models.layers import (MLP, CodeBatchNorm, CosSim,
                                                 DecorrelatedBN, dense,
                                                 dropout, layer_norm, linear,
                                                 normal_)
from concepthash_tpu_torch.ops.numerics import l2_normalize


@dataclasses.dataclass(frozen=True)
class SelfAttnLastConfig:
    """The optional last-layer SelfAttention with Gaussian attention
    masking (``model.self_attn_at_last``)."""

    params: bool = True            # learned q/k/v (False: identity)
    strong: bool = False           # q/k/v = Linear-LN-ReLU-Linear stacks
    mask_sigma: float = 0.0        # 0: no Gaussian masking
    cross_attention: bool = False  # concept -> patch region only, rest zero
    differentiable: bool = False   # soft-argmax centre instead of argmax
    add_pe: bool = False           # learned PE on the concept tokens


class SelfAttentionAtLast(nn.Module):
    """Single-head self-attention over the whole [cls; patches; concepts]
    sequence whose concept -> patch block is refocused by a Gaussian bump
    centred on each concept's attention argmax; returns (attn (B, 1, L, L)
    float32, tokens (B, L, D)).

    As in the reference (its documented deviations from the original
    code): the bump is centred at the true argmax (row y, column x), and
    ``differentiable`` centres it at the softmax expectation of the
    location. ``ncontext`` is the count of trailing tokens (concepts and
    registers); the patches between the cls token and them must form a
    square grid when ``mask_sigma`` is set. flax LayerNorm's eps 1e-6 in
    the ``strong`` stacks."""

    def __init__(self, cfg: SelfAttnLastConfig, ncontext: int, dim: int,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.cfg, self.ncontext = cfg, ncontext
        self.dim, self.dtype = dim, dtype
        if cfg.params:
            for n in ("q", "k", "v"):
                if cfg.strong:
                    setattr(self, f"{n}_1", linear(dim, dim, bias=False,
                                                   generator=generator))
                    setattr(self, f"{n}_ln", nn.LayerNorm(dim, eps=1e-6))
                    setattr(self, f"{n}_2", linear(dim, dim, bias=False,
                                                   generator=generator))
                else:
                    setattr(self, n, linear(dim, dim, bias=False,
                                            generator=generator))
        if cfg.add_pe:
            self.pe = nn.Parameter(normal_(torch.empty(1, ncontext, dim), 1.0,
                                           generator))

    def _qkv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if not self.cfg.params:
            return x
        if self.cfg.strong:
            h = dense(getattr(self, f"{name}_1"), x, dt)
            h = layer_norm(getattr(self, f"{name}_ln"), h, dt)
            return dense(getattr(self, f"{name}_2"), F.relu(h), dt)
        return dense(getattr(self, name), x, dt)

    def _gaussian_mask(self, region: torch.Tensor) -> torch.Tensor:
        """region: (B, M, P) concept -> patch attention, P a square."""
        B, M, P = region.shape
        H = int(round(P ** 0.5))
        if H * H != P:
            raise ValueError(f"the Gaussian mask needs a square patch grid, "
                             f"got {P} patch tokens")
        grid = region.reshape(B, M, H, H)
        ys = torch.arange(H, dtype=torch.float32, device=region.device)
        if self.cfg.differentiable:
            w = torch.softmax(region.float(), dim=-1).reshape(B, M, H, H)
            max_y = (w.sum(3) * ys).sum(2)                       # (B, M)
            max_x = (w.sum(2) * ys).sum(2)
        else:
            loc = region.argmax(dim=-1)                          # (B, M)
            max_y = torch.div(loc, H, rounding_mode="floor").float()
            max_x = (loc % H).float()
        yy = ys.reshape(1, 1, H, 1)
        xx = ys.reshape(1, 1, 1, H)
        bump = torch.exp(-((xx - max_x[:, :, None, None]) ** 2
                           + (yy - max_y[:, :, None, None]) ** 2)
                         / (2.0 * self.cfg.mask_sigma ** 2))
        bump = bump / (bump.reshape(B, M, -1).amax(dim=-1)[:, :, None, None]
                       + 1e-12)
        return (grid * bump).reshape(B, M, P)

    def forward(self, x: torch.Tensor):
        c, M = self.cfg, self.ncontext
        if c.add_pe:
            x = torch.cat([x[:, :-M], x[:, -M:] + self.pe.to(x.dtype)], dim=1)
        q, k, v = (self._qkv(n, x) for n in ("q", "k", "v"))
        scale = self.dim ** -0.5
        attn = torch.einsum("bld,bmd->blm", q, k).float()
        L = attn.shape[1]
        if c.cross_attention:
            region = torch.softmax(attn[:, -M:, 1:L - M] * scale, dim=-1)
            if c.mask_sigma != 0:
                region = self._gaussian_mask(region)
            attn = F.pad(region, (1, M, L - M, 0))
        else:
            if c.mask_sigma != 0:
                masked = self._gaussian_mask(attn[:, -M:, 1:L - M])
                attn = torch.cat([
                    attn[:, :L - M],
                    torch.cat([attn[:, -M:, :1], masked, attn[:, -M:, L - M:]],
                              dim=2)], dim=1)
            attn = torch.softmax(attn * scale, dim=-1)
        out = torch.einsum("blm,bmd->bld", attn.to(v.dtype), v)
        return attn[:, None], out


@dataclasses.dataclass(frozen=True)
class ConceptHashConfig:
    nbit: int = 64
    nclass: int = 200
    ncontext: int = 4                  # M concept tokens
    nregs: int = 0                     # extra register tokens (ignored by head)
    num_heads: int = 8                 # hash-query self-attention heads
    dropout: float = 0.1
    add_bn: object = True              # True | False | 'dbn'
    use_before_projection: bool = True
    hash_pe: bool = True
    ensemble_method: str = "concat"    # 'concat' | 'avg'
    concept_reg: bool = True
    concept_cossim: bool = True
    vpt_pe: bool = False
    learnable_center: bool = False
    text_projection_dims: tuple = (512, 512)  # hidden dims; final = nbit
    center_dim: int = 512
    self_attn_at_last: Optional[SelfAttnLastConfig] = None


class _DotProductAttention(nn.Module):
    """flax MultiHeadDotProductAttention (self-attention, biased q/k/v/out,
    1/sqrt(head_dim) scaling) as four Linear layers."""

    def __init__(self, dim: int, num_heads: int, dtype, generator):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = linear(dim, dim, generator=generator)
        self.key = linear(dim, dim, generator=generator)
        self.value = linear(dim, dim, generator=generator)
        self.out = linear(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        q, k, v = (dense(m, x, self.dtype).reshape(B, L, H, hd)
                   for m in (self.query, self.key, self.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(hd), k)
        w = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        # flax drops the weights with one mask over batch and heads
        w = dropout(w, dropout_rate, generator, broadcast_dims=(0, 1))
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, D)
        return dense(self.out, o, self.dtype)


class HashQueryBlock(nn.Module):
    """One self-attention block refining the hash queries, then a projection
    into the vision width: x = norm1(x) + sa(x); x = norm2(x) + ffn(x);
    return ffn2(x). flax LayerNorm's eps 1e-6. In training, dropout at
    ``dropout`` on the attention weights and after the ffn's ReLU, drawn
    from ``generator``."""

    def __init__(self, embed_dim: int, vision_dim: int, num_heads: int,
                 dtype=torch.float32, generator=None, dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.sa = _DotProductAttention(embed_dim, num_heads, dtype, generator)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ffn_fc1 = linear(embed_dim, embed_dim, generator=generator)
        self.ffn_fc2 = linear(embed_dim, embed_dim, generator=generator)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ffn2 = linear(embed_dim, vision_dim, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        rate = self.dropout if train else 0.0
        x = layer_norm(self.norm1, x, dt) + self.sa(x, rate, generator)
        h = F.relu(dense(self.ffn_fc1, x, dt))
        # the hash queries carry no batch axis: one mask on every rank
        h = dense(self.ffn_fc2, dropout(h, rate, generator, batched=False),
                  dt)
        x = layer_norm(self.norm2, x, dt) + h
        return dense(self.ffn2, x, dt)


class ConceptHash(nn.Module):
    """ConceptHash over NHWC images (normalized float). ``forward`` returns
    codes (B, nbit) f32, logits_cont and logits_bin (B, nclass),
    hash_features (B, M, F) (F the vision width, or the projection width
    when ``use_before_projection`` is False), logits_concept (M, B, nclass)
    when concept_reg, ensemble_codes for the mean ensemble, logits_filip,
    logits_filip_i2t and logits_filip_t2i (B, nclass) f32 with
    ``token_embeds``, and attn_cache when attention maps are asked for (the
    tower's per-layer maps, then SelfAttentionAtLast's (B, 1, L, L) when it
    is on).

    ``token_embeds`` (nclass, T, projection width) are FILIP's class-text
    token embeddings, kept as the float32 ``token_embeds`` buffer.
    Parameters are float32 and live on ``device`` (CUDA unless asked
    otherwise; raises without CUDA); ``dtype`` is the compute dtype
    (bfloat16 on the card). Initial values come from ``generator`` (a CPU
    ``torch.Generator``), then move to the device."""

    def __init__(self, vision_cfg: ClipVisionConfig, cfg: ConceptHashConfig,
                 adapters: Optional[AdapterConfig] = AdapterConfig(), *,
                 fixed_center: Optional[torch.Tensor] = None,
                 token_embeds: Optional[torch.Tensor] = None,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        check_kernel_dtype(vision_cfg, dtype, dev.type)
        if cfg.self_attn_at_last is not None and not cfg.use_before_projection:
            raise ValueError(
                "self_attn_at_last composes with use_before_projection=True "
                "(the reference's own usage); projecting the re-attended "
                "tokens is not wired")
        self.vision_cfg = vision_cfg
        self.cfg = cfg
        self.dtype = dtype
        g = generator
        M = cfg.ncontext
        T = M + cfg.nregs
        embed_dim = vision_cfg.projection_dim
        D = vision_cfg.hidden_size
        # the sub-codes' input width: the tower's, or the projection's
        feat = D if cfg.use_before_projection else embed_dim
        self.hash_queries = nn.Parameter(
            normal_(torch.empty(1, T, embed_dim), 1.0, g))
        self.hash_attention = HashQueryBlock(embed_dim, D, cfg.num_heads,
                                             dtype, g, cfg.dropout)
        self.backbone = ClipVisionTower(vision_cfg, adapters, dtype, g,
                                        vpt_tokens=T if cfg.vpt_pe else 0)
        self.self_attn_at_last = (
            SelfAttentionAtLast(cfg.self_attn_at_last, T, D, dtype, g)
            if cfg.self_attn_at_last is not None else None)
        if cfg.hash_pe:
            self.hash_pe = nn.Parameter(normal_(torch.empty(1, M, feat), 1.0,
                                                g))
        sub_dim = cfg.nbit // M if cfg.ensemble_method == "concat" else cfg.nbit
        self.hash_fc = linear(feat, sub_dim, bias=False, generator=g)
        if cfg.add_bn == "dbn":
            self.hash_bn = DecorrelatedBN(cfg.nbit, M, dtype)
        else:
            self.hash_bn = CodeBatchNorm(cfg.nbit, dtype) if cfg.add_bn \
                else None
        if cfg.learnable_center:
            self.center = nn.Parameter(
                normal_(torch.empty(cfg.nclass, cfg.nbit), 0.02, g))
        else:
            center = (fixed_center.float().cpu() if fixed_center is not None
                      else normal_(torch.empty(cfg.nclass, cfg.center_dim),
                                   1.0, g))
            self.register_buffer("center", center.clone())
            self.text_projection = MLP(cfg.center_dim,
                                       (*cfg.text_projection_dims, cfg.nbit),
                                       dtype=dtype, generator=g)
        if cfg.concept_reg:
            self.concept_pe = nn.Parameter(
                normal_(torch.empty(1, M, feat), 0.02, g))
            if cfg.concept_cossim:
                self.concept_ce = CosSim(feat, cfg.nclass, dtype, g)
            else:
                self.concept_ce = linear(feat, cfg.nclass, bias=False,
                                         generator=g)
        if token_embeds is not None:
            self.register_buffer("token_embeds", torch.as_tensor(
                token_embeds, dtype=torch.float32).cpu().clone())
        else:
            self.token_embeds = None
        self.to(dev)

    def forward(self, images: torch.Tensor, train: bool = False,
                output_attentions: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        """``train=True``: dropout in the hash-query block, drawn from
        ``generator`` (a ``torch.Generator`` on the model's device, needed
        when the dropout rate is not 0), and batch statistics in the code
        BatchNorm, whose running statistics it updates."""
        c = self.cfg
        dt = self.dtype
        B = images.shape[0]
        M = c.ncontext
        D = self.vision_cfg.hidden_size
        ctx = self.hash_attention(self.hash_queries.to(dt), train, generator)
        ctx = ctx.expand(B, M + c.nregs, D)
        filip = self.token_embeds is not None
        need_projected = not c.use_before_projection or filip
        enc = self.backbone(images, extra_tokens=ctx,
                            output_attentions=output_attentions,
                            project_extra=need_projected, train=train)

        def concepts(tokens):
            return (tokens[:, -(M + c.nregs):-c.nregs, :] if c.nregs
                    else tokens[:, -M:, :])

        last = enc["last_hidden_state"]
        last_attn = None
        if self.self_attn_at_last is not None:
            last_attn, last = self.self_attn_at_last(last)
        concept_tokens = concepts(last)
        projected = concepts(enc["extra_projected"]) if need_projected \
            else None
        if not c.use_before_projection:
            concept_tokens = projected
        feat = concept_tokens.shape[-1]
        hash_in = (concept_tokens + self.hash_pe.to(dt) if c.hash_pe
                   else concept_tokens)
        sub_codes = dense(self.hash_fc, hash_in, dt)               # (B, M, sub)
        codes = (sub_codes.reshape(B, c.nbit) if c.ensemble_method == "concat"
                 else sub_codes.mean(dim=1))
        if self.hash_bn is not None:
            codes = self.hash_bn(codes, train)
        codes = codes.float()

        if c.learnable_center:
            center = self.center.float()
        else:
            center = self.text_projection(self.center.to(dt)).float()
        codes_n = l2_normalize(codes)
        center_n = l2_normalize(center)
        out = {
            "logits_cont": codes_n @ center_n.t(),
            "logits_bin": codes_n @ (torch.sign(center_n)
                                     / math.sqrt(c.nbit)).t(),
            "codes": codes,
            "hash_features": concept_tokens,
        }
        if c.ensemble_method == "avg":
            out["ensemble_codes"] = sub_codes
        if c.concept_reg:
            feats = (concept_tokens + self.concept_pe.to(dt)).reshape(
                B * M, feat)
            if c.concept_cossim:
                logits = self.concept_ce(feats)
            else:
                logits = dense(self.concept_ce, feats, dt).float()
            out["logits_concept"] = logits.reshape(B, M, c.nclass).transpose(0, 1)
        if output_attentions:
            attns = enc["attentions"]
            if last_attn is not None:
                attns = tuple(attns) + (last_attn,)
            out["attn_cache"] = attns
        if filip:
            # max over text tokens then mean over concepts (i2t), and the
            # other way round (t2i), in float32
            hf = l2_normalize(projected.float())
            tf = l2_normalize(self.token_embeds)
            sim = torch.einsum("bmd,ctd->bcmt", hf, tf)
            i2t = sim.amax(dim=-1).mean(dim=-1)
            t2i = sim.amax(dim=-2).mean(dim=-1)
            out["logits_filip_i2t"] = i2t
            out["logits_filip_t2i"] = t2i
            out["logits_filip"] = 0.5 * (i2t + t2i)
        return out
