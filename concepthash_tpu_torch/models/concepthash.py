"""ConceptHash, the flagship model, inference and training forward
(counterpart of concepthash_tpu/models/concepthash.py).

M learnable concept queries are refined by one self-attention block,
projected into the vision width, appended to the CLIP patch sequence and
contextualized by the adapter-tuned encoder; each concept's output token maps
to an nbit/M sub-code; the sub-codes concatenate and batch-normalize into the
code. Class centers are fixed language embeddings (the ``center`` buffer,
``constants/center`` in the reference) projected by the ``text_projection``
MLP.

Ported: the canonical configuration (configs/model/concepthash.yaml) — multi
hash queries, hash_pe, concat ensemble, BatchNorm on codes, fixed centers,
CosSim concept classifier, use_before_projection — plus the mean ensemble,
registers and the learnable-center fallback; ``train=True`` (dropout in the
hash-query block from an explicit generator, batch statistics in the code
BatchNorm). Not ported yet, and raising ``NotImplementedError``:
SelfAttentionAtLast, DecorrelatedBN (add_bn='dbn'), FILIP token embeddings
and vpt_pe.
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
                                                 dense, dropout, layer_norm,
                                                 linear, normal_)
from concepthash_tpu_torch.ops.numerics import l2_normalize


@dataclasses.dataclass(frozen=True)
class ConceptHashConfig:
    nbit: int = 64
    nclass: int = 200
    ncontext: int = 4                  # M concept tokens
    nregs: int = 0                     # extra register tokens (ignored by head)
    num_heads: int = 8                 # hash-query self-attention heads
    dropout: float = 0.1
    add_bn: object = True              # True | False ('dbn' is not ported)
    use_before_projection: bool = True
    hash_pe: bool = True
    ensemble_method: str = "concat"    # 'concat' | 'avg'
    concept_reg: bool = True
    concept_cossim: bool = True
    vpt_pe: bool = False
    learnable_center: bool = False
    text_projection_dims: tuple = (512, 512)  # hidden dims; final = nbit
    center_dim: int = 512
    self_attn_at_last: Optional[object] = None


def _unported(cfg: ConceptHashConfig) -> Optional[str]:
    if cfg.self_attn_at_last is not None:
        return "self_attn_at_last (SelfAttentionAtLast)"
    if cfg.add_bn == "dbn":
        return "add_bn='dbn' (DecorrelatedBN)"
    if cfg.vpt_pe:
        return "vpt_pe"
    if not cfg.use_before_projection:
        return "use_before_projection=False"
    return None


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
        h = dense(self.ffn_fc2, dropout(h, rate, generator), dt)
        x = layer_norm(self.norm2, x, dt) + h
        return dense(self.ffn2, x, dt)


class ConceptHash(nn.Module):
    """ConceptHash over NHWC images (normalized float). ``forward`` returns
    codes (B, nbit) f32, logits_cont and logits_bin (B, nclass),
    hash_features (B, M, D), logits_concept (M, B, nclass) when concept_reg,
    ensemble_codes for the mean ensemble, and attn_cache when attention maps
    are asked for.

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
        missing = _unported(cfg)
        if token_embeds is not None:
            missing = "token_embeds (FILIP token-level logits)"
        if missing:
            raise NotImplementedError(f"{missing} is not ported yet "
                                      "(ROADMAP Queue 1 item 7)")
        self.vision_cfg = vision_cfg
        self.cfg = cfg
        self.dtype = dtype
        g = generator
        M = cfg.ncontext
        embed_dim = vision_cfg.projection_dim
        D = vision_cfg.hidden_size
        self.hash_queries = nn.Parameter(
            normal_(torch.empty(1, M + cfg.nregs, embed_dim), 1.0, g))
        self.hash_attention = HashQueryBlock(embed_dim, D, cfg.num_heads,
                                             dtype, g, cfg.dropout)
        self.backbone = ClipVisionTower(vision_cfg, adapters, dtype, g)
        if cfg.hash_pe:
            self.hash_pe = nn.Parameter(normal_(torch.empty(1, M, D), 1.0, g))
        sub_dim = cfg.nbit // M if cfg.ensemble_method == "concat" else cfg.nbit
        self.hash_fc = linear(D, sub_dim, bias=False, generator=g)
        self.hash_bn = CodeBatchNorm(cfg.nbit, dtype) if cfg.add_bn else None
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
                normal_(torch.empty(1, M, D), 0.02, g))
            if cfg.concept_cossim:
                self.concept_ce = CosSim(D, cfg.nclass, dtype, g)
            else:
                self.concept_ce = linear(D, cfg.nclass, bias=False,
                                         generator=g)
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
        enc = self.backbone(images, extra_tokens=ctx,
                            output_attentions=output_attentions, train=train)
        last = enc["last_hidden_state"]
        concept_tokens = (last[:, -(M + c.nregs):-c.nregs, :] if c.nregs
                          else last[:, -M:, :])
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
            feats = (concept_tokens + self.concept_pe.to(dt)).reshape(B * M, D)
            if c.concept_cossim:
                logits = self.concept_ce(feats)
            else:
                logits = dense(self.concept_ce, feats, dt).float()
            out["logits_concept"] = logits.reshape(B, M, c.nclass).transpose(0, 1)
        if output_attentions:
            out["attn_cache"] = enc["attentions"]
        return out
