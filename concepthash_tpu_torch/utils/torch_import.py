"""Reference (torch) training checkpoints into a port model (counterpart of
concepthash_tpu/utils/torch_import.py, with its scope).

The reference saves ``model.state_dict()`` at
``<logdir>/models/{best,last,epN}.pth``. This module maps those flat keys
onto the port model of the same method and config, so that the imported
model reproduces the reference's forward without retraining:

- CLIP backbones (``backbone.model.vision_model.*`` of the CLIPVision /
  CLIPModel wrappers, ``backbone.vision_model.*`` of the coop CLIP class)
  with the parallel MLP adapters
  (``adapter_params.adapter_{i}_adapt_mlp_{1,2}_*``) and the q/k/v/out
  attention adapters;
- Hugging Face ViT backbones (``backbone.model.embeddings/encoder.*``);
- timm ViT and Swin backbones (``backbone.{cls_token,blocks,layers,...}``)
  through a translation to the Hugging Face layout that splits the fused
  qkv, the port's towers fusing it again;
- torchvision CNN backbones: ResNet-18/34/50/101 with their BatchNorm
  statistics, AlexNet and VGG16 (``models/cnn_loader.py``: the port keeps
  torchvision's names);
- heads: the flat Linear zoo (csq / dpn / pairwise ``hash_fc``; ce /
  greedyhash ``hash_fc`` + ``ce_fc``; orthohash's ``hash_fc`` Sequential of
  a Linear and a BatchNorm, and its CosSim; adsh's Linear with its bias,
  with ``model.hash_bias=true``) and the ConceptHash head.

Not importable, and reported as unused keys: the fine-grained SEMICON and
A2-Net heads, whose port (like the reference's rebuild) is no
module-for-module copy. ``ImportReport.unused`` lists the checkpoint keys
no rule consumed, with a warning, and is not fatal; a tensor whose shape
differs from the model's raises ``ValueError``, a key the model lacks
``KeyError``. Files are read with ``torch.load(weights_only=True)`` unless
the caller passes ``unsafe``.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)


def load_state_dict(path: str, *, unsafe: bool = False) -> Dict[str,
                                                                np.ndarray]:
    """A reference ``.pth`` model checkpoint as {flat key: ndarray}.

    ``weights_only=True``: the reference's checkpoints are plain tensor
    state dicts, and a ``.pth`` from an untrusted source can otherwise run
    arbitrary code when loaded. ``unsafe=True`` (``--unsafe``) retries with
    the full unpickler, for checkpoints you trust."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not unsafe:
            raise RuntimeError(
                f"{path} is not loadable as a plain tensor state_dict "
                f"({e}). If you trust its origin, re-run with --unsafe to "
                "allow full (arbitrary-code) unpickling.") from e
        blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in blob.items()}


class ImportReport:
    """Which checkpoint keys were consumed, which model keys written, and
    which expected ones the checkpoint had no value for."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.used: set = set()
        self.written: list = []
        self.missing: list = []

    def take(self, key: str) -> Optional[np.ndarray]:
        if key in self.sd:
            self.used.add(key)
            return self.sd[key]
        return None

    def require(self, key: str) -> np.ndarray:
        arr = self.take(key)
        if arr is None:
            raise KeyError(f"reference checkpoint is missing key {key!r}")
        return arr

    @property
    def unused(self) -> list:
        return sorted(k for k in self.sd
                      if k not in self.used
                      and not k.endswith("num_batches_tracked"))


class _ReadTracked(dict):
    """A dict that records the keys a converter reads or probes, so only
    consumed checkpoint keys count as used."""

    def __init__(self, d):
        super().__init__(d)
        self.reads = set()

    def __getitem__(self, k):
        self.reads.add(k)
        return dict.__getitem__(self, k)

    def __contains__(self, k):
        self.reads.add(k)
        return dict.__contains__(self, k)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(r: ImportReport, out: dict, dst: str, key: str,
            bias: bool = True) -> None:
    """A torch Linear as it is (the port's Linears are torch's)."""
    out[f"{dst}.weight"] = _t(r.require(f"{key}.weight"))
    if bias:
        b = r.take(f"{key}.bias")
        if b is not None:
            out[f"{dst}.bias"] = _t(b)


def _ln(r: ImportReport, out: dict, dst: str, key: str) -> None:
    out[f"{dst}.weight"] = _t(r.require(f"{key}.weight"))
    out[f"{dst}.bias"] = _t(r.require(f"{key}.bias"))


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------

def _backbone_prefix(sd: Dict[str, np.ndarray]) -> Tuple[str, str]:
    """(prefix, family): the reference wraps towers differently
    (torchvision ResNets and CLIPVision under ``backbone.model.``; the coop
    CLIP, timm Swin / ViT and AlexNet / VGG16 on ``backbone.``)."""
    for pre in ("backbone.model.", "backbone."):
        if any(k.startswith(pre + "vision_model.") for k in sd):
            return pre, "clip"
        if any(k.startswith(pre + "embeddings.") for k in sd):
            return pre, "vit"
        if any(k.startswith(pre + "layers.0.blocks.") for k in sd):
            return pre, "swin_timm"
        if pre + "cls_token" in sd and any(
                k.startswith(pre + "blocks.0.") for k in sd):
            return pre, "vit_timm"
        if pre + "layer1.0.conv1.weight" in sd:
            return pre, "resnet"
        if pre + "features.0.weight" in sd:
            k11 = np.asarray(sd[pre + "features.0.weight"]).shape[-1] == 11
            return pre, "alexnet" if k11 else "vgg16"
    raise ValueError(
        "unrecognized backbone layout under 'backbone.' — expected CLIP "
        "('vision_model.'), HF-ViT ('embeddings.'), timm swin/vit, "
        "torchvision resnet/alexnet/vgg keys "
        f"(keys: {sorted(sd)[:8]}...)")


def _count_layers(sd, probe: str) -> int:
    n = 0
    while any(k.startswith(probe.format(i=n)) for k in sd):
        n += 1
    return n


def _split_qkv(w: np.ndarray, b: np.ndarray):
    """timm's fused (3D, D) qkv Linear as q, k, v rows."""
    D = w.shape[0] // 3
    return [(w[i * D:(i + 1) * D], b[i * D:(i + 1) * D]) for i in range(3)]


def _timm_vit_to_hf(bsd) -> Dict[str, np.ndarray]:
    """A timm ViT state dict (cls_token / pos_embed / patch_embed / blocks /
    norm) in the Hugging Face ViTModel layout: renames and the qkv
    split."""
    out = {
        "embeddings.cls_token": bsd["cls_token"],
        "embeddings.position_embeddings": bsd["pos_embed"],
        "embeddings.patch_embeddings.projection.weight":
            bsd["patch_embed.proj.weight"],
        "embeddings.patch_embeddings.projection.bias":
            bsd["patch_embed.proj.bias"],
        "layernorm.weight": bsd["norm.weight"],
        "layernorm.bias": bsd["norm.bias"],
    }
    i = 0
    while f"blocks.{i}.norm1.weight" in bsd:
        t, h = f"blocks.{i}", f"encoder.layer.{i}"
        out[f"{h}.layernorm_before.weight"] = bsd[f"{t}.norm1.weight"]
        out[f"{h}.layernorm_before.bias"] = bsd[f"{t}.norm1.bias"]
        out[f"{h}.layernorm_after.weight"] = bsd[f"{t}.norm2.weight"]
        out[f"{h}.layernorm_after.bias"] = bsd[f"{t}.norm2.bias"]
        qkv = _split_qkv(np.asarray(bsd[f"{t}.attn.qkv.weight"]),
                         np.asarray(bsd[f"{t}.attn.qkv.bias"]))
        for name, (w, b) in zip(("query", "key", "value"), qkv):
            out[f"{h}.attention.attention.{name}.weight"] = w
            out[f"{h}.attention.attention.{name}.bias"] = b
        out[f"{h}.attention.output.dense.weight"] = bsd[f"{t}.attn.proj.weight"]
        out[f"{h}.attention.output.dense.bias"] = bsd[f"{t}.attn.proj.bias"]
        out[f"{h}.intermediate.dense.weight"] = bsd[f"{t}.mlp.fc1.weight"]
        out[f"{h}.intermediate.dense.bias"] = bsd[f"{t}.mlp.fc1.bias"]
        out[f"{h}.output.dense.weight"] = bsd[f"{t}.mlp.fc2.weight"]
        out[f"{h}.output.dense.bias"] = bsd[f"{t}.mlp.fc2.bias"]
        i += 1
    return out


def _timm_swin_to_hf(bsd):
    """A timm Swin state dict (patch_embed / layers / norm, the patch
    merging at the end of its stage) in the Hugging Face SwinModel layout;
    -> (hf_sd, depths). The attention masks and relative-position indices
    are recomputed by the port's tower and not read."""
    out = {
        "embeddings.patch_embeddings.projection.weight":
            bsd["patch_embed.proj.weight"],
        "embeddings.patch_embeddings.projection.bias":
            bsd["patch_embed.proj.bias"],
        "embeddings.norm.weight": bsd["patch_embed.norm.weight"],
        "embeddings.norm.bias": bsd["patch_embed.norm.bias"],
        "layernorm.weight": bsd["norm.weight"],
        "layernorm.bias": bsd["norm.bias"],
    }
    depths = []
    si = 0
    while any(k.startswith(f"layers.{si}.blocks.0.") for k in bsd):
        bi = 0
        while f"layers.{si}.blocks.{bi}.norm1.weight" in bsd:
            t = f"layers.{si}.blocks.{bi}"
            h = f"encoder.layers.{si}.blocks.{bi}"
            out[f"{h}.layernorm_before.weight"] = bsd[f"{t}.norm1.weight"]
            out[f"{h}.layernorm_before.bias"] = bsd[f"{t}.norm1.bias"]
            out[f"{h}.layernorm_after.weight"] = bsd[f"{t}.norm2.weight"]
            out[f"{h}.layernorm_after.bias"] = bsd[f"{t}.norm2.bias"]
            qkv = _split_qkv(np.asarray(bsd[f"{t}.attn.qkv.weight"]),
                             np.asarray(bsd[f"{t}.attn.qkv.bias"]))
            for name, (w, b) in zip(("query", "key", "value"), qkv):
                out[f"{h}.attention.self.{name}.weight"] = w
                out[f"{h}.attention.self.{name}.bias"] = b
            out[f"{h}.attention.self.relative_position_bias_table"] = \
                bsd[f"{t}.attn.relative_position_bias_table"]
            out[f"{h}.attention.output.dense.weight"] = \
                bsd[f"{t}.attn.proj.weight"]
            out[f"{h}.attention.output.dense.bias"] = \
                bsd[f"{t}.attn.proj.bias"]
            out[f"{h}.intermediate.dense.weight"] = bsd[f"{t}.mlp.fc1.weight"]
            out[f"{h}.intermediate.dense.bias"] = bsd[f"{t}.mlp.fc1.bias"]
            out[f"{h}.output.dense.weight"] = bsd[f"{t}.mlp.fc2.weight"]
            out[f"{h}.output.dense.bias"] = bsd[f"{t}.mlp.fc2.bias"]
            bi += 1
        if f"layers.{si}.downsample.reduction.weight" in bsd:
            for leaf in ("reduction.weight", "norm.weight", "norm.bias"):
                out[f"encoder.layers.{si}.downsample.{leaf}"] = \
                    bsd[f"layers.{si}.downsample.{leaf}"]
        depths.append(bi)
        si += 1
    return out, tuple(depths)


def _qkv(sd, prefix: str, names) -> Tuple[torch.Tensor, torch.Tensor]:
    """Separate q, k, v Linears as the port's one q|k|v weight and bias."""
    return (torch.cat([_t(sd[f"{prefix}.{n}.weight"]) for n in names]),
            torch.cat([_t(sd[f"{prefix}.{n}.bias"]) for n in names]))


def vit_state_from_hf(sd, num_layers: int) -> dict:
    """A vit-family ``ClipVisionTower`` state dict (without its adapters)
    from a Hugging Face ViTModel state dict: the final ``layernorm`` is the
    tower's post-LayerNorm; there is no projection."""
    out = {
        "patch_embedding.weight": _t(
            sd["embeddings.patch_embeddings.projection.weight"]).permute(
                2, 3, 1, 0).contiguous(),
        "patch_embedding.bias": _t(
            sd["embeddings.patch_embeddings.projection.bias"]),
        "class_embedding": _t(sd["embeddings.cls_token"]).reshape(-1),
        "position_embedding": _t(sd["embeddings.position_embeddings"])[0],
        "post_layernorm.weight": _t(sd["layernorm.weight"]),
        "post_layernorm.bias": _t(sd["layernorm.bias"]),
    }
    for i in range(num_layers):
        h, t = f"encoder.layer.{i}", f"layers.{i}"
        for src, dst in (("layernorm_before", "layer_norm1"),
                         ("layernorm_after", "layer_norm2"),
                         ("attention.output.dense", "self_attn.out_proj"),
                         ("intermediate.dense", "fc1"),
                         ("output.dense", "fc2")):
            out[f"{t}.{dst}.weight"] = _t(sd[f"{h}.{src}.weight"])
            out[f"{t}.{dst}.bias"] = _t(sd[f"{h}.{src}.bias"])
        w, b = _qkv(sd, f"{h}.attention.attention", ("query", "key", "value"))
        out[f"{t}.self_attn.qkv_proj.weight"] = w
        out[f"{t}.self_attn.qkv_proj.bias"] = b
    return out


def swin_state_from_hf(sd, depths) -> dict:
    """A ``models.swin.SwinTransformer`` state dict from a Hugging Face
    SwinModel one: q, k, v fused into ``attn.qkv``, each stage's
    end-of-stage downsample into the next stage's ``downsample``."""
    out = {"patch_embed.proj.weight": _t(
               sd["embeddings.patch_embeddings.projection.weight"]),
           "patch_embed.proj.bias": _t(
               sd["embeddings.patch_embeddings.projection.bias"]),
           "patch_embed.norm.weight": _t(sd["embeddings.norm.weight"]),
           "patch_embed.norm.bias": _t(sd["embeddings.norm.bias"]),
           "norm.weight": _t(sd["layernorm.weight"]),
           "norm.bias": _t(sd["layernorm.bias"])}
    for si, depth in enumerate(depths):
        if si > 0:
            d = f"encoder.layers.{si - 1}.downsample"
            for leaf in ("reduction.weight", "norm.weight", "norm.bias"):
                out[f"layers.{si}.downsample.{leaf}"] = _t(sd[f"{d}.{leaf}"])
        for bi in range(depth):
            h, t = f"encoder.layers.{si}.blocks.{bi}", \
                f"layers.{si}.blocks.{bi}"
            for src, dst in (("layernorm_before", "norm1"),
                             ("layernorm_after", "norm2"),
                             ("attention.output.dense", "attn.proj"),
                             ("intermediate.dense", "mlp.fc1"),
                             ("output.dense", "mlp.fc2")):
                out[f"{t}.{dst}.weight"] = _t(sd[f"{h}.{src}.weight"])
                out[f"{t}.{dst}.bias"] = _t(sd[f"{h}.{src}.bias"])
            w, b = _qkv(sd, f"{h}.attention.self", ("query", "key", "value"))
            out[f"{t}.attn.qkv.weight"] = w
            out[f"{t}.attn.qkv.bias"] = b
            out[f"{t}.attn.relative_position_bias_table"] = _t(
                sd[f"{h}.attention.self.relative_position_bias_table"])
    return out


_CNN_DROP_SUFFIXES = (".num_batches_tracked", ".attn_mask",
                      ".relative_position_index")
# the 1000-way classifiers torchvision ships and the trunks drop
_CNN_DROP_KEYS = {"fc.weight", "fc.bias", "classifier.6.weight",
                  "classifier.6.bias"}
# a CLIP checkpoint's text tower and logit scale (the language side is the
# imported center) and buffers; the adapter copies mounted inside the
# encoder layers alias the adapter_params entries the importer reads
_CLIP_DROP_PREFIXES = ("text_model.", "text_projection")
_CLIP_DROP_SUFFIXES = (".position_ids",)
_CLIP_DROP_KEYS = {"logit_scale"}
_CLIP_ALIAS_MARKERS = (".adapt_mlp_1.", ".adapt_mlp_2.", ".q_adapter.",
                       ".k_adapter.", ".v_adapter.", ".out_adapter.")
_ADAPTER_SLOTS = (("adapt_mlp_1", "adapter_attn"),
                  ("adapt_mlp_2", "adapter_mlp"),
                  ("q_adapter", "self_attn.adapter_q_proj"),
                  ("k_adapter", "self_attn.adapter_k_proj"),
                  ("v_adapter", "self_attn.adapter_v_proj"),
                  ("out_adapter", "self_attn.adapter_out_proj"))


def _adapter(r: ImportReport, out: dict, dst: str, i: int,
             slot: str) -> None:
    """One bottleneck adapter (LN in, down, GELU, up, scale) of layer ``i``
    into the port's ``{dst}.{ln,down,up,scale}``."""
    base = f"adapter_params.adapter_{i}_{slot}"
    if f"{base}_down_proj_weight" not in r.sd:
        return
    for name in ("down", "up"):
        out[f"{dst}.{name}.weight"] = _t(r.require(
            f"{base}_{name}_proj_weight"))
        out[f"{dst}.{name}.bias"] = _t(r.require(f"{base}_{name}_proj_bias"))
    out[f"{dst}.scale"] = _t(r.require(f"{base}_scale"))
    if f"{base}_adapter_layer_norm_weight" in r.sd:
        out[f"{dst}.ln.weight"] = _t(r.require(
            f"{base}_adapter_layer_norm_weight"))
        out[f"{dst}.ln.bias"] = _t(r.require(
            f"{base}_adapter_layer_norm_bias"))


def _tower_patch(sd: Dict[str, np.ndarray], r: ImportReport) -> dict:
    """The tower's state (keys relative to the tower) from the reference's
    backbone keys, with the CLIP / ViT adapters grafted into each layer."""
    from concepthash_tpu_torch.models.clip_loader import vision_state_from_hf
    from concepthash_tpu_torch.models.cnn_loader import (
        alexnet_state_from_torch, resnet_depth_from_torch,
        resnet_state_from_torch, vgg16_state_from_torch)

    pre, family = _backbone_prefix(sd)
    bsd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    tracked = _ReadTracked(bsd)
    if family in ("resnet", "alexnet", "vgg16", "swin_timm", "vit_timm"):
        for k in bsd:
            if k.endswith(_CNN_DROP_SUFFIXES) or k in _CNN_DROP_KEYS:
                r.used.add(pre + k)
        if family == "resnet":
            out = resnet_state_from_torch(tracked,
                                          resnet_depth_from_torch(tracked))
        elif family == "alexnet":
            # the reference wrapper's ``fc`` slice, or torchvision's own
            # ``classifier`` layout
            out = alexnet_state_from_torch(
                tracked, "fc" if "fc.1.weight" in tracked else "classifier")
        elif family == "vgg16":
            out = vgg16_state_from_torch(
                tracked, "fc" if "fc.0.weight" in tracked else "classifier")
        elif family == "vit_timm":
            out = vit_state_from_hf(_timm_vit_to_hf(tracked),
                                    _count_layers(bsd, "blocks.{i}."))
        else:
            out = swin_state_from_hf(*_timm_swin_to_hf(tracked))
        r.used.update(pre + k for k in tracked.reads)
        return out

    for k in bsd:
        if (k.startswith(_CLIP_DROP_PREFIXES)
                or k.endswith(_CLIP_DROP_SUFFIXES) or k in _CLIP_DROP_KEYS
                or any(m in k for m in _CLIP_ALIAS_MARKERS)):
            r.used.add(pre + k)
    if family == "clip":
        L = _count_layers(bsd, "vision_model.encoder.layers.{i}.")
        out = vision_state_from_hf(tracked, L)
    else:
        L = _count_layers(bsd, "encoder.layer.{i}.")
        out = vit_state_from_hf(tracked, L)
    for i in range(L):
        for slot, dst in _ADAPTER_SLOTS:
            _adapter(r, out, f"layers.{i}.{dst}", i, slot)
    r.used.update(pre + k for k in tracked.reads)
    return out


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def _take2(r: ImportReport, *keys: str) -> Optional[np.ndarray]:
    """The first present of ``keys`` (the coop model aliases some
    parameters under ``trainable_params.``), every alias marked used."""
    for k in keys:
        arr = r.take(k)
        if arr is not None:
            r.used.update(k2 for k2 in keys if k2 in r.sd)
            return arr
    return None


def _bn(r: ImportReport, out: dict, dst: str, key: str) -> None:
    """A torch BatchNorm1d into the port's code BatchNorm."""
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{leaf}"] = _t(r.require(f"{key}.{leaf}"))
    r.take(f"{key}.num_batches_tracked")


def _mha(r: ImportReport, out: dict, dst: str, key: str) -> None:
    """torch nn.MultiheadAttention ([q; k; v] rows in ``in_proj``) into the
    port's separate query / key / value Linears and ``out``."""
    w = np.split(r.require(f"{key}.in_proj_weight"), 3, axis=0)
    b = np.split(r.require(f"{key}.in_proj_bias"), 3, axis=0)
    for name, wx, bx in zip(("query", "key", "value"), w, b):
        out[f"{dst}.{name}.weight"] = _t(wx)
        out[f"{dst}.{name}.bias"] = _t(bx)
    _linear(r, out, f"{dst}.out", f"{key}.out_proj")


def _head_patch(r: ImportReport, method: str, own: dict) -> dict:
    """The head's state (model keys) from the reference's head keys; an
    expected tensor the checkpoint lacks is None."""
    out: dict = {}
    if method in ("concepthash", "concepthash_filip"):
        out["hash_queries"] = _take2(r, "trainable_params.hash_queries",
                                     "hash_queries")
        _mha(r, out, "hash_attention.sa", "hash_attention.sa")
        for name in ("norm1", "norm2"):
            _ln(r, out, f"hash_attention.{name}", f"hash_attention.{name}")
        for dst, src in (("ffn_fc1", "ffn.0"), ("ffn_fc2", "ffn.3"),
                         ("ffn2", "ffn2")):
            _linear(r, out, f"hash_attention.{dst}", f"hash_attention.{src}")
        _linear(r, out, "hash_fc", "hash_fc", bias=False)
        for name in ("hash_pe", "concept_pe"):
            v = _take2(r, f"trainable_params.{name}", name)
            if v is not None:
                out[name] = v
        if "hash_bn.weight" in r.sd:
            _bn(r, out, "hash_bn", "hash_bn")
        cent = _take2(r, "concept_ce.centroids",
                      "trainable_params.concept_ce_centroids")
        if cent is not None:
            out["concept_ce.centroids"] = cent
        elif "concept_ce.weight" in r.sd:
            _linear(r, out, "concept_ce", "concept_ce", bias=False)
        tp = sorted({int(k.split(".")[1]) for k in r.sd
                     if k.startswith("text_projection.")
                     and k.endswith(".weight")})
        for j, i in enumerate(tp):
            _linear(r, out, f"text_projection.layers.{j}",
                    f"text_projection.{i}")
        center = r.take("center")
        if center is None:
            center = r.take("trainable_params.center")
        if center is not None:
            out["center"] = center
        tok = r.take("token_embeds")
        if tok is not None and "token_embeds" in own:
            out["token_embeds"] = tok
        return out

    if "hash_fc.0.weight" in r.sd:
        if "hash_fc.1.weight" in r.sd:      # orthohash: Linear, BatchNorm
            _linear(r, out, "hash_fc", "hash_fc.0", bias=False)
            _bn(r, out, "hash_bn", "hash_fc.1")
        else:                               # adsh: Linear (bias), Tanh
            _linear(r, out, "hash_fc", "hash_fc.0")
    elif "hash_fc.weight" in r.sd:
        _linear(r, out, "hash_fc", "hash_fc")
    if "ce_fc.weight" in r.sd:
        _linear(r, out, "ce_fc", "ce_fc")
    elif "ce_fc.centroids" in r.sd:
        out["ce_fc.centroids"] = r.require("ce_fc.centroids")
    r.take("codebook")      # the fixed codebook: the config carries it
    return out


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def _merge(own: dict, patch: dict, report: ImportReport) -> dict:
    """``own`` with ``patch`` laid over it: a key the model lacks raises
    ``KeyError``, a shape that differs ``ValueError``; a None (an expected
    tensor the checkpoint lacks) keeps the model's value, loudly."""
    out = dict(own)
    for k, v in patch.items():
        if v is None:
            log.warning("checkpoint provided no value for expected %s; "
                        "the model's init retained", k)
            report.missing.append(k)
            continue
        if k not in own:
            raise KeyError(f"the model has no {k}; have e.g. "
                           f"{sorted(own)[:8]}")
        v = v if torch.is_tensor(v) else _t(v)
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: model "
                             f"{tuple(own[k].shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
        out[k] = v.to(own[k].dtype)
        report.written.append(k)
    return out


def import_reference_state_dict(sd: Dict[str, np.ndarray], method: str,
                                config: dict, model: torch.nn.Module
                                ) -> Tuple[dict, ImportReport]:
    """Map a reference model state dict onto ``model`` (the port model of
    ``method`` built from ``config``), in place. Returns (its new state
    dict, the report); raises on shape mismatches. Unconsumed checkpoint
    keys are reported (``report.unused``), with a warning, and are not
    fatal."""
    from concepthash_tpu_torch.models.trunk import Trunk

    r = ImportReport(sd)
    own = model.state_dict()
    prefix = ("backbone.tower." if isinstance(model.backbone, Trunk)
              else "backbone.")
    patch = {prefix + k: v for k, v in _tower_patch(sd, r).items()}
    patch.update(_head_patch(r, method, own))
    new = _merge(own, patch, r)
    model.load_state_dict(new, strict=True)
    if r.unused:
        log.warning("import: %d checkpoint keys not mapped (variant knobs "
                    "this importer doesn't cover): %s", len(r.unused),
                    r.unused[:12])
    return new, r
