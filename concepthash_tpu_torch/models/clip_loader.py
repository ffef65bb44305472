"""Hugging Face CLIP weights onto the port's towers (counterpart of
concepthash_tpu/models/clip_loader.py), read from a local directory
(``utils.hf_local``) without ``transformers``.

The mapping from an HF ``CLIPModel`` state dict:

- the vision tower's patch convolution is OIHW (D, C, p, p); the port keeps
  the reference's HWIO (p, p, C, D) kernel, so it is permuted (2, 3, 1, 0);
- HF keeps q, k and v apart; the vision tower fuses them into one (3D, D)
  ``qkv_proj`` in q, k, v order (the text tower keeps them apart);
- HF spells the vision tower's first LayerNorm ``pre_layrnorm``;
- HF's position embeddings are ``nn.Embedding`` weights, the port's plain
  (L, D) parameters; torch Linear weights carry over as they are;
- ``visual_projection`` and ``text_projection`` have no bias.

``merge_ported`` lays ported tensors over a tower's own state dict and
raises on a shape that differs; what the checkpoint lacks (the adapters,
``embeds_adapter``) keeps its init.
"""

from __future__ import annotations

import torch

from concepthash_tpu_torch.models.clip import (ClipTextConfig, ClipTextTower,
                                               ClipVisionConfig)
from concepthash_tpu_torch.utils import hf_local

# CLIPVisionConfig's and CLIPTextConfig's defaults: a saved config.json
# leaves out the keys that equal them
_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072,
                        num_hidden_layers=12, num_attention_heads=12,
                        image_size=224, patch_size=32, projection_dim=512,
                        layer_norm_eps=1e-5, hidden_act="quick_gelu")
_TEXT_DEFAULTS = dict(hidden_size=512, intermediate_size=2048,
                      num_hidden_layers=12, num_attention_heads=8,
                      max_position_embeddings=77, vocab_size=49408,
                      projection_dim=512, layer_norm_eps=1e-5,
                      hidden_act="quick_gelu", eos_token_id=49407)


def _sub_config(hf_cfg: dict, key: str, defaults: dict) -> dict:
    """The tower's keys over their defaults. In a whole ``CLIPModel``
    config the projections' width is the top-level ``projection_dim``
    (what ``CLIPModel`` builds them with), not the sub-config's."""
    sub = dict(defaults)
    if key in hf_cfg:
        sub.update(hf_cfg[key] or {})
        sub["projection_dim"] = hf_cfg.get("projection_dim", 512)
    else:
        sub.update(hf_cfg)
    return sub


def vision_config_from_hf(hf_cfg: dict) -> ClipVisionConfig:
    """The vision tower's geometry from a CLIP ``config.json`` (the whole
    file, or its ``vision_config``)."""
    c = _sub_config(hf_cfg, "vision_config", _VISION_DEFAULTS)
    return ClipVisionConfig(
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        image_size=c["image_size"],
        patch_size=c["patch_size"],
        projection_dim=c["projection_dim"],
        layer_norm_eps=c["layer_norm_eps"],
        hidden_act=c["hidden_act"],
    )


def text_config_from_hf(hf_cfg: dict) -> ClipTextConfig:
    """The text tower's geometry from a CLIP ``config.json``. A config that
    still carries the old ``eos_token_id: 2`` pools, as transformers does
    for it, at each row's highest id: the tokenizer's eos, the vocabulary's
    last id."""
    c = _sub_config(hf_cfg, "text_config", _TEXT_DEFAULTS)
    eos = c["eos_token_id"]
    if eos == 2:
        eos = c["vocab_size"] - 1
    return ClipTextConfig(
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        max_position_embeddings=c["max_position_embeddings"],
        vocab_size=c["vocab_size"],
        projection_dim=c["projection_dim"],
        layer_norm_eps=c["layer_norm_eps"],
        hidden_act=c["hidden_act"],
        eos_token_id=eos,
    )


def _f32(t) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).clone()


def _copy(out: dict, dst: str, sd: dict, src: str, bias: bool = True):
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if bias:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def vision_state_from_hf(sd: dict, num_layers: int,
                         prefix: str = "vision_model") -> dict:
    """A ``ClipVisionTower`` state dict (without the adapters) from an HF
    CLIP state dict."""
    p = prefix
    out = {
        "patch_embedding.weight": _f32(
            sd[f"{p}.embeddings.patch_embedding.weight"]).permute(2, 3, 1, 0)
        .contiguous(),
        "class_embedding": _f32(sd[f"{p}.embeddings.class_embedding"]),
        "position_embedding": _f32(
            sd[f"{p}.embeddings.position_embedding.weight"]),
    }
    _copy(out, "pre_layernorm", sd, f"{p}.pre_layrnorm")
    _copy(out, "post_layernorm", sd, f"{p}.post_layernorm")
    for i in range(num_layers):
        src, dst = f"{p}.encoder.layers.{i}", f"layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            _copy(out, f"{dst}.{n}", sd, f"{src}.{n}")
        a = f"{src}.self_attn"
        for kind in ("weight", "bias"):
            out[f"{dst}.self_attn.qkv_proj.{kind}"] = torch.cat(
                [_f32(sd[f"{a}.{n}.{kind}"])
                 for n in ("q_proj", "k_proj", "v_proj")])
        _copy(out, f"{dst}.self_attn.out_proj", sd, f"{a}.out_proj")
        _copy(out, f"{dst}.fc1", sd, f"{src}.mlp.fc1")
        _copy(out, f"{dst}.fc2", sd, f"{src}.mlp.fc2")
    if "visual_projection.weight" in sd:
        out["visual_projection.weight"] = _f32(sd["visual_projection.weight"])
    return out


def text_state_from_hf(sd: dict, num_layers: int,
                       prefix: str = "text_model") -> dict:
    """A ``ClipTextTower`` state dict from an HF CLIP state dict."""
    p = prefix
    out = {
        "token_embedding": _f32(sd[f"{p}.embeddings.token_embedding.weight"]),
        "position_embedding": _f32(
            sd[f"{p}.embeddings.position_embedding.weight"]),
    }
    _copy(out, "final_layer_norm", sd, f"{p}.final_layer_norm")
    for i in range(num_layers):
        src, dst = f"{p}.encoder.layers.{i}", f"layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            _copy(out, f"{dst}.{n}", sd, f"{src}.{n}")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _copy(out, f"{dst}.{n}", sd, f"{src}.self_attn.{n}")
        _copy(out, f"{dst}.fc1", sd, f"{src}.mlp.fc1")
        _copy(out, f"{dst}.fc2", sd, f"{src}.mlp.fc2")
    if "text_projection.weight" in sd:
        out["text_projection.weight"] = _f32(sd["text_projection.weight"])
    return out


def merge_ported(own: dict, ported: dict) -> dict:
    """``own`` (a module's state dict) with ``ported`` laid over it; raises
    ``ValueError`` on a tensor whose shape differs, and ``KeyError`` on one
    the module does not have."""
    out = dict(own)
    for k, v in ported.items():
        if k not in own:
            raise KeyError(f"the checkpoint's {k} has no place in the tower")
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k}: checkpoint "
                             f"{tuple(v.shape)} vs init {tuple(own[k].shape)}")
        out[k] = v.to(own[k].dtype)
    return out


def load_vision_weights(tower, model_id: str) -> int:
    """Lay the vision weights of the local checkpoint ``model_id`` over
    ``tower`` (a ``ClipVisionTower``) in place; returns the count of
    tensors loaded."""
    path = hf_local.resolve_local(model_id)
    vcfg = vision_config_from_hf(hf_local.load_config(path))
    ported = vision_state_from_hf(hf_local.load_state_dict(path),
                                  vcfg.num_layers)
    tower.load_state_dict(merge_ported(tower.state_dict(), ported),
                          strict=True)
    return len(ported)


def load_text_tower(model_id: str, *, device=None,
                    dtype: torch.dtype = torch.float32) -> ClipTextTower:
    """The CLIP text tower of the local checkpoint ``model_id``, on
    ``device`` (CUDA unless asked otherwise)."""
    path = hf_local.resolve_local(model_id)
    tcfg = text_config_from_hf(hf_local.load_config(path))
    tower = ClipTextTower(tcfg, dtype=dtype, device="cpu")
    ported = text_state_from_hf(hf_local.load_state_dict(path),
                                tcfg.num_layers)
    tower.load_state_dict(merge_ported(tower.state_dict(), ported),
                          strict=True)
    from concepthash_tpu_torch import resolve_device

    return tower.to(resolve_device(device))
