"""Backbone configuration from config groups (configs/backbone/*.yaml), the
clip family (the port's own copy of the clip part of
concepthash_tpu/models/backbone_factory.py).

Known CLIP geometries are tabled so configs work offline (random init,
tests); explicit keys in the backbone group override the table.
``maybe_load_pretrained_vision`` lays a local CLIP checkpoint's vision
weights over the built tower when the group asks for them.
"""

from __future__ import annotations

import logging

from concepthash_tpu_torch.models.clip import AdapterConfig, ClipVisionConfig

# (hidden, mlp, layers, heads, patch, image, proj)
_CLIP_GEOMETRIES = {
    "openai/clip-vit-base-patch32": (768, 3072, 12, 12, 32, 224, 512),
    "openai/clip-vit-base-patch16": (768, 3072, 12, 12, 16, 224, 512),
    "openai/clip-vit-large-patch14": (1024, 4096, 24, 16, 14, 224, 768),
    "laion/CLIP-ViT-B-32-laion2B-s34B-b79K": (768, 3072, 12, 12, 32, 224, 512),
}


def vision_config_from_backbone_cfg(backbone_cfg: dict) -> ClipVisionConfig:
    """ClipVisionConfig of a backbone group, ``remat`` (encoder layers
    recomputed in the backward) included."""
    name = backbone_cfg.get("name", "openai/clip-vit-base-patch32")
    if name in _CLIP_GEOMETRIES:
        h, mlp, layers, heads, patch, img, proj = _CLIP_GEOMETRIES[name]
    else:
        h = backbone_cfg.get("hidden_size", 768)
        mlp = backbone_cfg.get("intermediate_size", 4 * h)
        layers = backbone_cfg.get("num_layers", 12)
        heads = backbone_cfg.get("num_heads", 12)
        patch = backbone_cfg.get("patch_size", 32)
        img = backbone_cfg.get("image_size", 224)
        proj = backbone_cfg.get("projection_dim", 512)
    return ClipVisionConfig(
        hidden_size=backbone_cfg.get("hidden_size", h),
        intermediate_size=backbone_cfg.get("intermediate_size", mlp),
        num_layers=backbone_cfg.get("num_layers", layers),
        num_heads=backbone_cfg.get("num_heads", heads),
        patch_size=backbone_cfg.get("patch_size", patch),
        image_size=backbone_cfg.get("image_size", img),
        projection_dim=backbone_cfg.get("projection_dim", proj),
        remat=bool(backbone_cfg.get("remat", False)),
    )


def adapter_config_from_model_cfg(model_cfg: dict) -> AdapterConfig | None:
    if not model_cfg.get("has_adapter", False):
        return None
    return AdapterConfig(
        bottleneck_dim=int(model_cfg.get("adapter_bottleneck_dim", 384)),
        after_attention=bool(model_cfg.get("adapter_mlp_1", True)),
        after_mlp=bool(model_cfg.get("adapter_mlp_2", True)),
        attention_qkvo=bool(model_cfg.get("attention_adapter", False)),
    )


def maybe_load_pretrained_vision(backbone_cfg: dict, model) -> bool:
    """With ``pretrained: true``, load the vision weights of the checkpoint
    ``backbone_cfg['name']`` (a local directory or a Hugging Face cache
    entry; nothing is downloaded) into ``model.backbone`` in place, the
    adapters keeping their init; a checkpoint that is not there, or whose
    shapes differ, logs a warning and keeps the init, as the reference
    does. The tower is ``model.backbone`` (ConceptHash) or its ``tower``
    (the baselines' trunk). Returns whether weights were loaded."""
    if not backbone_cfg.get("pretrained", False):
        return False
    name = backbone_cfg.get("name")
    try:
        from concepthash_tpu_torch.models.clip_loader import \
            load_vision_weights

        n = load_vision_weights(getattr(model.backbone, "tower",
                                        model.backbone), name)
    except Exception as e:  # not on this disk, or another geometry
        logging.warning("pretrained weights unavailable (%s); using random "
                        "init", e)
        return False
    logging.info("loaded pretrained CLIP vision weights from %s (%d "
                 "tensors)", name, n)
    return True
