"""Carry a JAX ConceptHash's variables across to the port.

``from_flax(variables)`` takes the reference model's ``params``,
``batch_stats`` and ``constants`` collections as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, variables)``) and returns a state dict
for ``models.concepthash.ConceptHash``, so that both compute the same
function:

- flax Dense kernels are (in, out); torch Linear weights are (out, in);
- an encoder layer's separate ``self_attn/{q,k,v}_proj`` become one (3D, D)
  ``qkv_proj``;
- ``HashQueryBlock.sa`` is a flax MultiHeadDotProductAttention whose
  query/key/value kernels are (D, H, hd) with (H, hd) biases and whose out
  kernel is (H, hd, D);
- ``hash_bn/bn/{scale,bias}`` and ``batch_stats/hash_bn/bn/{mean,var}``
  become the code batch-norm's weight, bias and running statistics; the
  decorrelated one's ``batch_stats/hash_bn/{mean,whiten}`` its buffers;
- ``constants/center`` and ``constants/token_embeds`` (FILIP) become the
  ``center`` and ``token_embeds`` buffers;
- ``backbone/vpt_pe_{i}`` become ``backbone.vpt_pe.{i}``; an encoder
  layer's ``self_attn/adapter_{q,k,v,out}_proj`` (q/k/v/out adapters) keep
  their names under the layer's attention;
- ``self_attn_at_last`` keeps its leaf names (``q``, ``k``, ``v``, or
  ``{q,k,v}_1``, ``_ln``, ``_2`` when ``strong``, and ``pe``).

``baseline_from_flax(variables)`` does the same for a supervised baseline
(``models.baselines.BaselineHashNet``): the ``backbone/tower`` tree
(encoder layers and adapters as above), ``hash_fc``, ``hash_bn`` and its
statistics, ``ce_fc`` (the cosine classifier's ``centroids``, a parameter
or a constant, or a Dense) and ``logit_scale``.

``finegrained_from_flax(variables)`` does the same for a fine-grained head
(``models.finegrained``: ``A2NetCE``, ``Semicon``, ``SemiconCE``): the
trunk as above; ``attn_conv``, ``local_conv``, ``global_conv`` and the tied
f32 ``hash_w`` (kept (in, out)); ``sem_attn_i``, ``sem_norm_i``,
``icon_ln_i``, ``icon_i`` (a q|k|v attention as in the encoder layers),
``hash_fc_i`` into ``ModuleList`` entries, and their ``_global`` forms;
``ce_fc`` a Dense or TempCE, whose ``tp/fc{i}`` become ``tp.layers.{i}``
and whose ``constants/ce_fc/center`` becomes the ``ce_fc.center`` buffer.

``pretrain_from_flax(variables)`` does the same for a pretraining
``models.pretrain.ProjectorNet``: the trunk as above and ``proj_fc*`` (and
the predictor's ``pred_fc*``). ``tbh_from_flax(variables)`` for a
``models.tbh.TBHNet``: the trunk, ``enc_fc``, ``enc_b``, ``enc_z``, ``gcn``
and ``dec``; ``discriminator_from_flax(params)`` for its
``Discriminator`` (``fc1``, ``fc2``). ``mae_from_flax(variables)`` for a
``models.mae.MAE``: ``patch_embed``, ``enc_pos``, the encoder layers
``enc_{i}`` into ``enc.{i}``, ``enc_norm``, ``dec_embed``, ``mask_token``,
``dec_pos``, ``dec_{i}``, ``dec_norm`` and ``dec_pred``.

``text_from_flax(params)`` does the same for the CLIP text tower
(``models.clip.ClipTextTower``), whose q, k and v projections stay separate.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: dict, prefix: str, p: dict) -> None:
    kernel = np.asarray(p["kernel"])
    sd[f"{prefix}.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _adapter(sd: dict, prefix: str, p: dict) -> None:
    if "ln" in p:
        _ln(sd, f"{prefix}.ln", p["ln"])
    _dense(sd, f"{prefix}.down", p["down"])
    _dense(sd, f"{prefix}.up", p["up"])
    sd[f"{prefix}.scale"] = _t(p["scale"])


def _attention(sd: dict, prefix: str, a: dict) -> None:
    """A CLIP-style attention's separate q, k, v projections into one
    q|k|v weight, and its out projection."""
    sd[f"{prefix}.qkv_proj.weight"] = _t(np.concatenate(
        [np.asarray(a[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")]))
    sd[f"{prefix}.qkv_proj.bias"] = _t(np.concatenate(
        [np.asarray(a[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]))
    _dense(sd, f"{prefix}.out_proj", a["out_proj"])


def _encoder_layer(sd: dict, prefix: str, p: dict) -> None:
    _ln(sd, f"{prefix}.layer_norm1", p["layer_norm1"])
    _ln(sd, f"{prefix}.layer_norm2", p["layer_norm2"])
    a = p["self_attn"]
    _attention(sd, f"{prefix}.self_attn", a)
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        if f"adapter_{name}" in a:
            _adapter(sd, f"{prefix}.self_attn.adapter_{name}",
                     a[f"adapter_{name}"])
    _dense(sd, f"{prefix}.fc1", p["fc1"])
    _dense(sd, f"{prefix}.fc2", p["fc2"])
    for name in ("adapter_attn", "adapter_mlp"):
        if name in p:
            _adapter(sd, f"{prefix}.{name}", p[name])


def _vision_tower(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.patch_embedding.weight"] = _t(p["patch_embedding"]["kernel"])
    if "bias" in p["patch_embedding"]:
        sd[f"{prefix}.patch_embedding.bias"] = _t(p["patch_embedding"]["bias"])
    sd[f"{prefix}.class_embedding"] = _t(p["class_embedding"])
    sd[f"{prefix}.position_embedding"] = _t(p["position_embedding"])
    if "pre_layernorm" in p:
        _ln(sd, f"{prefix}.pre_layernorm", p["pre_layernorm"])
    layers = sorted((k for k in p if re.fullmatch(r"layers_\d+", k)),
                    key=lambda k: int(k.split("_")[1]))
    for k in layers:
        _encoder_layer(sd, f"{prefix}.layers.{k.split('_')[1]}", p[k])
        if f"vpt_pe_{k.split('_')[1]}" in p:
            i = k.split("_")[1]
            sd[f"{prefix}.vpt_pe.{i}"] = _t(p[f"vpt_pe_{i}"])
    _ln(sd, f"{prefix}.post_layernorm", p["post_layernorm"])
    _dense(sd, f"{prefix}.visual_projection", p["visual_projection"])


def _hash_query_block(sd: dict, prefix: str, p: dict) -> None:
    for n in ("query", "key", "value"):
        q = p["sa"][n]
        kernel = np.asarray(q["kernel"])                       # (D, H, hd)
        sd[f"{prefix}.sa.{n}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
        sd[f"{prefix}.sa.{n}.bias"] = _t(np.asarray(q["bias"]).reshape(-1))
    out = p["sa"]["out"]
    kernel = np.asarray(out["kernel"])                         # (H, hd, D)
    sd[f"{prefix}.sa.out.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    sd[f"{prefix}.sa.out.bias"] = _t(out["bias"])
    _ln(sd, f"{prefix}.norm1", p["norm1"])
    _ln(sd, f"{prefix}.norm2", p["norm2"])
    for n in ("ffn_fc1", "ffn_fc2", "ffn2"):
        _dense(sd, f"{prefix}.{n}", p[n])


def _self_attn_at_last(sd: dict, prefix: str, p: dict) -> None:
    for name, leaf in p.items():
        if name == "pe":
            sd[f"{prefix}.pe"] = _t(leaf)
        elif name.endswith("_ln"):
            _ln(sd, f"{prefix}.{name}", leaf)
        else:
            _dense(sd, f"{prefix}.{name}", leaf)


def from_flax(variables: dict) -> dict:
    """State dict of the port's ConceptHash from the reference's variables
    (numpy leaves). Keys match ``ConceptHash.state_dict()``; load it with
    ``load_state_dict(..., strict=True)``."""
    p = variables["params"]
    sd: dict = {}
    sd["hash_queries"] = _t(p["hash_queries"])
    _hash_query_block(sd, "hash_attention", p["hash_attention"])
    _vision_tower(sd, "backbone", p["backbone"])
    if "self_attn_at_last" in p:
        _self_attn_at_last(sd, "self_attn_at_last", p["self_attn_at_last"])
    for name in ("hash_pe", "concept_pe"):
        if name in p:
            sd[name] = _t(p[name])
    _dense(sd, "hash_fc", p["hash_fc"])
    if "hash_bn" in p:
        bn = p["hash_bn"]["bn"]
        stats = variables["batch_stats"]["hash_bn"]["bn"]
        sd["hash_bn.weight"] = _t(bn["scale"])
        sd["hash_bn.bias"] = _t(bn["bias"])
        sd["hash_bn.running_mean"] = _t(stats["mean"])
        sd["hash_bn.running_var"] = _t(stats["var"])
    elif "hash_bn" in variables.get("batch_stats", {}):
        stats = variables["batch_stats"]["hash_bn"]
        sd["hash_bn.mean"] = _t(stats["mean"])
        sd["hash_bn.whiten"] = _t(stats["whiten"])
    if "center" in p:
        sd["center"] = _t(p["center"])
    else:
        sd["center"] = _t(variables["constants"]["center"])
        tp = p["text_projection"]
        for k in sorted(tp, key=lambda k: int(k[2:])):
            _dense(sd, f"text_projection.layers.{k[2:]}", tp[k])
    if "concept_ce" in p:
        ce = p["concept_ce"]
        if "centroids" in ce:
            sd["concept_ce.centroids"] = _t(ce["centroids"])
        else:
            _dense(sd, "concept_ce", ce)
    if "token_embeds" in variables.get("constants", {}):
        sd["token_embeds"] = _t(variables["constants"]["token_embeds"])
    return sd


def baseline_from_flax(variables: dict) -> dict:
    """State dict of the port's BaselineHashNet from the reference's
    variables (numpy leaves); load it with ``strict=True``."""
    p = variables["params"]
    sd: dict = {}
    _vision_tower(sd, "backbone.tower", p["backbone"]["tower"])
    for name in ("latent_fc1", "latent_fc2", "hash_fc"):
        if name in p:
            _dense(sd, name, p[name])
    if "hash_bn" in p:
        stats = variables["batch_stats"]["hash_bn"]["bn"]
        sd["hash_bn.weight"] = _t(p["hash_bn"]["bn"]["scale"])
        sd["hash_bn.bias"] = _t(p["hash_bn"]["bn"]["bias"])
        sd["hash_bn.running_mean"] = _t(stats["mean"])
        sd["hash_bn.running_var"] = _t(stats["var"])
    ce = p.get("ce_fc") or variables.get("constants", {}).get("ce_fc")
    if ce is not None:
        if "centroids" in ce:
            sd["ce_fc.centroids"] = _t(ce["centroids"])
        else:
            _dense(sd, "ce_fc", ce)
    if "logit_scale" in p:
        sd["logit_scale"] = _t(p["logit_scale"])
    return sd


def finegrained_from_flax(variables: dict) -> dict:
    """State dict of the port's A2NetCE, Semicon or SemiconCE from the
    reference's variables (numpy leaves); load it with ``strict=True``."""
    p = variables["params"]
    sd: dict = {}
    _vision_tower(sd, "backbone.tower", p["backbone"]["tower"])
    for name in ("attn_conv", "local_conv", "global_conv", "hash_fc_global"):
        if name in p:
            _dense(sd, name, p[name])
    if "hash_w" in p:
        sd["hash_w"] = _t(p["hash_w"])
    for name, leaf in p.items():
        m = re.fullmatch(r"(sem_attn|sem_norm|icon_ln|icon|hash_fc)_(\d+)",
                         name)
        if m is None:
            continue
        prefix = f"{m.group(1)}.{m.group(2)}"
        if m.group(1) in ("sem_norm", "icon_ln"):
            _ln(sd, prefix, leaf)
        elif m.group(1) == "icon":
            _attention(sd, prefix, leaf)
        else:
            _dense(sd, prefix, leaf)
    if "icon_global" in p:
        _ln(sd, "icon_ln_global", p["icon_ln_global"])
        _attention(sd, "icon_global", p["icon_global"])
    if "ce_fc" in p:
        ce = p["ce_fc"]
        if "tp" in ce:
            for k in sorted(ce["tp"], key=lambda k: int(k[2:])):
                _dense(sd, f"ce_fc.tp.layers.{k[2:]}", ce["tp"][k])
            sd["ce_fc.center"] = _t(variables["constants"]["ce_fc"]["center"])
        else:
            _dense(sd, "ce_fc", ce)
    return sd


def _dense_heads(sd: dict, p: dict, names) -> None:
    for name in names:
        if name in p:
            _dense(sd, name, p[name])


def pretrain_from_flax(variables: dict) -> dict:
    """State dict of the port's ProjectorNet from the reference's variables
    (numpy leaves); load it with ``strict=True``."""
    p = variables["params"]
    sd: dict = {}
    _vision_tower(sd, "backbone.tower", p["backbone"]["tower"])
    _dense_heads(sd, p, ("proj_fc1", "proj_fc2", "pred_fc1", "pred_fc2"))
    return sd


def tbh_from_flax(variables: dict) -> dict:
    """State dict of the port's TBHNet from the reference's variables
    (numpy leaves); load it with ``strict=True``."""
    p = variables["params"]
    sd: dict = {}
    _vision_tower(sd, "backbone.tower", p["backbone"]["tower"])
    _dense_heads(sd, p, ("enc_fc", "enc_b", "enc_z", "gcn", "dec"))
    return sd


def discriminator_from_flax(params: dict) -> dict:
    """State dict of the port's TBH Discriminator from the reference's
    discriminator ``params`` (numpy leaves)."""
    sd: dict = {}
    _dense_heads(sd, params, ("fc1", "fc2"))
    return sd


def mae_from_flax(variables: dict) -> dict:
    """State dict of the port's MAE from the reference's variables (numpy
    leaves); load it with ``strict=True``."""
    p = variables["params"]
    sd: dict = {}
    _dense_heads(sd, p, ("patch_embed", "dec_embed", "dec_pred"))
    for name in ("enc_pos", "mask_token", "dec_pos"):
        sd[name] = _t(p[name])
    for name in ("enc_norm", "dec_norm"):
        _ln(sd, name, p[name])
    for k in p:
        m = re.fullmatch(r"(enc|dec)_(\d+)", k)
        if m is not None:
            _encoder_layer(sd, f"{m.group(1)}.{m.group(2)}", p[k])
    return sd


def text_from_flax(params: dict) -> dict:
    """State dict of the port's ClipTextTower from the reference's
    ClipTextTower ``params`` (numpy leaves)."""
    sd: dict = {"token_embedding": _t(params["token_embedding"]["embedding"]),
                "position_embedding": _t(params["position_embedding"])}
    if "embeds_adapter" in params:
        _dense(sd, "embeds_adapter", params["embeds_adapter"])
    layers = sorted((k for k in params if re.fullmatch(r"layers_\d+", k)),
                    key=lambda k: int(k.split("_")[1]))
    for k in layers:
        p, prefix = params[k], f"layers.{k.split('_')[1]}"
        for name in ("layer_norm1", "layer_norm2"):
            _ln(sd, f"{prefix}.{name}", p[name])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
            _dense(sd, f"{prefix}.{name}", p[name])
    _ln(sd, "final_layer_norm", params["final_layer_norm"])
    _dense(sd, "text_projection", params["text_projection"])
    return sd
