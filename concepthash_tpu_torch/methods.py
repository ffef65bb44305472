"""The method registry from config dicts (counterpart of
concepthash_tpu/methods.py): the ``Method`` record (the model factory, the
loss, the codebook it needs, and a train step and train-state extras of
its own where it has them), the codebook stage, and, wired as the
reference's experiment loop wires them, the optimizer, the LR schedule and
the train step (``build_model``, ``training_for`` and the two in one,
``build_training``).

Methods: ``concepthash``; the ``sgd``-regime supervised baselines on the
CLIP-adapter trunk (``models/baselines.py``): ``orthohash``,
``orthohash_bcs``, ``csq``, ``dpn``, ``hashnet`` (a train step of its own,
``train/custom_steps.py``), ``dpsh``, ``dtsh``, ``greedyhash``, ``ce``,
``descriptor`` (no objective) and ``clip``; the fine-grained heads
(``models/finegrained.py``) ``a2net_ce`` and ``semicon_ce`` (``sgd``
regime); the unsupervised ``sgd``-regime methods ``unsup_greedyhash``,
``cibhash``, ``bihalf`` and ``nsh`` (``two_view``: each train batch is two
augmentations of its images, ``[v1; v2]``) and ``ssdh`` (``needs_structure``:
a pairwise structure built once from the train codes, each train batch's
block of it in ``batch['aux']``; ``losses/unsupervised.py``); ``itq``,
``pca``, ``lsh`` and ``sh`` on the ``descriptor`` head under the ``shallow``
regime, whose one-pass fit the experiment runs (``losses/shallow.py``);
``adsh`` (the csq head) and ``semicon`` under the ``adsh`` regime,
whose alternating optimization the experiment runs
(``experiments/hashing.py``; their ``build_loss`` gives None); the
pretraining methods ``moco`` (``models/pretrain.py`` with the predictor)
and ``dino`` (without), two-view, with an EMA teacher in the train state
(``train/pretrain_steps.py``), ``mae`` and ``autoencoder`` (``models/mae.py``,
the latter at ``mask_ratio`` 0 over every patch) and ``tbh``
(``models/tbh.py``, its discriminator and that one's Adam in the train
state); and ``odc`` on the ``ce`` head under the ``odc`` regime (a train
step of its own over a memory of the train codes, which the experiment
seeds with a k-means). The config dicts are main.py's: ``model``,
``backbone``, ``criterion``, ``optim``, ``scheduler``, ``epochs``,
``backbone_lr_scale``, ``compute_dtype``. All 31 of the reference's
methods are registered.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Optional

import numpy as np
import torch

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.losses import baselines as L
from concepthash_tpu_torch.losses import unsupervised as U
from concepthash_tpu_torch.losses.concepthash import lgh_loss
from concepthash_tpu_torch.models.backbone_factory import (
    adapter_config_from_model_cfg, vision_config_from_backbone_cfg)
from concepthash_tpu_torch.models.clip import ClipVisionConfig
from concepthash_tpu_torch.models.baselines import (BaselineConfig,
                                                    BaselineHashNet)
from concepthash_tpu_torch.models.concepthash import (ConceptHash,
                                                      ConceptHashConfig,
                                                      SelfAttnLastConfig)
from concepthash_tpu_torch.models.finegrained import HEADS as FINEGRAINED
from concepthash_tpu_torch.models.finegrained import FineGrainedConfig
from concepthash_tpu_torch.train.optim import (build_optimizer,
                                               make_capturable)
from concepthash_tpu_torch.train import pretrain_steps as P
from concepthash_tpu_torch.train.custom_steps import (hashnet_extra,
                                                      hashnet_step, odc_extra,
                                                      odc_step)
from concepthash_tpu_torch.train.state import make_train_step


def _compute_dtype(config) -> torch.dtype:
    """``compute_dtype: bfloat16`` runs the model's math in bf16 (parameters
    stay f32; codes, logits and centers come back in f32)."""
    name = str(config.get("compute_dtype", "float32")).lower()
    table = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
             "float32": torch.float32, "f32": torch.float32}
    if name not in table:
        raise ValueError(f"compute_dtype {name!r} not supported; "
                         f"use one of {sorted(table)}")
    return table[name]


def _self_attn_last_config(sa) -> Optional[SelfAttnLastConfig]:
    """``model.self_attn_at_last`` as the reference reads it: a mapping of
    the SelfAttnLastConfig fields (absent ones at their defaults), or
    nothing. Anything else (e.g. a bare ``true``) raises."""
    if not sa:
        return None
    fields = dataclasses.fields(SelfAttnLastConfig)
    if not hasattr(sa, "get"):
        raise ValueError(f"model.self_attn_at_last must be a mapping of "
                         f"{[f.name for f in fields]}, got {sa!r}")
    # each field in its default's type (bool, float), as the reference casts
    return SelfAttnLastConfig(**{
        f.name: type(f.default)(sa.get(f.name, f.default)) for f in fields})


def _vision_config(config, vision: Optional[dict]) -> ClipVisionConfig:
    """The backbone group's ClipVisionConfig with ``vision``'s fields."""
    vcfg = vision_config_from_backbone_cfg(config.get("backbone", {}) or {})
    return dataclasses.replace(vcfg, **vision) if vision else vcfg


def backbone_group(config) -> Optional[dict]:
    """The backbone group as the trunk reads it: a ResNet, Swin, AlexNet or
    VGG16 group at the dataset's crop (``image_size``), the size its images
    come in, which fixes the token count and Swin's windows (the reference
    reads them off the images)."""
    from concepthash_tpu_torch.models.trunk import IMAGE_FAMILIES

    b = config.get("backbone")
    crop = (config.get("dataset", {}) or {}).get("crop")
    if b and b.get("family", "clip") in IMAGE_FAMILIES and crop:
        b = {**dict(b), "image_size": int(crop)}
    return b


def _build_concepthash(config, codebook, *, device=None,
                       generator: Optional[torch.Generator] = None,
                       vision: Optional[dict] = None) -> ConceptHash:
    """ConceptHash from ``config``; ``codebook`` (nclass, center_dim) fixes
    the centers, None learns them. ``vision`` overrides fields of the
    backbone's ClipVisionConfig (e.g. ``attention_impl``, ``fused_ln``),
    which the backbone group does not set. FILIP's class-text token
    embeddings come in ``config['model']['token_embeds_array']`` (the
    experiment's FILIP stage puts them there)."""
    m = config["model"]
    upt = m.get("upt_config", {}) or {}
    vcfg = _vision_config(config, vision)
    acfg = adapter_config_from_model_cfg(m)
    ccfg = ConceptHashConfig(
        nbit=int(m["nbit"]),
        nclass=int(m["nclass"]),
        ncontext=int(m.get("ncontext", 4)),
        nregs=int(m.get("nregs", 0)),
        num_heads=int(upt.get("num_heads", 8)),
        dropout=float(upt.get("dropout", 0.1)),
        add_bn=m.get("add_bn", True),
        use_before_projection=bool(m.get("use_before_projection", True)),
        hash_pe=bool(upt.get("hash_pe", True)),
        ensemble_method=upt.get("ensemble_method", "concat"),
        concept_reg=bool(m.get("concept_reg", True)),
        concept_cossim=bool(m.get("concept_cossim", True)),
        vpt_pe=bool(m.get("vpt_pe", False)),
        learnable_center=codebook is None,
        center_dim=int(codebook.shape[1]) if codebook is not None else 512,
        text_projection_dims=tuple(m.get("text_projection_dims", (512,))),
        self_attn_at_last=_self_attn_last_config(m.get("self_attn_at_last")),
    )
    fixed = (torch.as_tensor(codebook, dtype=torch.float32)
             if codebook is not None else None)
    te = m.get("token_embeds_array")
    return ConceptHash(vcfg, ccfg, acfg, fixed_center=fixed,
                       token_embeds=(torch.as_tensor(np.asarray(te))
                                     if te is not None else None),
                       dtype=_compute_dtype(config), device=device,
                       generator=generator)


def _build_baseline(head: str, config, codebook, *, device=None,
                    generator: Optional[torch.Generator] = None,
                    vision: Optional[dict] = None) -> BaselineHashNet:
    """A supervised baseline with ``head`` from ``config``; ``codebook``
    is orthohash's fixed signed codebook or clip's class-text centers.
    ``vision`` overrides fields of the backbone's ClipVisionConfig."""
    m = config["model"]
    vcfg = _vision_config(config, vision)
    bcfg = BaselineConfig(nbit=int(m["nbit"]), nclass=int(m["nclass"]),
                          head=head, add_bn=bool(m.get("add_bn", True)),
                          ce_cossim=m.get("m_type", "ce") != "ce",
                          latent_dim=int(m.get("latent_dim", 128)),
                          bcs=bool(m.get("bcs", False)),
                          hash_bias=bool(m.get("hash_bias", False)))
    return BaselineHashNet(vcfg, bcfg, adapter_config_from_model_cfg(m),
                           codebook=codebook,
                           backbone_cfg=backbone_group(config),
                           dtype=_compute_dtype(config), device=device,
                           generator=generator)


def _build_finegrained(head: str, config, codebook, *, device=None,
                       generator: Optional[torch.Generator] = None,
                       vision: Optional[dict] = None) -> torch.nn.Module:
    """A2NetCE, SemiconCE or Semicon (``head``) from ``config``; a
    ``codebook`` (none of their configs asks for one) becomes TempCE's
    fixed centers. ``vision`` overrides fields of the backbone's
    ClipVisionConfig."""
    m = config["model"]
    vcfg = _vision_config(config, vision)
    fcfg = FineGrainedConfig(
        nbit=int(m["nbit"]), nclass=int(m["nclass"]),
        num_attns=int(m.get("num_attns", m.get("nattns", 4))),
        with_softplus=bool(m.get("with_softplus", False)),
        temp=float(m.get("temp", 10.0)))
    return FINEGRAINED[head](vcfg, fcfg, adapter_config_from_model_cfg(m),
                             fixed_center=codebook,
                             backbone_cfg=backbone_group(config),
                             dtype=_compute_dtype(config), device=device,
                             generator=generator)


def _build_orthohash_bcs(config, codebook, **kw) -> BaselineHashNet:
    """orthohash with the second, sign-centroid logits head (model.bcs)."""
    config = {**config, "model": {**dict(config["model"]), "bcs": True}}
    return _build_baseline("orthohash", config, codebook, **kw)


def _build_pretrain(with_predictor: bool, config, codebook, *, device=None,
                    generator: Optional[torch.Generator] = None,
                    vision: Optional[dict] = None) -> torch.nn.Module:
    """moco's (``with_predictor``) or dino's ProjectorNet from ``config``;
    the projection's width is ``model.proj_dim``, else ``model.nbit``."""
    from concepthash_tpu_torch.models.pretrain import (PretrainConfig,
                                                       ProjectorNet)

    m = config["model"]
    pcfg = PretrainConfig(proj_dim=int(m.get("proj_dim", m.get("nbit", 64))),
                          hidden_dim=int(m.get("hidden_dim", 256)),
                          with_predictor=with_predictor)
    return ProjectorNet(_vision_config(config, vision), pcfg,
                        adapter_config_from_model_cfg(m),
                        backbone_cfg=backbone_group(config),
                        dtype=_compute_dtype(config), device=device,
                        generator=generator)


def _build_mae(config, codebook, *, device=None,
               generator: Optional[torch.Generator] = None,
               vision: Optional[dict] = None) -> torch.nn.Module:
    """The MAE of ``config``: the encoder's geometry from the backbone
    group (ViT-B/16 at the dataset's crop when it has none), the decoder's
    and the mask ratio from the model's keys. It has no CLIP tower:
    ``vision`` must be empty."""
    from concepthash_tpu_torch.models.mae import MAE, MAEConfig

    if vision:
        raise ValueError(f"the MAE takes no vision override {vision}")
    m = config["model"]
    b = config.get("backbone", {}) or {}
    mcfg = MAEConfig(
        image_size=int(b.get("image_size", (config.get("dataset", {}) or {})
                             .get("crop", 224))),
        patch_size=int(b.get("patch_size", 16)),
        enc_dim=int(b.get("hidden_size", 768)),
        enc_layers=int(b.get("num_layers", 12)),
        enc_heads=int(b.get("num_heads", 12)),
        dec_dim=int(m.get("dec_dim", 256)),
        dec_layers=int(m.get("dec_layers", 4)),
        dec_heads=int(m.get("dec_heads", 8)),
        mask_ratio=float(m.get("mask_ratio", 0.75)))
    return MAE(mcfg, dtype=_compute_dtype(config), device=device,
               generator=generator)


def _build_tbh(config, codebook, *, device=None,
               generator: Optional[torch.Generator] = None,
               vision: Optional[dict] = None) -> torch.nn.Module:
    """TBHNet from ``config``: ``model.zdim`` (else nbit) continuous units,
    ``model.hidden_dim`` hidden."""
    from concepthash_tpu_torch.models.tbh import TBHConfig, TBHNet

    m = config["model"]
    tcfg = TBHConfig(nbit=int(m["nbit"]), zdim=int(m.get("zdim", m["nbit"])),
                     hidden=int(m.get("hidden_dim", 256)))
    return TBHNet(_vision_config(config, vision), tcfg,
                  adapter_config_from_model_cfg(m),
                  backbone_cfg=backbone_group(config),
                  dtype=_compute_dtype(config), device=device,
                  generator=generator)


def _criterion_kwargs(config) -> dict:
    crit = dict(config.get("criterion", {}) or {})
    crit.pop("name", None)
    crit.setdefault("multiclass", bool(
        config.get("dataset", {}).get("multiclass", False)))
    return crit


def _lgh_build_loss(config, codebook) -> Callable:
    """loss(outputs, batch) -> (total, parts) of the LGH objective."""
    kw = _criterion_kwargs(config)
    kw.pop("multiclass", None)
    kw.setdefault("ncontext", int(config["model"].get("ncontext", 4)))
    kw.setdefault("concept_cossim",
                  bool(config["model"].get("concept_cossim", True)))
    # the attention-diversity slices depend on the register-token count
    kw.setdefault("nregs", int(config["model"].get("nregs", 0) or 0))
    # LGHv3: labels replaced by the batch diagonal
    v3 = kw.pop("v3", False) or (config.get("criterion", {}) or {}) \
        .get("name") in ("lghv3", "lgh_v3")

    def loss(outputs, batch):
        y = batch["label"]
        if v3:
            y = torch.eye(y.shape[0], dtype=torch.float32, device=y.device)
        return lgh_loss(outputs, y, **kw)

    return loss


def _simple_loss(loss_fn: Callable) -> Callable:
    """build(config, codebook) -> loss(outputs, batch): ``loss_fn`` with the
    criterion's keys and, where the method has one, the codebook in place
    of the criterion's codebook spec (moved to the labels' device at the
    first call, before any graph captures the step)."""

    def build(config, codebook):
        kw = _criterion_kwargs(config)
        cb = (torch.as_tensor(np.asarray(codebook), dtype=torch.float32)
              if codebook is not None else None)
        per_device: dict = {}

        def loss(outputs, batch):
            y = batch["label"]
            if cb is None:
                return loss_fn(outputs, y, **kw)
            if y.device not in per_device:
                per_device[y.device] = {**kw, "codebook": cb.to(y.device)}
            return loss_fn(outputs, y, **per_device[y.device])

        return loss

    return build


def _regime_loss(config, codebook) -> None:
    """The loss of a method whose regime builds its own objective (adsh):
    none here."""
    return None


def _ssdh_loss(config, codebook) -> Callable:
    """SSDH's loss against the batch's block of the structure
    (``batch['aux']``); eval batches carry none, and it is zero there."""
    return lambda outputs, batch: U.ssdh_loss(outputs, None,
                                              S_batch=batch.get("aux"))


def _null_loss(config, codebook) -> Callable:
    """The loss of a method trained without an objective (descriptor): zero,
    with a zero gradient into everything the codes depend on, as the
    reference's gradient of a constant is zero (so the optimizer's weight
    decay still acts, as it does there)."""
    return lambda outputs, batch: (0.0 * outputs["codes"].sum(), {})


def _mae_loss(config, codebook) -> Callable:
    from concepthash_tpu_torch.models.mae import mae_loss

    return lambda outputs, batch: mae_loss(outputs)


def _autoencoder_loss(config, codebook) -> Callable:
    """The reconstruction over every patch (the MAE net at mask_ratio 0)."""
    from concepthash_tpu_torch.models.mae import autoencoder_loss

    return lambda outputs, batch: autoencoder_loss(outputs)


def _needs_attentions(config) -> bool:
    return ((config.get("criterion", {}) or {}).get("loss_scales", {})
            or {}).get("attn_div_loss", 0) != 0


@dataclasses.dataclass
class Method:
    name: str
    build_model: Callable  # (config, codebook, **kw) -> nn.Module
    build_loss: Callable   # (config, codebook) -> loss(outputs, batch)
    codebook: Optional[str] = None     # None | 'signed' | 'continuous'
    needs_attentions: Callable = lambda cfg: False
    # a train step of the method's own, taken one step per dispatch:
    # (model, config, optimizer, scheduler, generator, steps_per_epoch,
    #  extra) -> step(batch) -> metrics
    custom_step: Optional[Callable] = None
    # the train state's extras (config, model) -> {name: tensor, module or
    # optimizer}
    init_extra: Optional[Callable] = None
    regime: str = "sgd"     # sgd | shallow | adsh | odc (the experiment's)
    unsupervised: bool = False
    two_view: bool = False         # train batches: two augmented views
    needs_structure: bool = False  # a pairwise structure first (SSDH)


def _baseline(head: str) -> Callable:
    return functools.partial(_build_baseline, head)


# in the reference's order of registration; list_methods keeps it
_METHODS = {m.name: m for m in (
    Method("concepthash", _build_concepthash, _lgh_build_loss,
           codebook="continuous", needs_attentions=_needs_attentions),
    Method("orthohash", _baseline("orthohash"),
           _simple_loss(L.orthohash_loss), codebook="signed"),
    Method("orthohash_bcs", _build_orthohash_bcs,
           _simple_loss(L.orthohash_loss), codebook="signed"),
    Method("csq", _baseline("csq"), _simple_loss(L.csq_loss),
           codebook="signed"),
    Method("dpn", _baseline("dpn"), _simple_loss(L.dpn_loss),
           codebook="signed"),
    Method("hashnet", _baseline("pairwise"), _simple_loss(L.hashnet_loss),
           custom_step=hashnet_step, init_extra=hashnet_extra),
    Method("dpsh", _baseline("pairwise"), _simple_loss(L.dpsh_loss)),
    Method("dtsh", _baseline("pairwise"), _simple_loss(L.dtsh_loss)),
    Method("greedyhash", _baseline("greedyhash"),
           _simple_loss(L.greedyhash_loss)),
    Method("unsup_greedyhash", _baseline("unsup_greedyhash"),
           _simple_loss(L.unsup_greedyhash_loss), unsupervised=True),
    Method("ce", _baseline("ce"), _simple_loss(L.ce_loss)),
    Method("descriptor", _baseline("descriptor"), _null_loss),
    Method("a2net_ce", functools.partial(_build_finegrained, "a2net_ce"),
           _simple_loss(L.a2net_ce_loss)),
    Method("semicon_ce", functools.partial(_build_finegrained, "semicon_ce"),
           _simple_loss(L.semicon_ce_loss)),
    # the unsupervised family
    Method("cibhash", _baseline("pairwise"), _simple_loss(U.cibhash_loss),
           unsupervised=True, two_view=True),
    Method("bihalf", _baseline("unsup_greedyhash"),
           _simple_loss(U.bihalf_loss), unsupervised=True, two_view=True),
    Method("nsh", _baseline("nsh"), _simple_loss(U.nsh_loss),
           unsupervised=True, two_view=True),
    Method("ssdh", _baseline("pairwise"), _ssdh_loss, unsupervised=True,
           needs_structure=True),
    Method("clip", _baseline("clip"), _simple_loss(L.ce_loss),
           codebook="continuous"),
    # one-pass fits on the descriptor's features
    *(Method(name, _baseline("descriptor"), _null_loss, regime="shallow")
      for name in ("itq", "pca", "lsh", "sh")),
    # the csq head's tanh codes, and SEMICON, under the adsh regime
    Method("adsh", _baseline("csq"), _regime_loss, regime="adsh"),
    Method("semicon", functools.partial(_build_finegrained, "semicon"),
           _regime_loss, regime="adsh"),
    # pretraining: EMA-teacher steps, masked and plain autoencoding, TBH's
    # adversarial step, and online deep clustering
    Method("moco", functools.partial(_build_pretrain, True), _null_loss,
           custom_step=P.moco_step, init_extra=P.teacher_extra,
           unsupervised=True, two_view=True),
    Method("dino", functools.partial(_build_pretrain, False), _null_loss,
           custom_step=P.dino_step, init_extra=P.dino_extra,
           unsupervised=True, two_view=True),
    Method("mae", _build_mae, _mae_loss, unsupervised=True),
    Method("autoencoder", _build_mae, _autoencoder_loss, unsupervised=True),
    Method("tbh", _build_tbh, _null_loss, custom_step=P.tbh_step,
           init_extra=P.tbh_extra, unsupervised=True),
    Method("odc", _baseline("ce"), _simple_loss(L.ce_loss),
           custom_step=odc_step, init_extra=odc_extra, regime="odc",
           unsupervised=True),
)}


def get_method(name: str) -> Method:
    if name not in _METHODS:
        raise KeyError(f"unknown method {name!r}; known: {list_methods()}")
    return _METHODS[name]


def list_methods() -> list:
    """The ported methods, the flagship first."""
    return list(_METHODS)


def prepare_codebook(method: Method, config, logdir: str | None = None,
                     text_embedder=None, device=None) -> Optional[np.ndarray]:
    """Run (or load) the codebook stage if the method needs one, from the
    model config's ``fixed_center`` spec (or the criterion's / model's
    ``codebook``), cached at ``<logdir>/outputs/codebook.pt`` unless a
    ``text_embedder`` stands in for the text stage, which otherwise runs
    the local CLIP text tower on ``device``."""
    if method.codebook is None:
        return None
    m = config["model"]
    spec = dict(m.get("fixed_center")
                or (config.get("criterion", {}) or {}).get("codebook")
                or m.get("codebook") or {})
    spec.pop("_target_", None)
    spec.setdefault("codebook_method", "N")
    spec.setdefault("nclass", int(m["nclass"]))
    spec.setdefault("nbit", int(m["nbit"]))
    spec.setdefault("seed", int(config.get("seed", 42)))
    if method.codebook == "continuous":
        spec.setdefault("quantized", False)
    if text_embedder is not None:
        spec["text_embedder"] = text_embedder
    else:
        spec["device"] = device

    from concepthash_tpu_torch.train import codebook as CB

    if logdir and "text_embedder" not in spec:
        return CB.load_or_create_codebook(
            os.path.join(logdir, "outputs", "codebook.pt"), **spec)
    return CB.get_codebook(**spec)


@dataclasses.dataclass
class Training:
    """What one training run steps: ``step(batch) -> metrics`` updates
    ``model``, ``optimizer``, ``scheduler`` and ``extra`` in place.
    ``custom`` is true for a method's own step (one step per dispatch)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    loss_fn: Callable
    generator: torch.Generator
    step: Callable
    extra: dict = dataclasses.field(default_factory=dict)
    custom: bool = False


def build_model(config: dict, codebook, *, device=None,
                vision: Optional[dict] = None) -> tuple:
    """(model, loss) of ``config['model']['name']`` from main.py's config
    dicts: the model seeded from ``config['seed']`` (load other weights into
    it in place) and ``loss(outputs, batch) -> (total, parts)``."""
    dev = resolve_device(device)
    method = get_method(config["model"]["name"])
    seed = int(config.get("seed", 42))
    model = method.build_model(config, codebook, device=dev, vision=vision,
                               generator=torch.Generator().manual_seed(seed))
    return model, method.build_loss(config, codebook)


def training_for(config: dict, model: torch.nn.Module, loss_fn: Callable,
                 steps_per_epoch: int) -> Training:
    """The train step over a built ``model``: optimizer and schedule with
    the backbone policy, and a dropout generator on the model's device
    seeded from ``config['seed']`` + 1. On the card the optimizer is made
    capturable whatever ``train_chunk`` is, so that single steps and graphed
    chunks share one arithmetic (float32 device rates; adam's bias
    correction on the device)."""
    method = get_method(config["model"]["name"])
    dev = next(model.parameters()).device
    optimizer, scheduler = build_optimizer(
        config.get("optim", {}) or {}, config.get("scheduler", {}) or {},
        int(config.get("epochs", 100)), steps_per_epoch, model,
        backbone_lr_scale=float(config.get("backbone_lr_scale", 1.0)))
    if dev.type == "cuda":
        make_capturable(optimizer)
    generator = torch.Generator(device=dev).manual_seed(
        int(config.get("seed", 42)) + 1)
    extra = method.init_extra(config, model) if method.init_extra else {}
    if method.custom_step is not None:
        step = method.custom_step(model, config, optimizer, scheduler,
                                  generator, max(steps_per_epoch, 1), extra)
    else:
        step = make_train_step(
            model, loss_fn, optimizer, scheduler,
            output_attentions=method.needs_attentions(config),
            generator=generator)
    return Training(model, optimizer, scheduler, loss_fn, generator, step,
                    extra, method.custom_step is not None)


def build_training(config: dict, codebook, steps_per_epoch: int, *,
                   device=None, vision: Optional[dict] = None) -> Training:
    """``build_model`` and ``training_for`` in one: the train step of
    ``config['model']['name']`` from main.py's config dicts."""
    model, loss_fn = build_model(config, codebook, device=device,
                                 vision=vision)
    return training_for(config, model, loss_fn, steps_per_epoch)
