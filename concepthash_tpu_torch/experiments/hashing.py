"""The experiments: train + retrieve, train-only and eval-only (counterpart
of the ``sgd``, ``shallow`` and ``adsh`` regimes of
concepthash_tpu/experiments/hashing.py ``RetrievalExperiment``,
``GeneralExperiment`` and ``RetrievalEvaluation``).

One run: the codebook stage, the model and its train step
(``methods.build_training``), the pretrained vision weights when the
backbone asks for them and they are on the disk, then epochs of training
with an evaluation every ``eval_interval`` epochs and at the last, tracking
the best metric (``RetrievalExperiment``: the highest mAP;
``GeneralExperiment``: the lowest test loss). Each batch crosses host ->
device as uint8 from pinned memory and is preprocessed and augmented on the
device (``data/preprocess.py``). With ``train_chunk`` K > 1 (``auto``: 8 on
CUDA, 1 on the CPU) full batches go K at a time through
``make_multi_train_step`` and ``make_multi_eval_step`` (one CUDA graph
replay a chunk on the card), staged in double-buffered pinned host memory;
a tail shorter than K, and the padded last eval batch (at its valid rows),
take the single step. Eval scores with ``ops.retrieval.calculate_mAP`` on
the device.

The run directory is the reference's, with ``.pt`` files in place of its
``.msgpack``: ``config.yaml``, ``log.txt``, ``train_history.json``,
``test_history.json``, ``events.jsonl`` (when ``wandb: true``),
``models/{best,last}.pt`` (the model's state dict and the epoch),
``optims/{best,last}.pt`` with ``save_training_state`` (``TrainState``:
optimizer, schedule, step, generators, the loader's epoch),
``outputs/{test,db}_best.pt`` (codes and labels) and, when the text stage
ran, ``outputs/codebook.pt``. ``resume_logdir`` continues a run from its
``models/last.pt`` (strictly: a changed shape raises) and
``optims/last.pt``, or a JAX package run from its ``models/last.msgpack``
and ``optims/last.msgpack`` (``train/optax_state.py``); ``finetune_path``
takes a port checkpoint, or a JAX package checkpoint or run directory
(read with ``utils.io.load_jax_checkpoint`` and carried across by
``weights.from_flax`` or ``weights.baseline_from_flax``), leniently.
``RetrievalEvaluation`` scores a run's ``models/{best,last}.pt`` (or its
JAX ``.msgpack``) into ``eval_logdir``.

With ``model.filip`` the run first takes FILIP's class-text token
embeddings from the local CLIP checkpoint's text stage, or, where it is not
on the disk, the reference's deterministic pseudo-tokens (loudly logged);
the model keeps them as its ``token_embeds`` buffer, which its checkpoints
carry.

A method with a train step of its own (HashNet, MoCo, DINO, TBH, ODC)
takes it one step per dispatch at any ``train_chunk``, with the batch's
dataset indices, and its train-state extras (HashNet's bank, the EMA
teacher, DINO's center, TBH's discriminator and its Adam, ODC's memory) go
into ``optims/*.pt`` with the rest of the train state.

A ``two_view`` method (``cibhash``, ``bihalf``, ``nsh``) trains on two
augmentations of each batch, drawn one after the other from the run's
augmentation generators and stacked ``[v1; v2]`` (2B rows; a graphed
chunk stages (K, 2B, ...) images). SSDH (``needs_structure``) first builds
its pairwise structure from the eval codes of the train split in dataset
order (``_extract_train_matrix``: an unshuffled loader without
``drop_last``, rows scattered by the batch's index, the padded tail
masked), once before its first train epoch (after a resume, from the
resumed weights); each train batch carries its block ``S[idx, idx]`` as
``aux``, which a graphed chunk stages as a (K, B, B) buffer.

A method of the ``shallow`` regime (``itq``, ``pca``, ``lsh``, ``sh``) runs
one pass: the descriptor's features of the train split through the train
preprocessing (crop, flip and the config's augmentation, from generators
seeded by the run's seed; the model in eval mode), the host fit of
``losses/shallow.py`` with the criterion's keys, then the test and
database splits encoded through the eval pipeline and the fit, scored as
one test record at epoch 0. The fit goes to ``models/best.pt`` as
``{"criterion": fit, "epoch": 0}``, which ``load_model_state`` (and so
``exp=validation``) refuses with a ``ValueError``: it is not a network.

A method of the ``adsh`` regime (``adsh``, ``semicon``) alternates, each
epoch: ``max_iters`` passes of SGD over a random subset omega of
``num_samples`` train rows against the stored database codes V, then a
fresh encode of omega and the discrete update of V (``solve_dcc``, on the
run's device). V's initial signs and each epoch's omega come from
``np.random.default_rng(seed)`` in the reference's order; the schedule runs
on ``max_iters * (num_samples // batch_size)`` steps an epoch, one step a
dispatch at any ``train_chunk``. The run scores V (over the train labels)
against the test codes and writes ``outputs/db_codes.pt``.

``native_decode`` decodes the images with the C++ library (``native``),
and ``cache_images`` keeps the decoded images in memory (``null`` is off,
as in the reference's reading of ``configs/train.yaml``).

The pretraining methods (``moco``, ``dino``, ``mae``, ``autoencoder``)
run ``exp=general`` as their configs say; ``moco`` and ``dino`` are
``two_view``.

A method of the ``odc`` regime (``odc``) trains with its own step over a
memory of the train codes. Before its first train epoch (unless a resume
restored the memory) the train split's eval codes, in dataset order and
L2-normalized, are clustered into ``model.nclass`` clusters
(``train/kmeans.py``, seeded by the run's seed) to seed the memory, the
pseudo-labels, the centroids and the weights. Each evaluation adds
``test_nmi`` and ``db_nmi``: the NMI between the true classes and each
split's nearest-centroid labels of its L2-normalized codes.

Data parallelism (``parallel/``): launched by ``torchrun`` (or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``), the run joins the process group
(NCCL on the card, gloo under ``--device cpu``) and builds its mesh of the
first W ranks, W the largest rank count that divides ``batch_size`` (with
the reference's warning); a rank past W writes nothing and returns. Every
rank loads the same global batches and takes its block of each
(``shard_batch``); its train and eval steps compute the one-process step's
losses, metrics and codes (``train/state.py``), so every rank holds the
same parameters, codes and records. An eval batch shorter than
``batch_size`` (the padded tail) runs whole on every rank, as the
reference runs it unsharded. Rank 0 alone writes the run directory, the
log file, the records and the checkpoints; a resume loads on every rank,
and rank 0's state is broadcast after the build, a resume or a finetune
(``replicate``). Every method runs so; the regimes' host work (the
adsh regime's DCC, the shallow fit, ODC's k-means, SSDH's structure)
runs on every rank over the gathered codes, and V and ODC's memory are
broadcast from rank 0.

Diagnostics (``utils/diagnostics.py``): ``profile`` traces a window of
train dispatches with ``torch.profiler`` into ``<logdir>/profile``;
``debug.nans`` raises ``FloatingPointError`` at the first non-finite loss
or gradient; ``debug.disable_jit`` runs eager steps. Either debug flag
sets ``train_chunk`` to 1 (nothing captured, each step checkable).
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib

import numpy as np
import torch

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.config.loader import save_config
from concepthash_tpu_torch.data.manifest import HashingDataset
from concepthash_tpu_torch.data.pipeline import Loader, seeding
from concepthash_tpu_torch.data.preprocess import preprocess_batch
from concepthash_tpu_torch.losses.baselines import (adsh_loss, soften_sim,
                                                    solve_dcc)
from concepthash_tpu_torch.methods import (build_model, get_method,
                                           prepare_codebook, training_for)
from concepthash_tpu_torch.models.backbone_factory import \
    maybe_load_pretrained_vision
from concepthash_tpu_torch.ops.retrieval import (calculate_mAP,
                                                 calculate_pr_curve, get_sim,
                                                 normalized_mutual_info)
from concepthash_tpu_torch.parallel.mesh import (broadcast_, broadcast_array,
                                                 init_distributed, make_mesh,
                                                 mesh_size_for, replicate,
                                                 shard_batch)
from concepthash_tpu_torch.train.optim import current_lr
from concepthash_tpu_torch.train.state import (create_train_state,
                                               make_eval_step,
                                               make_multi_eval_step,
                                               make_multi_train_step)
from concepthash_tpu_torch.utils import io
from concepthash_tpu_torch.utils.diagnostics import (StepProfiler,
                                                     apply_debug_flags,
                                                     check_finite,
                                                     guarded_training)
from concepthash_tpu_torch.utils.logger import (HistoryWriter, Tracker,
                                                _to_jsonable, setup_logging)
from concepthash_tpu_torch.utils.machine_stats import print_stats
from concepthash_tpu_torch.utils.meters import MeterBank

_AUGMENT_BY_TRANSFORM = {
    "trivialaugment": "trivial",
    "simple": "rrc",
    "randcrop": "randcrop",
    "test": None,
    "no_augmentation": None,
    None: "trivial",
}


def _pseudo_embeddings(class_names, dim: int = 512):
    """Deterministic per-class pseudo-embeddings."""
    out = [np.random.default_rng(zlib.crc32(n.encode())).standard_normal(dim)
           for n in class_names]
    return np.stack(out).astype(np.float32)


def offline_text_embedder(class_names, dim: int = 512):
    """Deterministic per-class pseudo-embeddings for runs without the CLIP
    text weights (real language guidance needs them; loudly logged)."""
    logging.warning("CLIP text checkpoint unreachable — codebook falls back to "
                    "deterministic pseudo-embeddings (no language guidance)")
    return _pseudo_embeddings(class_names, dim)


def resolve_train_chunk(chunk, device: torch.device) -> int:
    """Steps per dispatch: ``auto`` (or null) is 8 on CUDA, where the step
    is host-bound as the reference's TPU relay was, and 1 on the CPU."""
    if chunk in ("auto", None):
        return 8 if device.type == "cuda" else 1
    return max(1, int(chunk))


def _check_shapes(own: dict, sd: dict, path: str) -> None:
    """The strict restore's shape check (the reference's ``_restore_like``):
    a tensor whose shape differs from the model's raises."""
    for k, v in sd.items():
        if k in own and tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(
                f"strict resume: {path}'s {k} has shape {tuple(v.shape)}, "
                f"the model's is {tuple(own[k].shape)}. The architecture "
                "changed since this checkpoint was written — use "
                "finetune_path (lenient restore) instead of resume for "
                "architecture changes.")


def _jax_bridge(params: dict):
    """The flax -> torch state-dict function of a JAX package model, by the
    names in its ``params``."""
    from concepthash_tpu_torch.weights import (baseline_from_flax,
                                               finegrained_from_flax,
                                               from_flax, mae_from_flax,
                                               pretrain_from_flax,
                                               tbh_from_flax)

    return (from_flax if "hash_queries" in params
            else finegrained_from_flax
            if {"attn_conv", "sem_attn_0"} & set(params)
            else mae_from_flax if "enc_pos" in params
            else tbh_from_flax if "enc_b" in params
            else pretrain_from_flax if "proj_fc1" in params
            else baseline_from_flax)


class RetrievalExperiment:
    """Train + periodic retrieval eval, on ``device`` (CUDA unless the caller
    asks for another). With ``eval_logdir`` the experiment only evaluates
    (``RetrievalEvaluation``): it logs there, builds the model and its eval
    steps and no training objects, and loads no pretrained weights (the
    run's checkpoint replaces them)."""

    eval_metric = "mAP"
    higher_is_better = True

    def __init__(self, config: dict, device=None, *,
                 eval_logdir: str | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.method = get_method(config["model"]["name"])
        self.logdir = config["logdir"]
        trains = eval_logdir is None
        log_dir = self.logdir if trains else eval_logdir
        grouped = init_distributed(self.device)
        # rank 0 alone writes the run directory (every rank when alone)
        self.writes = not grouped or torch.distributed.get_rank() == 0
        if self.writes:
            os.makedirs(log_dir, exist_ok=True)
        io.init_save_queue()
        setup_logging(os.path.join(log_dir, "log.txt") if self.writes
                      else None)
        self.mesh = self._make_mesh() if grouped else None
        self.idle = self.mesh is not None and not self.mesh.member
        if self.idle:
            logging.info("rank %d is outside the %d-rank mesh: idle",
                         torch.distributed.get_rank(), self.mesh.size)
            return
        if self.mesh is not None:
            self.device = self.mesh.device
        seeding(int(config.get("seed", 42)))
        print_stats(self.device)
        if trains and self.writes:
            save_config(config, os.path.join(self.logdir, "config.yaml"))
        self.debug = apply_debug_flags(config.get("debug"))
        self.profiler = StepProfiler(
            config.get("profile") if self.writes else None, log_dir)

        self._load_data()
        self._build_model(pretrained=trains)
        if not trains:
            return
        if self.method.regime != "shallow":     # a fit, not an optimizer
            self._build_training()
        self.tracker = Tracker(config.get("wandb", False) and self.writes,
                               self.logdir)
        self.train_history = HistoryWriter(self.logdir, "train",
                                           tracker=self.tracker,
                                           write=self.writes)
        self.test_history = HistoryWriter(self.logdir, "test",
                                          tracker=self.tracker,
                                          write=self.writes)
        self.best_metric = None
        self.start_epoch = 0
        if config.get("resume_logdir"):
            self.resume_training(config["resume_logdir"])
        elif config.get("finetune_path"):
            self.finetune_init(config["finetune_path"])
        if self.mesh is not None and hasattr(self, "state"):
            replicate(self.state, self.mesh)

    def _make_mesh(self):
        """The mesh of the run: the group's first W ranks, W the largest
        rank count that divides ``batch_size`` (the reference's shrink)."""
        bs = int(self.config.get("batch_size", 64))
        world = torch.distributed.get_world_size()
        n = mesh_size_for(bs, world)
        if n != world:
            logging.warning("batch_size %d not divisible by %d devices; "
                            "using %d-device mesh", bs, world, n)
        mesh = make_mesh(n)
        logging.info("data-parallel mesh: %d of %d ranks (%s), this rank %d",
                     n, world, mesh.backend, mesh.rank)
        return mesh

    def _local(self, batch: dict) -> dict:
        """This rank's block of a host batch (the batch itself without a
        mesh)."""
        return batch if self.mesh is None else shard_batch(batch, self.mesh)

    # ------------------------------------------------------------------ data
    def _load_data(self):
        cfg = self.config
        ds = cfg["dataset"]
        root = os.path.join(cfg.get("data_dir", "."), ds["data_folder"])
        nclass = int(ds["nclass"])
        shots = int(ds.get("num_shots", 0) or 0)
        self.datasets = {
            "train": HashingDataset(root, "train.txt", nclass,
                                    num_shots=shots),
            "test": HashingDataset(root, "test.txt", nclass),
            "db": HashingDataset(root, "database.txt", nclass),
        }
        for k, v in self.datasets.items():
            logging.info("%s dataset: %d items", k, len(v))
        # what methods with train-set-sized state read (HashNet's bank)
        cfg["_train_size_"] = len(self.datasets["train"])
        bs = int(cfg.get("batch_size", 64))
        resize = int(ds.get("resize", 256))
        cache = bool(cfg.get("cache_images",
                             len(self.datasets["train"]) < 20000))
        seed = int(cfg.get("seed", 42))
        self._loader_kw = dict(resize=resize, cache=cache,
                               native_decode=bool(cfg.get("native_decode",
                                                          False)))
        self.loaders = {
            "train": Loader(self.datasets["train"], bs, shuffle=True,
                            drop_last=True, seed=seed, **self._loader_kw),
            "test": Loader(self.datasets["test"], bs, **self._loader_kw),
            "db": Loader(self.datasets["db"], bs, **self._loader_kw),
        }
        self.crop = int(ds.get("crop", 224))
        self.norm = int(ds.get("norm", 2))
        tname = (cfg.get("_choices_", {}) or {}).get("transforms") or \
            cfg.get("transforms_name")
        self.augment = _AUGMENT_BY_TRANSFORM.get(tname, "trivial")
        logging.info("transforms: %s -> augment=%s norm=%d crop=%d",
                     tname, self.augment, self.norm, self.crop)

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host batch array on the device: pinned, then copied without
        waiting."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _stack_chunk(self, items: list) -> dict:
        """Stack K batches' images, labels and, where they carry it, their
        ``aux`` (SSDH's structure block) into (K, ...) host buffers,
        reused across chunks: two per key, alternating, pinned on CUDA.
        Fenced: before a buffer is refilled, the copy made from it two
        chunks ago (an event ``_place_chunk`` recorded) must be done; at
        steady state it is, and the wait is free."""
        if not hasattr(self, "_chunk_bufs"):
            self._chunk_bufs, self._chunk_events = {}, {}
            self._chunk_flip = 0
        self._chunk_flip ^= 1
        event = self._chunk_events.pop(self._chunk_flip, None)
        if event is not None:
            event.synchronize()
        out = {}
        for k in ("image", "label", "aux"):
            if k not in items[0]:
                continue
            arrs = [np.asarray(b[k]) for b in items]
            key = (k, len(arrs), arrs[0].shape, arrs[0].dtype.str,
                   self._chunk_flip)
            buf = self._chunk_bufs.get(key)
            if buf is None:
                buf = torch.from_numpy(np.empty((len(arrs),) + arrs[0].shape,
                                                arrs[0].dtype))
                if self.device.type == "cuda":
                    buf = buf.pin_memory()
                self._chunk_bufs[key] = buf
            np.stack(arrs, out=buf.numpy())
            out[k] = buf
        return out

    def _place_chunk(self, host: dict) -> dict:
        """A stacked chunk on the device, copied without waiting; records
        the fence ``_stack_chunk`` waits on before refilling its buffers."""
        placed = {k: v.to(self.device, non_blocking=True)
                  for k, v in host.items()}
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._chunk_events[self._chunk_flip] = event
        return placed

    # ---------------------------------------------------------------- method
    def _build_model(self, pretrained: bool = True):
        """The codebook, the model, its loss and the eval steps (one and
        ``train_chunk`` at a time); with ``pretrained``, the backbone's
        pretrained vision weights laid over the init."""
        cfg = self.config
        try:
            self.codebook = prepare_codebook(
                self.method, cfg, self.logdir if self.writes else None,
                device=self.device)
        except Exception as e:
            logging.warning("codebook stage failed (%s); offline fallback", e)
            from concepthash_tpu_torch.data.manifest import read_class_names
            from concepthash_tpu_torch.models.backbone_factory import (
                vision_config_from_backbone_cfg)

            root = os.path.join(cfg.get("data_dir", "."),
                                cfg["dataset"]["data_folder"])
            names = read_class_names(root)
            # fallback embedding width: explicit center_dim, else the
            # image-text joint width of the configured backbone
            dim = int(cfg["model"].get("center_dim", 0) or
                      vision_config_from_backbone_cfg(
                          cfg.get("backbone", {}) or {}).projection_dim)
            self.codebook = prepare_codebook(
                self.method, cfg, self.logdir,
                text_embedder=lambda n: offline_text_embedder(n, dim=dim))
        if self.mesh is not None and self.codebook is not None:
            self.codebook = broadcast_array(
                np.asarray(self.codebook, np.float32), self.mesh)

        if cfg["model"].get("filip"):
            self._prepare_filip_tokens()
        self.model, self.loss_fn = build_model(cfg, self.codebook,
                                               device=self.device)
        if pretrained:      # the overlay after init, before any step
            maybe_load_pretrained_vision(cfg.get("backbone", {}) or {},
                                         self.model)
        self.eval_step = make_eval_step(self.model, self.loss_fn, self.mesh)
        # a batch every rank runs whole (the padded eval tail)
        self.eval_step_whole = (make_eval_step(self.model, self.loss_fn)
                                if self.mesh is not None else self.eval_step)
        self.train_chunk = resolve_train_chunk(cfg.get("train_chunk", "auto"),
                                               self.device)
        if self.debug.disable_jit or self.debug.nans:
            # eager steps, each one checkable on the host
            self.train_chunk = 1
        self.eval_multi_step = (make_multi_eval_step(self.model, self.loss_fn,
                                                     self.mesh)
                                if self.train_chunk > 1 else None)
        logging.info("train_chunk %d (%s)", self.train_chunk,
                     cfg.get("train_chunk", "auto"))

    def _prepare_filip_tokens(self):
        """FILIP's token-level class-text embeddings (nclass, T, proj) into
        ``config['model']['token_embeds_array']``: the text stage of the
        backbone's local CLIP checkpoint, or, where it is not there, 8
        deterministic pseudo-tokens a class (loudly logged), as the
        reference falls back."""
        from concepthash_tpu_torch.data.manifest import read_class_names
        from concepthash_tpu_torch.models.backbone_factory import (
            vision_config_from_backbone_cfg)
        from concepthash_tpu_torch.train.codebook import \
            embed_class_name_tokens

        cfg = self.config
        root = os.path.join(cfg.get("data_dir", "."),
                            cfg["dataset"]["data_folder"])
        names = read_class_names(root)
        try:
            te = embed_class_name_tokens(
                names, (cfg.get("backbone", {}) or {}).get(
                    "name", "openai/clip-vit-base-patch32"),
                device=self.device)
        except Exception as e:  # no local checkpoint: the fallback
            logging.warning("FILIP token embeddings unavailable (%s); "
                            "deterministic pseudo-tokens", e)
            dim = vision_config_from_backbone_cfg(
                cfg.get("backbone", {}) or {}).projection_dim
            te = np.stack([_pseudo_embeddings([f"{n}#{t}" for t in range(8)],
                                              dim=dim) for n in names])
        cfg["model"]["token_embeds_array"] = te

    def _build_training(self):
        """The optimizer, schedule and train steps (one and ``train_chunk``
        at a time) over the built model, and the train state."""
        cfg = self.config
        self.epochs = int(cfg.get("epochs", 100))
        self.steps_per_epoch = max(len(self.loaders["train"]), 1)
        loss_fn = self.loss_fn
        if self.method.regime == "adsh":
            # the schedule on the regime's own step count (SGD on a subset
            # of num_samples rows, max_iters passes an epoch)
            self.adsh_settings = _adsh_settings(cfg,
                                                len(self.datasets["train"]))
            self.steps_per_epoch = self.adsh_settings["steps"]
            loss_fn = self._adsh_loss()
        self.training = tr = training_for(cfg, self.model, loss_fn,
                                          self.steps_per_epoch, self.mesh)
        self._structure = None      # SSDH's, built before its first epoch
        self._odc_ready = False     # ODC's memory, seeded before it
        self.train_step = tr.step
        seed = int(cfg.get("seed", 42))
        # augmentation draws: crops, flips and magnitudes on the device,
        # TrivialAugment's op indices on the host
        self.aug_generator = torch.Generator(device=self.device).manual_seed(
            seed + 2)
        self.op_generator = torch.Generator().manual_seed(seed + 3)
        self.state = create_train_state(
            self.model, tr.optimizer, tr.scheduler,
            {"dropout": tr.generator, "augment": self.aug_generator,
             "op": self.op_generator}, loader=self.loaders["train"],
            extra=tr.extra)
        single = tr.custom or self.method.regime != "sgd"
        if single and self.train_chunk > 1:
            # the reference builds no multi step for a method's own step,
            # nor for the adsh regime
            logging.info("train_chunk %d does not apply to %s's own train "
                         "step: one step a dispatch (eval still chunks)",
                         self.train_chunk, self.method.name)
        self.train_multi_step = (make_multi_train_step(
            self.model, tr.loss_fn, tr.optimizer, tr.scheduler,
            output_attentions=self.method.needs_attentions(cfg),
            generator=tr.generator, mesh=self.mesh,
            views=2 if self.method.two_view else 1)
            if self.train_chunk > 1 and not single else None)

    # ------------------------------------------------------------------ train
    def _train_images(self, x: torch.Tensor) -> torch.Tensor:
        """The train preprocessing of a device batch of uint8 images; a
        ``two_view`` method's is two augmentations of the same images,
        drawn one after the other, stacked ``[v1; v2]``. Under a mesh ``x``
        is this rank's block, drawn for at the global batch's size."""
        def view():
            return preprocess_batch(x, self.aug_generator, crop=self.crop,
                                    norm=self.norm, train=True,
                                    augment=self.augment,
                                    op_generator=self.op_generator,
                                    mesh=self.mesh)

        if self.method.two_view:
            return torch.cat([view(), view()])
        return view()

    def _extract_train_matrix(self, encode_batch) -> np.ndarray:
        """The (N_train, D) float32 matrix of ``encode_batch(batch)`` (a
        (B, D) device tensor for a loader batch) in dataset order: an
        unshuffled loader without ``drop_last``, rows scattered by the
        batch's index, the padded tail masked by ``n_valid``. One copy to
        the host at the end."""
        bs = int(self.config.get("batch_size", 64))
        loader = Loader(self.datasets["train"], bs, shuffle=False,
                        drop_last=False, **self._loader_kw)
        rows, index = [], []
        try:
            for batch in loader:
                nv = batch.pop("n_valid")
                rows.append(encode_batch(batch)[:nv])
                index.append(batch["index"][:nv])
        finally:
            loader.close()
        arr = torch.cat(rows).float().cpu().numpy()
        feats = np.zeros((len(self.datasets["train"]), arr.shape[1]),
                         np.float32)
        feats[np.concatenate(index)] = arr
        return feats

    def _eval_codes_batch(self, batch) -> torch.Tensor:
        """The eval step's codes of a whole (padded) loader batch (under a
        mesh, each rank's block encoded and the codes gathered)."""
        part = self._local(batch)
        images = preprocess_batch(self._on_device(part["image"]),
                                  crop=self.crop, norm=self.norm,
                                  train=False)
        codes, _ = self.eval_step({"image": images,
                                   "label": self._on_device(part["label"])})
        return codes["codes"]

    def _prepare_structure(self):
        """SSDH's pairwise structure from the current model's eval codes of
        the train split, in dataset order (the structure is indexed by
        dataset index), with the criterion's ``alpha``."""
        from concepthash_tpu_torch.losses.unsupervised import ssdh_structure

        codes = self._extract_train_matrix(self._eval_codes_batch)
        alpha = float((self.config.get("criterion") or {}).get("alpha", 2.0))
        self._structure = ssdh_structure(codes, alpha=alpha)
        logging.info("ssdh structure: %.1f%% positive, %.1f%% negative",
                     100 * (self._structure > 0).mean(),
                     100 * (self._structure < 0).mean())

    def _odc_setup(self):
        """ODC's memory from a k-means of the train split's L2-normalized
        eval codes in dataset order, on the run's device: the codes, the
        cluster labels, the centroids, and the weights N_c^-0.5 normalized
        to mean 1 over the non-empty clusters, into the train state's
        extras."""
        from concepthash_tpu_torch.train.custom_steps import odc_init_weights
        from concepthash_tpu_torch.train.kmeans import kmeans

        extra = self.training.extra
        k = extra["centroids"].shape[0]
        feats = torch.from_numpy(self._extract_train_matrix(
            self._eval_codes_batch)).to(self.device)
        feats = feats / torch.linalg.vector_norm(
            feats, dim=1, keepdim=True).clamp_min(1e-12)
        labels, centers, _ = kmeans(feats, k, int(self.config.get("seed",
                                                                  42)))
        counts = torch.bincount(labels, minlength=k).float()
        extra["features"].copy_(feats)
        extra["labels"].copy_(labels)
        extra["centroids"].copy_(centers)
        extra["weights"].copy_(odc_init_weights(counts))
        if self.mesh is not None:   # one clustering on every rank
            for t in extra.values():
                broadcast_(t, self.mesh)
        self._odc_ready = True
        logging.info("odc: initial k-means into %d clusters (largest "
                     "%.1f%%)", k, 100 * float(counts.max())
                     / max(len(feats), 1))

    def train_one_epoch(self, ep: int) -> dict:
        if self.method.needs_structure and self._structure is None:
            self._prepare_structure()
        if self.method.regime == "odc" and not self._odc_ready:
            self._odc_setup()
        meters = MeterBank()
        t0 = time.time()
        pending: list = []          # (batch, n_valid) awaiting a chunk

        def run_chunk():
            placed = self._place_chunk(self._stack_chunk(
                [self._local(b) for b, _ in pending]))
            placed["image"] = torch.stack([self._train_images(x)
                                           for x in placed["image"]])
            self.profiler.step_start()
            metrics = self.train_multi_step(placed)
            self.profiler.step_end()
            meters.update_device(metrics, [n for _, n in pending])
            pending.clear()

        def run_single(batch, n):
            batch = self._local(batch)
            step_batch = {"image": self._train_images(
                              self._on_device(batch["image"])),
                          "label": self._on_device(batch["label"])}
            if "aux" in batch:
                step_batch["aux"] = self._on_device(batch["aux"])
            if self.training.custom:    # a method's own step reads the rows
                step_batch["index"] = self._on_device(batch["index"])
            self.profiler.step_start()
            metrics = self.train_step(step_batch)
            self.profiler.step_end()
            if self.debug.nans:
                check_finite(metrics, self.model)
            meters.update_device(metrics, n)

        for batch in self.loaders["train"]:
            n = batch.pop("n_valid")
            if self.method.needs_structure:
                idx = batch["index"]
                batch["aux"] = self._structure[np.ix_(idx, idx)]
            if self.train_multi_step is not None:
                pending.append((batch, n))
                if len(pending) == self.train_chunk:
                    run_chunk()
                continue
            run_single(batch, n)
        for batch, n in pending:    # a tail shorter than the chunk
            run_single(batch, n)
        pending.clear()
        res = meters.materialize()      # the epoch's one wait on the device
        res["time"] = time.time() - t0
        res["lr"] = current_lr(self.config.get("optim", {}) or {},
                               self.config.get("scheduler", {}) or {},
                               self.epochs, self.steps_per_epoch,
                               self.state.step)
        return res

    # ------------------------------------------------------------------- eval
    def encode_split(self, split: str):
        """Encode a split: ({codes_key: (N, nbit) device tensor}, labels
        (N, C) numpy, {metric: mean}). Full batches go ``train_chunk`` at a
        time through the multi eval step; the rest, and the padded tail
        batch at its valid rows only (so padding never enters the codes or
        the meters), through the single eval step."""
        all_codes: dict[str, list] = {}
        labels = []
        meters = MeterBank()
        bs = int(self.config.get("batch_size", 64))
        pending: list = []

        def flush_chunk():
            placed = self._place_chunk(self._stack_chunk(
                [self._local(b) for b, _ in pending]))
            K, B = placed["image"].shape[:2]
            images = preprocess_batch(placed["image"].flatten(0, 1),
                                      crop=self.crop, norm=self.norm,
                                      train=False).unflatten(0, (K, B))
            codes, metrics = self.eval_multi_step(
                {"image": images, "label": placed["label"]})
            ns = [n for _, n in pending]
            if metrics:
                meters.update_device(metrics, ns)
            for k, v in codes.items():
                all_codes.setdefault(k, []).extend(v[i, :n]
                                                   for i, n in enumerate(ns))
            labels.extend(b["label"][:n] for b, n in pending)
            pending.clear()

        def run_single(batch, n):
            # a full batch takes the (sharded) eval step; a shorter one
            # runs whole on every rank, at its valid rows
            part, step = ((self._local(batch), self.eval_step) if n == bs
                          else ({k: v[:n] for k, v in batch.items()},
                                self.eval_step_whole))
            images = preprocess_batch(self._on_device(part["image"]),
                                      crop=self.crop, norm=self.norm,
                                      train=False)
            codes, metrics = step(
                {"image": images, "label": self._on_device(part["label"])})
            if metrics:
                meters.update_device(metrics, n)
            for k, v in codes.items():
                all_codes.setdefault(k, []).append(v)
            labels.append(batch["label"][:n])

        for batch in self.loaders[split]:
            n = batch.pop("n_valid")
            if self.eval_multi_step is not None and n == bs:
                pending.append((batch, n))
                if len(pending) == self.train_chunk:
                    flush_chunk()
                continue
            for b2, n2 in pending:
                run_single(b2, n2)
            pending.clear()
            run_single(batch, n)
        for b2, n2 in pending:
            run_single(b2, n2)
        return ({k: torch.cat(v) for k, v in all_codes.items()},
                np.concatenate(labels), meters.materialize())

    def evaluation(self, ep: int):
        cfg = self.config
        test_codes, test_labels, test_meters = self.encode_split("test")
        db_codes, db_labels, _ = self.encode_split("db")
        res = {"ep": ep, **{f"test_{k}": v for k, v in test_meters.items()}}
        for key in test_codes:
            postfix = "" if key == "codes" else "_" + key.split("_", 1)[0]
            mAP, recalls, precisions = calculate_mAP(
                db_codes[key], db_labels, test_codes[key], test_labels,
                R=cfg.get("dataset", {}).get("R", -1),
                dist_metric=cfg.get("dist_metric", "hamming"),
                PRs=tuple(cfg.get("PRs", (1, 5, 10))),
                zero_mean=bool(cfg.get("zero_mean_eval", False)),
                device=self.device)
            res["mAP" + postfix] = mAP
            res["recalls" + postfix] = recalls
            res["precisions" + postfix] = precisions
        if self.method.regime == "odc" and self._odc_ready:
            self._odc_nmi(res, (("test", test_codes, test_labels),
                                ("db", db_codes, db_labels)))
        logging.info("ep %d eval: mAP=%s", ep, res.get("mAP"))
        return res, (test_codes, test_labels, db_codes, db_labels)

    def _odc_nmi(self, res: dict, splits) -> None:
        """``<split>_nmi``: the NMI between each split's true classes and
        the nearest-centroid labels of its L2-normalized codes (float32 on
        the host, as the reference scores them)."""
        cents = self.training.extra["centroids"].float().cpu().numpy()
        for name, codes, labels in splits:
            c = codes["codes"].float().cpu().numpy()
            c /= np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
            d2 = ((c ** 2).sum(1, keepdims=True) - 2.0 * c @ cents.T
                  + (cents ** 2).sum(1))
            gt = labels.argmax(1) if labels.ndim > 1 else labels
            res[f"{name}_nmi"] = normalized_mutual_info(gt, d2.argmin(1))
            logging.info("%s NMI: %.4f", name, res[f"{name}_nmi"])

    # ------------------------------------------------------------- checkpoint
    def model_state_blob(self, ep: int) -> dict:
        return {"model": self.model.state_dict(), "epoch": ep}

    def save_model(self, name: str, ep: int):
        if not self.writes:
            return
        io.fast_save(self.model_state_blob(ep),
                     os.path.join(self.logdir, "models", f"{name}.pt"))
        if self.config.get("save_training_state", False):
            io.fast_save({**self.state.state_dict(), "epoch": ep},
                         os.path.join(self.logdir, "optims", f"{name}.pt"))

    def _state_dict_from(self, path: str) -> tuple[dict, int]:
        """(state dict, epoch) of a port checkpoint (.pt) or a JAX package
        checkpoint (.msgpack)."""
        if path.endswith(".msgpack"):
            blob = io.load_jax_checkpoint(path)
            if "params" not in blob:
                raise _not_a_network(path, blob)
            return _jax_bridge(blob["params"])(blob), int(blob.get("epoch",
                                                                   0))
        blob = io.load_checkpoint(path)
        if "model" not in blob:
            raise _not_a_network(path, blob)
        return blob["model"], int(blob.get("epoch", 0))

    def load_model_state(self, path: str) -> int:
        """Load a checkpoint strictly (every tensor, every shape: a shape
        that differs raises and names ``finetune_path``); returns its
        epoch."""
        sd, ep = self._state_dict_from(path)
        _check_shapes(self.model.state_dict(), sd, path)
        self.model.load_state_dict(sd, strict=True)
        return ep

    def finetune_init(self, path: str):
        """Initialize the model's weights from another run before training
        (fresh optimizer, step and history). Accepts a checkpoint file or a
        run directory (best, then last; the port's .pt, then the JAX
        package's .msgpack). Tensors missing from the checkpoint or of
        another shape (a head for a new nclass) keep their fresh init."""
        if os.path.isdir(path):
            for name in ("best.pt", "last.pt", "best.msgpack",
                         "last.msgpack"):
                cand = os.path.join(path, "models", name)
                if os.path.exists(cand):
                    path = cand
                    break
        if not os.path.exists(path):
            raise FileNotFoundError(f"finetune_path: no checkpoint at {path}")
        sd, _ = self._state_dict_from(path)
        own = self.model.state_dict()
        keep = {k: v for k, v in sd.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.model.load_state_dict(keep, strict=False)
        logging.info("finetune: loaded %d tensors from %s (%d kept fresh "
                     "init); optimizer state starts fresh", len(keep), path,
                     len(own) - len(keep))

    def resume_training(self, resume_logdir: str):
        """Continue the run in ``resume_logdir`` after its last epoch: the
        model from ``models/last.pt`` (strictly), the train state from
        ``optims/last.pt`` when the run saved it, the histories, the start
        epoch and the best metric so far. A JAX package run
        (``models/last.msgpack``, ``optims/last.msgpack``) resumes as well:
        its weights through the flax -> torch bridge, its optax state onto
        the optimizer (``train/optax_state.py``), its step count onto the
        schedule and its epoch onto the train loader; its PRNG key has no
        counterpart, so the generators keep this run's seeding."""
        models = os.path.join(resume_logdir, "models")
        ext = next((e for e in (".pt", ".msgpack")
                    if os.path.exists(os.path.join(models, "last" + e))),
                   None)
        if ext is None:
            logging.warning("resume requested but %s has no last.pt or "
                            "last.msgpack", models)
            return
        last = os.path.join(models, "last" + ext)
        ep = self.load_model_state(last)
        opt = os.path.join(resume_logdir, "optims", "last" + ext)
        if os.path.exists(opt) and ext == ".msgpack":
            self._resume_optax(opt, last)
        elif os.path.exists(opt):
            blob = io.load_checkpoint(opt)
            self.state.load_state_dict(blob)
            self._odc_ready = "extra" in blob
        for h in (self.train_history, self.test_history):
            src = os.path.join(resume_logdir, os.path.basename(h.path))
            if os.path.exists(src):
                with open(src) as f:
                    h.history = json.load(f)
        self.start_epoch = ep + 1
        ms = [r.get(self.eval_metric) for r in self.test_history.history
              if r.get(self.eval_metric) is not None]
        # the lowest for a lower-is-better metric (GeneralExperiment's
        # test_loss), or a resumed run would take its worst as the best
        self.best_metric = ((max(ms) if self.higher_is_better else min(ms))
                            if ms else None)
        logging.info("resumed from %s at epoch %d", resume_logdir,
                     self.start_epoch)

    def _resume_optax(self, opt_path: str, model_path: str) -> None:
        """The JAX run's optimizer state, schedule step and loader epoch."""
        from concepthash_tpu_torch.train.optax_state import load_optax_state
        from concepthash_tpu_torch.train.optim import (is_backbone_param,
                                                       set_schedule_step)

        cfg = self.config
        blob = io.load_jax_checkpoint(opt_path)
        model_blob = io.load_jax_checkpoint(model_path)
        tr = self.training
        labelled = float(cfg.get("backbone_lr_scale", 1.0)) != 1.0 and any(
            is_backbone_param(n) for n, _ in self.model.named_parameters())
        step = load_optax_state(tr.optimizer, self.model, blob, model_blob,
                                _jax_bridge(model_blob["params"]),
                                cfg.get("optim", {}) or {}, labelled)
        set_schedule_step(tr.optimizer, tr.scheduler, step)
        self.loaders["train"].epoch = int(blob.get("epoch", 0)) + 1
        logging.info("resumed the JAX run's optimizer state at step %d; its "
                     "PRNG key is not carried (the generators keep this "
                     "run's seeding)", step)

    # ------------------------------------------------------------------- main
    def main(self):
        if self.idle:
            return None
        if self.method.regime == "shallow":
            return self._main_shallow()
        if self.method.regime == "adsh":
            return self._main_adsh()
        cfg = self.config
        eval_interval = int(cfg.get("eval_interval", 10))
        save_interval = int(cfg.get("save_interval", 0))
        with guarded_training() as guard:
            for ep in range(self.start_epoch, self.epochs):
                train_res = self.train_one_epoch(ep)
                self.train_history.append({"ep": ep, **train_res})
                logging.info("ep %d train: loss=%.4f (%.1fs, lr %.2e)", ep,
                             train_res.get("loss", float("nan")),
                             train_res["time"], train_res["lr"])
                is_last = ep == self.epochs - 1
                if is_last or (eval_interval > 0 and
                               (ep + 1) % eval_interval == 0):
                    res, dumps = self.evaluation(ep)
                    self.test_history.append(res)
                    metric = res.get(self.eval_metric)
                    better = (metric is not None and
                              (self.best_metric is None or
                               (metric > self.best_metric
                                if self.higher_is_better
                                else metric < self.best_metric)))
                    if better:
                        self.best_metric = metric
                        self.save_model("best", ep)
                        self._dump_codes(dumps)
                self.save_model("last", ep)
                if save_interval and (ep + 1) % save_interval == 0:
                    self.save_model(f"ep{ep + 1}", ep)
                if guard.should_stop:  # preemption: checkpointed; stop clean
                    logging.warning("stopping at epoch %d (preemption); "
                                    "resume with resume_logdir=%s", ep,
                                    self.logdir)
                    break
        self.profiler.close()
        io.join_save_queue()
        for loader in self.loaders.values():
            loader.close()
        logging.info("done: best %s = %s", self.eval_metric, self.best_metric)
        return self.best_metric

    def _dump_codes(self, dumps):
        if not self.writes:
            return
        test_codes, test_labels, db_codes, db_labels = dumps
        io.fast_save({"codes": test_codes["codes"], "labels": test_labels},
                     os.path.join(self.logdir, "outputs", "test_best.pt"))
        io.fast_save({"codes": db_codes["codes"], "labels": db_labels},
                     os.path.join(self.logdir, "outputs", "db_best.pt"))


    # -------------------------------------------------------- shallow regime
    def _extract_fit_features(self) -> np.ndarray:
        """The (N_train, D) features the shallow fit takes, through the
        train preprocessing (random crop, flip and the config's
        augmentation), the model in eval mode, in dataset order. A fit on
        center crops locks onto directions the augmentation moves (the
        reference measured -0.17 mAP for it). The draws come from
        generators seeded by the run's seed."""
        seed = int(self.config.get("seed", 42))
        aug = torch.Generator(device=self.device).manual_seed(seed)
        ops = torch.Generator().manual_seed(seed + 1)

        def encode(batch):      # a whole (padded) batch, as the draws see it
            part = self._local(batch)
            images = preprocess_batch(
                self._on_device(part["image"]), aug, crop=self.crop,
                norm=self.norm, train=True, augment=self.augment,
                op_generator=ops, mesh=self.mesh)
            codes, _ = self.eval_step({
                "image": images, "label": self._on_device(part["label"])})
            return codes["codes"]

        return self._extract_train_matrix(encode)

    def _main_shallow(self):
        """The one-pass fit: the train features through the train
        augmentation, the criterion's fitter on them, the test and database
        splits encoded with the eval pipeline and the fit, scored."""
        from concepthash_tpu_torch.losses.shallow import (FITTERS,
                                                          encode_shallow)

        cfg = self.config
        name = cfg["model"]["name"]
        fit_feats = self._extract_fit_features()
        fit_kwargs = dict(cfg.get("criterion", {}) or {})
        fit_kwargs.pop("name", None)
        fit_state = FITTERS[name](fit_feats, int(cfg["model"]["nbit"]),
                                  **fit_kwargs)
        if self.writes:
            io.fast_save({"criterion": fit_state, "epoch": 0},
                         os.path.join(self.logdir, "models", "best.pt"))
        test_feats, test_labels, _ = self.encode_split("test")
        db_feats, db_labels, _ = self.encode_split("db")
        test_codes, db_codes = (
            encode_shallow(fit_state, f["codes"].float().cpu().numpy())
            for f in (test_feats, db_feats))
        mAP, recalls, precisions = calculate_mAP(
            db_codes, db_labels, test_codes, test_labels,
            R=cfg.get("dataset", {}).get("R", -1),
            PRs=tuple(cfg.get("PRs", (1, 5, 10))), device=self.device)
        self.test_history.append({"ep": 0, "mAP": mAP, "recalls": recalls,
                                  "precisions": precisions})
        self.best_metric = mAP
        io.join_save_queue()
        for loader in self.loaders.values():
            loader.close()
        logging.info("shallow %s: mAP=%.4f", name, mAP)
        return mAP

    # ----------------------------------------------------------- adsh regime
    def _adsh_loss(self):
        """The asymmetric loss over ``batch['adsh']`` (S, V, V_omega); tanh
        on the codes unless the model's codes are already activated."""
        pre_act = bool(getattr(self.model, "codes_activated", False))
        gamma = self.adsh_settings["gamma"]
        nbit = self.adsh_settings["nbit"]

        def loss_fn(outputs, batch):
            return adsh_loss(outputs, batch["adsh"], gamma=gamma, nbit=nbit,
                             apply_tanh=not pre_act)

        return loss_fn

    def _act(self, codes: torch.Tensor) -> torch.Tensor:
        if getattr(self.model, "codes_activated", False):
            return codes
        return torch.tanh(codes)

    def _main_adsh(self):
        """The alternating optimization of the ``adsh`` regime: each epoch,
        SGD over a resampled subset against the stored database codes V,
        then V's discrete update from the subset's fresh codes."""
        cfg = self.config
        a = self.adsh_settings
        gamma, nbit, num_samples = a["gamma"], a["nbit"], a["num_samples"]
        seed = int(cfg.get("seed", 42))
        bs = int(cfg.get("batch_size", 64))
        dev = self.device
        train_ds = self.datasets["train"]
        n_train = len(train_ds)
        rng = np.random.default_rng(seed)
        train_onehot = train_ds.onehot_labels()
        onehot_dev = torch.from_numpy(train_onehot).to(dev)
        V = torch.from_numpy(np.sign(rng.standard_normal(
            (n_train, nbit))).astype(np.float32)).to(dev)
        for ep in range(self.epochs):
            t0 = time.time()
            omega = rng.choice(n_train, num_samples, replace=False)
            sub = train_ds.subset(omega)
            loader = Loader(sub, bs, shuffle=True, drop_last=True,
                            seed=seed + ep, **self._loader_kw)
            omega_dev = torch.from_numpy(omega).to(dev)
            # the hard {-1, +1} pair matrix, softened: both the loss and
            # the DCC take it
            S_full = soften_sim(get_sim(onehot_dev[omega_dev], onehot_dev)
                                .float() * 2 - 1)
            meters = MeterBank()
            for _ in range(a["inner_epochs"]):
                for batch in loader:
                    n = batch.pop("n_valid")
                    # drop_last: every row valid; positions within omega
                    # (the global batch's: the loss reads gathered codes)
                    pos = torch.from_numpy(batch["index"].astype(np.int64)) \
                        .to(dev)
                    part = self._local(batch)
                    images = preprocess_batch(
                        self._on_device(part["image"]), self.aug_generator,
                        crop=self.crop, norm=self.norm, train=True,
                        augment=self.augment, op_generator=self.op_generator,
                        mesh=self.mesh)
                    metrics = self.train_step({
                        "image": images,
                        "label": self._on_device(part["label"]),
                        "adsh": {"S": S_full[pos], "V": V,
                                 "V_omega": V[omega_dev[pos]]}})
                    meters.update_device(metrics, n)
            loader.close()
            # the subset's codes from the trained model, each batch padded
            # as the reference's eval step takes it, then V's update
            sub_loader = Loader(sub, bs, **self._loader_kw)
            us, sub_pos = [], []
            for batch in sub_loader:
                n = batch.pop("n_valid")
                images = preprocess_batch(
                    self._on_device(self._local(batch)["image"]),
                    crop=self.crop, norm=self.norm, train=False)
                codes, _ = self.eval_step({"image": images})
                us.append(self._act(codes["codes"][:n]))
                sub_pos.append(batch["index"][:n])
            sub_loader.close()
            sub_pos = torch.from_numpy(np.concatenate(sub_pos).astype(
                np.int64)).to(dev)
            # DCC takes the continuous codes: their magnitude carries
            # confidence into the bit updates
            V = solve_dcc(V, torch.cat(us), S_full[sub_pos],
                          omega_dev[sub_pos], gamma, nbit)
            if self.mesh is not None:   # one V on every rank
                broadcast_(V, self.mesh)
            res = meters.materialize()
            self.train_history.append({"ep": ep, **res})
            logging.info("adsh ep %d: loss=%.4f (%.1fs)", ep,
                         res.get("loss", float("nan")), time.time() - t0)

        # the database codes are the stored V
        test_codes, test_labels, _ = self.encode_split("test")
        mAP, recalls, precisions = calculate_mAP(
            V, train_onehot, self._act(test_codes["codes"]), test_labels,
            R=cfg.get("dataset", {}).get("R", -1),
            PRs=tuple(cfg.get("PRs", (1, 5, 10))), device=dev)
        self.test_history.append({"ep": self.epochs - 1, "mAP": mAP,
                                  "recalls": recalls,
                                  "precisions": precisions})
        self.save_model("best", self.epochs - 1)
        if self.writes:
            io.fast_save({"V": V}, os.path.join(self.logdir, "outputs",
                                                "db_codes.pt"))
        io.join_save_queue()
        for loader in self.loaders.values():
            loader.close()
        self.best_metric = mAP
        logging.info("adsh: mAP=%.4f", mAP)
        return mAP


def _not_a_network(path: str, blob: dict) -> ValueError:
    """A checkpoint without a network's weights: a shallow run's holds the
    fit (``criterion``), which cannot be evaluated as a model."""
    return ValueError(
        f"{path} is not a network checkpoint (keys: {sorted(blob)}); "
        "shallow-method runs (itq/pca/lsh/sh) store the fitted criterion, "
        "which exp=validation cannot re-evaluate as a model")


def _adsh_settings(cfg: dict, n_train: int) -> dict:
    """The adsh regime's criterion keys, and its optimizer steps an
    epoch."""
    crit = dict(cfg.get("criterion", {}) or {})
    num_samples = min(int(crit.get("num_samples", 2000)), n_train)
    inner = int(crit.get("max_iters", crit.get("inner_epochs", 3)))
    bs = int(cfg.get("batch_size", 64))
    return {"gamma": float(crit.get("gamma", 200.0)),
            "nbit": int(cfg["model"]["nbit"]), "num_samples": num_samples,
            "inner_epochs": inner,
            "steps": max(1, inner * (num_samples // bs))}


class GeneralExperiment(RetrievalExperiment):
    """Train with a test-loss evaluation and no retrieval: the best run has
    the lowest test loss."""

    eval_metric = "test_loss"
    higher_is_better = False

    def evaluation(self, ep: int):
        _, _, test_meters = self.encode_split("test")
        res = {"ep": ep, **{f"test_{k}": v for k, v in test_meters.items()}}
        res["test_loss"] = res.get("test_loss", test_meters.get("loss", 0.0))
        return res, None

    def _dump_codes(self, dumps):
        pass


class RetrievalEvaluation:
    """Eval-only: load a run's checkpoint, encode, score — with sub-code
    slicing, zero-mean, the ternary threshold, the test split as database,
    PR curves and code export — into ``eval_logdir`` (``history.json``,
    ``outputs.pt``, ``log.txt``)."""

    def __init__(self, config: dict, device=None):
        self.config = config
        self.eval_logdir = config.get(
            "eval_logdir", os.path.join(config["logdir"], "evaluations"))
        self.exp = exp = RetrievalExperiment(config, device,
                                             eval_logdir=self.eval_logdir)
        if exp.idle:
            return
        name = "last" if config.get("use_last") else "best"
        for ext in (".pt", ".msgpack"):
            path = os.path.join(exp.logdir, "models", name + ext)
            if os.path.exists(path):
                exp.load_model_state(path)
                logging.info("evaluating %s", path)
                break
        else:
            logging.warning("checkpoint %s missing — evaluating current init",
                            os.path.join(exp.logdir, "models", name + ".pt"))
            maybe_load_pretrained_vision(config.get("backbone", {}) or {},
                                         exp.model)

    def main(self) -> dict:
        cfg = self.config
        exp = self.exp
        if exp.idle:
            return None
        test_codes, test_labels, test_meters = exp.encode_split("test")
        res = {f"test_{k}": v for k, v in test_meters.items()}

        if exp.writes and (cfg.get("exp") == "extract"
                           or cfg.get("save_code")):
            io.fast_save({"test": {**test_codes, "labels": test_labels}},
                         os.path.join(self.eval_logdir, "outputs.pt"))
        if cfg.get("exp") == "extract":
            return self._finish(res, write=False)

        if cfg.get("test_as_database"):
            db_codes, db_labels = test_codes, test_labels
            drop_first = True
        else:
            db_codes, db_labels, _ = exp.encode_split("db")
            drop_first = False

        for key in test_codes:
            postfix = "" if key == "codes" else "_" + key.split("_", 1)[0]
            tc, dc = test_codes[key], db_codes[key]
            if cfg.get("sub_code_eval"):
                s = cfg.get("sub_code_eval_setting", {}) or {}
                if int(s.get("rand_bits", 0)):
                    rng = np.random.default_rng(int(cfg.get("seed", 42)))
                    bits = rng.permutation(tc.shape[1])[:int(s["rand_bits"])]
                else:
                    end = int(s.get("end_bit", -1))
                    if end < 0:
                        end = tc.shape[1]
                    bits = np.arange(int(s.get("start_bit", 0)), end)
                bits = torch.as_tensor(bits, device=tc.device)
                tc, dc = tc[:, bits], dc[:, bits]
            common = dict(dist_metric=cfg.get("dist_metric", "hamming"),
                          threshold=float(cfg.get("ternary_threshold", 0) or 0),
                          remove_first_retrieved=drop_first,
                          device=exp.device)
            # cutoff precedence: an explicit top-level R wins, else the
            # dataset group's R
            R_cfg = cfg.get("R", -1)
            if R_cfg in (-1, None) and isinstance(cfg.get("dataset"), dict):
                R_cfg = cfg["dataset"].get("R", -1)
            if cfg.get("compute_mAP", True):
                mAPs, recalls, precisions = calculate_mAP(
                    dc, db_labels, tc, test_labels, R=R_cfg,
                    PRs=tuple(cfg.get("PRs", (1, 5, 10))),
                    zero_mean=bool(cfg.get("zero_mean_eval", False)),
                    **common)
                res["mAP" + postfix] = mAPs
                res["recalls" + postfix] = recalls
                res["precisions" + postfix] = precisions
                logging.info("%s: mAP@%s = %s", key, R_cfg, mAPs)
            else:
                recalls, precisions, Rs = calculate_pr_curve(
                    dc, db_labels, tc, test_labels, **common)
                res["recalls" + postfix] = recalls
                res["precisions" + postfix] = precisions
                res["Rs" + postfix] = Rs
        return self._finish(res, write=True)

    def _finish(self, res: dict, write: bool) -> dict:
        if write and self.exp.writes:
            with open(os.path.join(self.eval_logdir, "history.json"),
                      "w") as f:
                json.dump(_to_jsonable(res), f, indent=2)
        io.join_save_queue()
        for loader in self.exp.loaders.values():
            loader.close()
        return res
