"""The train + retrieve experiment (counterpart of the ``sgd`` regime of
concepthash_tpu/experiments/hashing.py ``RetrievalExperiment``).

One run: the codebook stage, the model and its train step
(``methods.build_training``), then epochs of training with a retrieval
evaluation every ``eval_interval`` epochs and at the last, tracking the best
mAP. Each batch crosses host -> device as uint8 from pinned memory and is
preprocessed and augmented on the device (``data/preprocess.py``); eval
encodes every batch, the padded tail at its valid rows, and scores with
``ops.retrieval.calculate_mAP`` on the device.

The run directory is the reference's, with ``.pt`` files in place of its
``.msgpack``: ``config.yaml``, ``log.txt``, ``train_history.json``,
``test_history.json``, ``events.jsonl`` (when ``wandb: true``),
``models/{best,last}.pt`` (the model's state dict and the epoch),
``outputs/{test,db}_best.pt`` (codes and labels) and, when the text stage
ran, ``outputs/codebook.pt``. ``finetune_path`` takes a port checkpoint, or
a JAX package checkpoint or run directory (read with
``utils.io.load_jax_checkpoint`` and carried across by
``weights.from_flax``).

Not ported, and raising ``NotImplementedError``: the other regimes and
methods (``methods.get_method``), FILIP, ``train_chunk > 1``,
``resume_logdir`` and ``save_training_state``, ``native_decode``, and the
``profile`` and ``debug`` diagnostics.
"""

from __future__ import annotations

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
from concepthash_tpu_torch.methods import (build_training, get_method,
                                           prepare_codebook)
from concepthash_tpu_torch.ops.retrieval import calculate_mAP
from concepthash_tpu_torch.train.optim import current_lr
from concepthash_tpu_torch.train.state import make_eval_step
from concepthash_tpu_torch.utils import io
from concepthash_tpu_torch.utils.diagnostics import guarded_training
from concepthash_tpu_torch.utils.logger import (HistoryWriter, Tracker,
                                                setup_logging)
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


def _unported_options(config: dict):
    reasons = {
        "filip": "FILIP (ROADMAP Queue 1 item 7)",
        "resume_logdir": "resume_logdir (ROADMAP Queue 1 item 4)",
        "save_training_state": "save_training_state, which only resume "
                               "reads (ROADMAP Queue 1 item 4)",
        "native_decode": "native_decode (ROADMAP Queue 1 item 3)",
        "profile": "the profile key (StepProfiler, ROADMAP Queue 1 item 10)",
        "debug": "the debug key (ROADMAP Queue 1 item 10)",
    }
    for key, what in reasons.items():
        if (config.get("model", {}) if key == "filip" else config).get(key):
            raise NotImplementedError(f"{what} is not ported yet")
    chunk = config.get("train_chunk", "auto")
    if chunk not in ("auto", None) and int(chunk) > 1:
        raise NotImplementedError(
            f"train_chunk={chunk}: several steps per dispatch "
            "(make_multi_train_step) are not ported yet (ROADMAP Queue 1 "
            "item 6)")


class RetrievalExperiment:
    """Train + periodic retrieval eval, on ``device`` (CUDA unless the caller
    asks for another)."""

    eval_metric = "mAP"
    higher_is_better = True

    def __init__(self, config: dict, device=None):
        self.device = resolve_device(device)
        self.config = config
        _unported_options(config)
        self.method = get_method(config["model"]["name"])
        self.logdir = config["logdir"]
        os.makedirs(self.logdir, exist_ok=True)
        io.init_save_queue()
        setup_logging(os.path.join(self.logdir, "log.txt"))
        seeding(int(config.get("seed", 42)))
        print_stats(self.device)
        save_config(config, os.path.join(self.logdir, "config.yaml"))

        self._load_data()
        self._build_method()
        self.tracker = Tracker(config.get("wandb", False), self.logdir)
        self.train_history = HistoryWriter(self.logdir, "train",
                                           tracker=self.tracker)
        self.test_history = HistoryWriter(self.logdir, "test",
                                          tracker=self.tracker)
        self.best_metric = None
        self.start_epoch = 0
        if config.get("finetune_path"):
            self.finetune_init(config["finetune_path"])

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
        bs = int(cfg.get("batch_size", 64))
        resize = int(ds.get("resize", 256))
        cache = bool(cfg.get("cache_images",
                             len(self.datasets["train"]) < 20000))
        seed = int(cfg.get("seed", 42))
        self.loaders = {
            "train": Loader(self.datasets["train"], bs, resize=resize,
                            shuffle=True, drop_last=True, seed=seed,
                            cache=cache),
            "test": Loader(self.datasets["test"], bs, resize=resize,
                           cache=cache),
            "db": Loader(self.datasets["db"], bs, resize=resize, cache=cache),
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

    # ---------------------------------------------------------------- method
    def _build_method(self):
        cfg = self.config
        try:
            self.codebook = prepare_codebook(self.method, cfg, self.logdir)
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
        if (cfg.get("backbone", {}) or {}).get("pretrained", False):
            logging.warning("pretrained weights unavailable (the port loads "
                            "no pretrained weights, ROADMAP Queue 1 item 8); "
                            "using random init")

        self.epochs = int(cfg.get("epochs", 100))
        self.steps_per_epoch = max(len(self.loaders["train"]), 1)
        self.training = build_training(cfg, self.codebook,
                                       self.steps_per_epoch,
                                       device=self.device)
        self.model = self.training.model
        self.train_step = self.training.step
        self.eval_step = make_eval_step(self.model, self.training.loss_fn)
        seed = int(cfg.get("seed", 42))
        # augmentation draws: crops, flips and magnitudes on the device,
        # TrivialAugment's op indices on the host
        self.aug_generator = torch.Generator(device=self.device).manual_seed(
            seed + 2)
        self.op_generator = torch.Generator().manual_seed(seed + 3)

    # ------------------------------------------------------------------ train
    def train_one_epoch(self, ep: int) -> dict:
        meters = MeterBank()
        t0 = time.time()
        for batch in self.loaders["train"]:
            n = batch.pop("n_valid")
            images = preprocess_batch(
                self._on_device(batch["image"]), self.aug_generator,
                crop=self.crop, norm=self.norm, train=True,
                augment=self.augment, op_generator=self.op_generator)
            metrics = self.train_step(
                {"image": images, "label": self._on_device(batch["label"])})
            meters.update_device(metrics, n)
        res = meters.materialize()      # the epoch's one wait on the device
        res["time"] = time.time() - t0
        res["lr"] = current_lr(self.config.get("optim", {}) or {},
                               self.config.get("scheduler", {}) or {},
                               self.epochs, self.steps_per_epoch,
                               self.training.scheduler.last_epoch)
        return res

    # ------------------------------------------------------------------- eval
    def encode_split(self, split: str):
        """Encode a split: ({codes_key: (N, nbit) device tensor}, labels
        (N, C) numpy, {metric: mean}). The padded tail batch runs at its
        valid rows only, so padding never enters the codes or the
        meters."""
        all_codes: dict[str, list] = {}
        labels = []
        meters = MeterBank()
        for batch in self.loaders[split]:
            n = batch.pop("n_valid")
            images = preprocess_batch(self._on_device(batch["image"][:n]),
                                      crop=self.crop, norm=self.norm,
                                      train=False)
            codes, metrics = self.eval_step(
                {"image": images,
                 "label": self._on_device(batch["label"][:n])})
            if metrics:
                meters.update_device(metrics, n)
            for k, v in codes.items():
                all_codes.setdefault(k, []).append(v)
            labels.append(batch["label"][:n])
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
        logging.info("ep %d eval: mAP=%s", ep, res.get("mAP"))
        return res, (test_codes, test_labels, db_codes, db_labels)

    # ------------------------------------------------------------- checkpoint
    def model_state_blob(self, ep: int) -> dict:
        return {"model": self.model.state_dict(), "epoch": ep}

    def save_model(self, name: str, ep: int):
        io.fast_save(self.model_state_blob(ep),
                     os.path.join(self.logdir, "models", f"{name}.pt"))

    def _state_dict_from(self, path: str) -> tuple[dict, int]:
        """(state dict, epoch) of a port checkpoint (.pt) or a JAX package
        checkpoint (.msgpack)."""
        if path.endswith(".msgpack"):
            from concepthash_tpu_torch.weights import from_flax

            blob = io.load_jax_checkpoint(path)
            if "params" not in blob:
                raise ValueError(f"{path} is not a network checkpoint (keys: "
                                 f"{sorted(blob)})")
            return from_flax(blob), int(blob.get("epoch", 0))
        blob = io.load_checkpoint(path)
        return blob["model"], int(blob.get("epoch", 0))

    def load_model_state(self, path: str) -> int:
        """Load a checkpoint strictly (every tensor, every shape); returns
        its epoch."""
        sd, ep = self._state_dict_from(path)
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

    # ------------------------------------------------------------------- main
    def main(self):
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
                    logging.warning("stopping at epoch %d (preemption)", ep)
                    break
        io.join_save_queue()
        for loader in self.loaders.values():
            loader.close()
        logging.info("done: best %s = %s", self.eval_metric, self.best_metric)
        return self.best_metric

    def _dump_codes(self, dumps):
        test_codes, test_labels, db_codes, db_labels = dumps
        io.fast_save({"codes": test_codes["codes"], "labels": test_labels},
                     os.path.join(self.logdir, "outputs", "test_best.pt"))
        io.fast_save({"codes": db_codes["codes"], "labels": db_labels},
                     os.path.join(self.logdir, "outputs", "db_best.pt"))
