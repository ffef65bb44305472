"""Manifest datasets: the reference's on-disk format, unchanged (the port's
own copy of concepthash_tpu/data/manifest.py).

``data/<ds>/{train,test,database}.txt`` hold ``<image-path> <int-label>``
lines; ``class_names.txt`` one name per line (reference
data/cub200_2011/train.txt, SURVEY.md §2.8). This module reconstructs the
missing ``utils.datasets.HashingDataset`` API (root, filename, num_classes,
num_shots; items are (image, onehot, index) — SURVEY.md §2.9).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Manifest:
    root: str
    filename: str
    paths: list = field(default_factory=list)
    labels: np.ndarray = None  # (N,) int64 or (N, C) for multilabel

    def __len__(self):
        return len(self.paths)


def read_manifest(root: str, filename: str) -> Manifest:
    path = os.path.join(root, filename)
    paths, labels = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            # multi-label manifests store comma/space separated ints after path
            img = parts[0]
            lab = [int(x) for tok in parts[1:] for x in tok.split(",") if x]
            paths.append(img)
            labels.append(lab[0] if len(lab) == 1 else lab)
    widths = {len(l) if isinstance(l, list) else 0 for l in labels}
    if len(widths) > 1:
        raise ValueError(
            f"{path}: inconsistent label counts per row ({sorted(widths)}) — "
            f"multi-label manifests need the same number of labels on every "
            f"line")
    labels = np.asarray(labels, np.int64)
    return Manifest(root=root, filename=filename, paths=paths, labels=labels)


def read_class_names(root: str, filename: str = "class_names.txt") -> list:
    with open(os.path.join(root, filename)) as f:
        return [line.replace("_", " ").strip() for line in f if line.strip()]


class HashingDataset:
    """Path+label dataset with optional few-shot subsetting.

    ``num_shots > 0`` keeps only the first ``num_shots`` items per class
    (reference call signature, SURVEY.md §2.9). Image loading is delegated to
    the pipeline; this object is just the index.
    """

    def __init__(self, root: str, filename: str, num_classes: int = 0,
                 num_shots: int = 0):
        m = read_manifest(root, filename)
        self.root = root
        self.filename = filename
        # multi-hot rows: the class count is the row WIDTH (max()+1 would
        # say 2 for any 0/1 matrix)
        inferred = (m.labels.shape[1] if m.labels.ndim == 2
                    else int(m.labels.max()) + 1)
        self.num_classes = num_classes or inferred
        if num_shots and m.labels.ndim == 2:
            import logging

            logging.warning(
                "num_shots=%d ignored: few-shot subsetting is only defined "
                "for single-label manifests (%s is multi-hot)", num_shots,
                filename)
        if num_shots and m.labels.ndim == 1:
            keep = []
            counts = {}
            for i, y in enumerate(m.labels):
                y = int(y)
                if counts.get(y, 0) < num_shots:
                    counts[y] = counts.get(y, 0) + 1
                    keep.append(i)
            m.paths = [m.paths[i] for i in keep]
            m.labels = m.labels[keep]
        self.paths = m.paths
        self.labels = m.labels

    def __len__(self):
        return len(self.paths)

    def onehot_labels(self) -> np.ndarray:
        if self.labels.ndim == 2:
            return self.labels.astype(np.float32)
        return np.eye(self.num_classes, dtype=np.float32)[self.labels]

    def image_path(self, i: int) -> str:
        p = self.paths[i]
        return p if os.path.isabs(p) else os.path.join(self.root, p)

    def subset(self, indices) -> "HashingDataset":
        """reference utils.datasets.subset_dataset (trainers/adsh.py:131)."""
        out = object.__new__(HashingDataset)
        out.root, out.filename = self.root, self.filename
        out.num_classes = self.num_classes
        out.paths = [self.paths[i] for i in indices]
        out.labels = self.labels[np.asarray(indices)]
        return out


def subset_dataset(dataset: HashingDataset, indices) -> HashingDataset:
    return dataset.subset(indices)


class OneHot:
    """Target transform parity (reference configs/dataset/cub200.yaml:26)."""

    def __init__(self, nclass: int):
        self.nclass = nclass

    def __call__(self, y: int) -> np.ndarray:
        out = np.zeros(self.nclass, np.float32)
        out[y] = 1.0
        return out
