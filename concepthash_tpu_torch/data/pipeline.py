"""Host input pipeline: decode workers + prefetch, static-shape batches (the
port's own copy of concepthash_tpu/data/pipeline.py).

A thread pool decodes (decode releases the GIL in PIL) and a bounded prefetch
queue feeds uint8 numpy batches, which the experiment copies to the card and
preprocesses there (``data/preprocess.py``). The batch order, the padded
tail, the one-hots and indices and the ``cache`` rule are the reference's.

One deliberate difference: the decode pool is the ``ImageSource``'s, and
``Loader.close()`` or abandoning an epoch mid-way shuts it down (the
reference leaves its threads running). ``native_decode`` decodes with the
C++ library (``native``), falling back to PIL per image as the reference
does. ``ArrayDataset`` and ``array_loader`` batch in-memory feature rows
(the ``identity`` backbone's input) under the same batch contract. Not
ported: the per-process shards of a multi-host run, the ``dataloader``
alias (callers build a ``Loader``) and the ``workers`` and ``prefetch``
knobs (the pool's width follows the cores; the prefetch depth is
``PREFETCH``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from concepthash_tpu_torch.data.manifest import HashingDataset
from concepthash_tpu_torch.data.preprocess import load_image_host

default_workers = 8
PREFETCH = 2        # batches the prefetch thread may hold ready


def _finish_batch(arr, labels, sel, batch_size: int) -> dict:
    """Shared batch-dict contract: zero-pad to the static batch size, pad
    rows carry index -1 and are excluded from n_valid."""
    n_valid = len(sel)
    if n_valid < batch_size:
        pad = batch_size - n_valid
        arr = np.concatenate(
            [arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])
        labels = np.concatenate(
            [labels, np.zeros((pad, labels.shape[1]), labels.dtype)])
        sel = np.concatenate([sel, np.full(pad, -1)])
    return {"image": arr, "label": labels, "index": sel.astype(np.int32),
            "n_valid": n_valid}


def _ncpu() -> int:
    """Cores THIS PROCESS may run on — cpuset/affinity aware. os.cpu_count()
    reports the machine's cores, so a container pinned to 1 core on a
    64-core host would re-enable exactly the few-core pathologies the
    width/prefetch heuristics exist to avoid."""
    import os

    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # pragma: no cover - non-Linux
        return os.cpu_count() or 1


def _resolve_workers() -> int:
    """CPU-aware decode-pool width. On a host with few cores, a wide thread
    pool actively HURTS: decode threads release the GIL and starve the main
    thread's stack/H2D/dispatch work via context-switch thrash (measured on
    a 1-core relay host: np.stack of a 195MB chunk took 22s next to 8 decode
    threads vs <1s with 1). Cap at the core count, leaving headroom at >=4
    cores for the main thread."""
    ncpu = _ncpu()
    if ncpu >= 4:
        return min(default_workers, ncpu - 1)
    return 1


class ImageSource:
    """Decoded-image access with an optional whole-dataset RAM cache
    (fine-grained galleries are small: CUB 5,994 images ~1.2 GB at 256²)."""

    def __init__(self, dataset: HashingDataset, resize: int = 256,
                 cache: bool = False, native_decode: bool = False):
        self.dataset = dataset
        self.resize = resize
        self.native_decode = native_decode
        self.workers = _resolve_workers()
        self._cache = None
        self._pool = None  # persistent decode pool, created on first use
        if cache:
            self._cache = [None] * len(dataset)

    def get(self, i: int) -> np.ndarray:
        if self._cache is not None and self._cache[i] is not None:
            return self._cache[i]
        img = load_image_host(self.dataset.image_path(i), self.resize,
                              use_native=self.native_decode)
        if self._cache is not None:
            self._cache[i] = img
        return img

    def get_many(self, idxs) -> np.ndarray:
        if self.workers > 1 and len(idxs) > 1:
            if self._pool is None:
                # one pool for the source's lifetime — per-batch pool
                # construction churns threads on large uncached datasets
                self._pool = ThreadPoolExecutor(self.workers)
            imgs = list(self._pool.map(self.get, idxs))
        else:
            imgs = [self.get(i) for i in idxs]
        return np.stack(imgs)

    def close(self):
        """Shut down the decode pool, waiting for its threads; the next
        ``get_many`` starts a new one."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class Loader:
    """Batched iterator with background prefetch.

    Yields dicts {image: uint8 (B,S,S,3), label: f32 onehot (B,C),
    index: int32 (B,), n_valid: int} — fixed B (last batch padded; ``n_valid``
    marks real rows, SURVEY.md §7 hard-part 6). drop_last mirrors the
    reference train loader (trainers/coop.py:39)."""

    def __init__(self, dataset: HashingDataset, batch_size: int,
                 resize: int = 256, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, cache: bool = False,
                 native_decode: bool = False):
        self.dataset = dataset
        self.source = ImageSource(dataset, resize, cache=cache,
                                  native_decode=native_decode)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.onehot = dataset.onehot_labels()

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idxs)
        return idxs

    def _make_batch(self, idxs, b: int) -> dict:
        sel = idxs[b * self.batch_size:(b + 1) * self.batch_size]
        return _finish_batch(self.source.get_many(sel), self.onehot[sel],
                             sel, self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        idxs = self._epoch_indices()
        self.epoch += 1
        nb = len(self)

        # On a 1-core host background prefetch is pure loss: the producer's
        # GIL-held numpy work (cache hits, batch stacking) starves the
        # consumer's H2D/dispatch path via timeslice round-robin — measured
        # 2-4x WORSE than synchronous production. Overlap only pays when
        # there is a core to overlap onto. (One core also means one decoder:
        # no pool to reap.)
        if _ncpu() < 2:
            for b in range(nb):
                yield self._make_batch(idxs, b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that re-checks stop: a plain q.put() parks the
            # producer FOREVER when the consumer abandons iteration with a
            # full queue (break / train-step exception) — the finally's
            # stop.set() can't wake it, leaking the thread + ~prefetch
            # decoded batches per abandoned epoch
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    if not _put(self._make_batch(idxs, b)):
                        return
                _put(None)
            except BaseException as e:  # surface worker errors to the consumer
                _put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        done = False
        try:
            while True:
                item = q.get()
                if item is None:
                    done = True
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            try:  # unblock a producer mid-put, then reap it
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            # no timeout: a producer still decoding a batch stops at its next
            # _put, and must be gone before the pool it decodes with closes
            t.join()
            if not done:            # abandoned mid-epoch: reap the decode pool
                self.source.close()

    def close(self):
        """Release the decode pool (the loader stays usable)."""
        self.source.close()


def seeding(seed: int):
    """engine.seeding parity (reference engine.py:57-61): seeds numpy/python;
    JAX randomness is explicit PRNG keys derived from config.seed."""
    import random

    np.random.seed(seed)
    random.seed(seed)


class ArrayDataset:
    """In-memory (features, labels) dataset (the reference's
    ``engine.tensor_to_dataset(s)``), for precomputed features and the
    identity backbone. ``labels``: class indices or (N, C) multi-hot."""

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 num_classes: int = 0):
        if len(features) != len(labels):
            raise ValueError(f"{len(features)} feature rows but "
                             f"{len(labels)} labels")
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.num_classes = num_classes or (
            self.labels.shape[1] if self.labels.ndim == 2
            else int(self.labels.max()) + 1)

    def __len__(self):
        return len(self.features)

    def onehot_labels(self) -> np.ndarray:
        if self.labels.ndim == 2:
            return self.labels.astype(np.float32)
        return np.eye(self.num_classes, dtype=np.float32)[self.labels]


def array_loader(dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0) -> Iterator[dict]:
    """Batches of an ArrayDataset under the ``Loader`` contract (``image``
    carries the feature rows; the tail zero-padded, its rows at index -1);
    ``shuffle`` permutes with ``np.random.default_rng(seed)``."""
    n = len(dataset)
    idxs = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idxs)
    onehot = dataset.onehot_labels()
    nb = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(nb):
        sel = idxs[b * batch_size:(b + 1) * batch_size]
        yield _finish_batch(dataset.features[sel], onehot[sel], sel,
                            batch_size)
