"""The port's data modules against the JAX package's on the CPU: the
synthetic set (images and list files), the manifests and ``HashingDataset``
(``num_shots`` included), the host decode on non-square images, and the
``Loader``'s batches over two epochs (shuffled ``drop_last`` train, padded
eval), all exactly equal; and the port's loader reaping its threads when an
epoch is abandoned."""

import os
import threading

import numpy as np
import pytest
from PIL import Image

from concepthash_tpu.data import manifest as jman
from concepthash_tpu.data import pipeline as jpipe
from concepthash_tpu.data.preprocess import load_image_host as jload
from concepthash_tpu.data.synthetic import make_synthetic_dataset as jmake
from concepthash_tpu_torch.data import manifest as tman
from concepthash_tpu_torch.data import pipeline as tpipe
from concepthash_tpu_torch.data.preprocess import load_image_host as tload
from concepthash_tpu_torch.data.synthetic import (make_synthetic_dataset as
                                                  tmake)

SET = dict(nclass=3, per_class_train=5, per_class_test=2, image_size=20,
           seed=11)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("sets")
    return (jmake(str(base / "ref"), **SET), tmake(str(base / "port"), **SET))


def test_synthetic_set_equals_reference(roots):
    ref, port = roots
    for name in ("train.txt", "test.txt", "database.txt", "class_names.txt"):
        with open(os.path.join(ref, name)) as a, \
                open(os.path.join(port, name)) as b:
            assert a.read() == b.read(), name
    files = sorted(os.listdir(os.path.join(ref, "images")))
    assert files == sorted(os.listdir(os.path.join(port, "images")))
    assert len(files) == 3 * (5 + 2)
    for f in files:
        a = np.asarray(Image.open(os.path.join(ref, "images", f)))
        b = np.asarray(Image.open(os.path.join(port, "images", f)))
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), f


def test_synthetic_set_with_its_own_database(tmp_path):
    kw = dict(SET, db_equals_train=False)
    ref, port = jmake(str(tmp_path / "r"), **kw), tmake(str(tmp_path / "p"),
                                                        **kw)
    with open(os.path.join(ref, "database.txt")) as a, \
            open(os.path.join(port, "database.txt")) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("shots", [0, 2])
def test_hashing_dataset_equals_reference(roots, shots):
    ref, port = roots
    for fn in ("train.txt", "test.txt", "database.txt"):
        a = jman.HashingDataset(ref, fn, 3, num_shots=shots)
        b = tman.HashingDataset(port, fn, 3, num_shots=shots)
        assert a.paths == b.paths and a.num_classes == b.num_classes
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.onehot_labels(), b.onehot_labels())
        assert os.path.relpath(a.image_path(1), ref) == os.path.relpath(
            b.image_path(1), port)
    assert len(tman.HashingDataset(port, "train.txt", 3, num_shots=shots)) \
        == 3 * (shots or 5)
    sub = tman.subset_dataset(b, [2, 0])
    assert sub.paths == [b.paths[2], b.paths[0]]
    assert tman.read_class_names(port) == jman.read_class_names(ref)
    np.testing.assert_array_equal(tman.OneHot(4)(2), jman.OneHot(4)(2))


@pytest.mark.parametrize("size,fmt", [((37, 23), "PNG"), ((23, 41), "PNG"),
                                      ((50, 31), "JPEG")])
def test_load_image_host_equals_reference(tmp_path, size, fmt):
    rng = np.random.default_rng(size[0])
    arr = rng.integers(0, 256, (size[1], size[0], 3)).astype(np.uint8)
    path = str(tmp_path / f"im.{fmt.lower()}")
    Image.fromarray(arr).save(path, format=fmt)
    for resize in (16, 29):
        a, b = jload(path, resize), tload(path, resize)
        assert b.shape == (resize, resize, 3) and b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    # the C++ route: the reference's bytes (PIL's where it cannot build)
    for resize in (16, 29):
        np.testing.assert_array_equal(tload(path, resize, use_native=True),
                                      jload(path, resize, use_native=True))


def _batches(loader, epochs):
    return [[dict(b) for b in loader] for _ in range(epochs)]


@pytest.mark.parametrize("train", [True, False])
def test_loader_yields_reference_batches(roots, monkeypatch, train):
    monkeypatch.setattr(tpipe, "_ncpu", lambda: 4)   # a decode pool
    ref, port = roots
    fn, bs = ("train.txt", 4) if train else ("database.txt", 4)
    kw = dict(resize=16, shuffle=train, drop_last=train, seed=3,
              cache=train)
    a = _batches(jpipe.dataloader(jman.HashingDataset(ref, fn, 3), bs,
                                  workers=2, **kw), 2)
    loader = tpipe.Loader(tman.HashingDataset(port, fn, 3), bs, **kw)
    assert loader.source.workers > 1        # the decode pool decodes
    b = _batches(loader, 2)
    loader.close()
    assert len(a) == len(b) == 2
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb) == (3 if train else 4)
        for x, y in zip(ea, eb):
            assert set(x) == set(y) == {"image", "label", "index", "n_valid"}
            assert x["n_valid"] == y["n_valid"]
            for k in ("image", "label", "index"):
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                np.testing.assert_array_equal(x[k], y[k])
    if train:    # a new order each epoch
        assert not np.array_equal(b[0][0]["index"], b[1][0]["index"])
    else:        # the padded tail
        assert b[0][-1]["n_valid"] == 15 - 12
        assert (b[0][-1]["index"][3:] == -1).all()


@pytest.mark.parametrize("ncpu", [1, 4])
def test_abandoned_loader_leaves_no_thread(roots, monkeypatch, ncpu):
    """The port's counterpart of the reference's
    test_loader_early_break_reaps_producer: after abandoned epochs, neither
    the prefetch thread (with cores to overlap onto) nor the decode pool is
    alive. One core: synchronous, one decoder, no pool; four: a prefetch
    thread and a pool of three decoders."""
    monkeypatch.setattr(tpipe, "_ncpu", lambda: ncpu)
    pooled = ncpu >= 4
    ds = tman.HashingDataset(roots[1], "train.txt", 3)
    before = set(threading.enumerate())
    for _ in range(5):
        loader = tpipe.Loader(ds, 2, resize=16)
        assert loader.source.workers == (3 if pooled else 1)
        it = iter(loader)
        next(it)
        assert (loader.source._pool is not None) == pooled
        it.close()
        assert loader.source._pool is None
    for _ in range(2):                      # a loop left with break
        for _ in tpipe.Loader(ds, 2, resize=16):
            break
    assert set(threading.enumerate()) - before == set()
    loader = tpipe.Loader(ds, 2, resize=16)
    assert len(list(loader)) == len(loader)   # a whole epoch keeps the pool
    assert (loader.source._pool is not None) == pooled
    loader.close()
    assert set(threading.enumerate()) - before == set()
