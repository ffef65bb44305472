"""The port's C++ host decode (``concepthash_tpu_torch.native``) against the
reference's (``concepthash_tpu.native``) on the CPU: the same bytes for PNG
and JPEG at two sizes, garbage sent to PIL, a machine without the
toolchain sent to PIL with one WARNING, and a ``Loader(native_decode=True)``
epoch equal to the reference loader's pixels."""

import logging

import numpy as np
import pytest

from concepthash_tpu import native as jnative
from concepthash_tpu.data import pipeline as jpipe
from concepthash_tpu.data.manifest import HashingDataset as JDataset
from concepthash_tpu.data.preprocess import load_image_host as jload
from concepthash_tpu_torch import native as tnative
from concepthash_tpu_torch.data import pipeline as tpipe
from concepthash_tpu_torch.data.manifest import HashingDataset as TDataset
from concepthash_tpu_torch.data.preprocess import load_image_host as tload

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the reference's native decoder "
                                       "cannot be built here")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A smooth and a noisy image, each as PNG and as JPEG, landscape and
    portrait."""
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, 300), np.linspace(0, 1, 400),
                         indexing="ij")
    smooth = np.stack([127 + 120 * np.sin(3 * xx + c) * np.cos(2 * yy + c)
                       for c in range(3)], -1).astype(np.uint8)
    noisy = rng.integers(0, 256, (410, 290, 3)).astype(np.uint8)
    paths = []
    for name, arr in (("smooth", smooth), ("noisy", noisy)):
        for fmt, ext in (("PNG", "png"), ("JPEG", "jpg")):
            p = str(d / f"{name}.{ext}")
            Image.fromarray(arr).save(p, format=fmt)
            paths.append(p)
    return paths


@pytest.mark.parametrize("resize", [64, 224])
def test_native_decode_equals_reference_bytes(images, resize):
    """Byte for byte: the port's library is the reference's code, built
    apart."""
    assert tnative.available()
    for path in images:
        with open(path, "rb") as f:
            data = f.read()
        want = jnative.decode_resize_crop(data, resize)
        got = tnative.decode_resize_crop(data, resize)
        assert got.shape == (resize, resize, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=path)
        np.testing.assert_array_equal(tload(path, resize, use_native=True),
                                      jload(path, resize, use_native=True))
    assert str(tnative.library_path()).startswith(str(tnative.BUILD_DIR))


def test_garbage_falls_back_to_pil(tmp_path):
    p = str(tmp_path / "garbage.png")
    with open(p, "wb") as f:
        f.write(b"not an image at all")
    before = dict(tnative.counts)
    assert tnative.decode_resize_crop(b"not an image at all", 64) is None
    with pytest.raises(Exception):
        tload(p, resize=64, use_native=True)    # PIL fails on it too
    assert tnative.counts["fallback"] == before["fallback"] + 2


def test_no_toolchain_decodes_with_pil_and_warns_once(images, monkeypatch,
                                                      caplog, tmp_path):
    """Where the library cannot be built, every image goes to PIL (the
    reference's fallback) and one WARNING says so."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING):
        for path in images:
            np.testing.assert_array_equal(tload(path, 64, use_native=True),
                                          jload(path, 64))
    warnings = [r for r in caplog.records if "native_decode" in r.message]
    assert len(warnings) == 1 and "g++" in warnings[0].message
    assert not tnative.available()


def test_native_loader_epoch_equals_reference(images, tmp_path, monkeypatch):
    """A shuffled ``Loader(native_decode=True)`` epoch over a manifest of
    the images, with a decode pool: the reference loader's batches, pixel
    for pixel."""
    root = tmp_path / "set"
    root.mkdir()
    with open(root / "train.txt", "w") as f:
        for i, path in enumerate(images * 2):
            f.write(f"{path} {i % 3}\n")
    monkeypatch.setattr(tpipe, "_ncpu", lambda: 4)
    t = tpipe.Loader(TDataset(str(root), "train.txt", 3), 3, resize=96,
                     shuffle=True, seed=5, native_decode=True)
    j = jpipe.Loader(JDataset(str(root), "train.txt", 3), 3, resize=96,
                     shuffle=True, seed=5, native_decode=True)
    before = tnative.counts["native"]
    got, want = list(t), list(j)
    t.close()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for k in ("image", "label", "index", "n_valid"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tnative.counts["native"] == before + 8
