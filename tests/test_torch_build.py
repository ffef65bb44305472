"""The build cache of the port's CUDA sources (``concepthash_tpu_torch._build``)
selects a new library when a source, a shared header or the flags change.
CPU only: nothing is compiled."""

import shutil

import pytest

from concepthash_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private copy of csrc/ that ``_build`` reads instead of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_every_source_and_header_is_there():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert (_build.CSRC / "gemm_sm90.cuh").is_file()


@pytest.mark.parametrize("name", ["fused_layer", "fused_ln", "attention"])
def test_library_path_follows_the_shared_header(csrc, name):
    before = _build.library_path(name)
    assert before == _build.library_path(name)          # stable
    header = csrc / "gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(name)
    assert after != before
    assert after.parent == _build.BUILD_DIR
    assert after.name.startswith(f"lib{name}-") and after.suffix == ".so"


def test_library_path_follows_source_flags_and_new_headers(csrc, monkeypatch):
    base = _build.library_path("fused_ln")
    src = csrc / "fused_ln.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = _build.library_path("fused_ln")
    assert edited != base
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_header = _build.library_path("fused_ln")
    assert with_header != edited
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("fused_ln") != with_header
