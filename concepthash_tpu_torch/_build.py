"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so``, where the hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
is rebuilt and an unchanged one is reused. The
build happens at first use, never at import. ``build()`` starts one nvcc per
source, all at once, and waits for them together.

Pointers and the stream cross into C as ``ctypes.c_void_p``; every C entry
returns a ``cudaError_t`` that the caller turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
SOURCES = ("fused_layer", "topk_select", "fused_ln", "attention", "bitplane_mins")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the "
            "port's CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a digest of the
    source, of every shared header ``csrc/*.cuh`` and of the flags, so an
    edit to any of them selects a new library."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, one nvcc each,
    all started together. Returns the wall seconds of each build (0.0 for a
    library that was already there). Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(code: int, error_string, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        raise RuntimeError(
            f"{what} failed: CUDA error {code} "
            f"({error_string(code).decode(errors='replace')})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
