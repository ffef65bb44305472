"""The C++ host decode of the loader (the port's own copy of
concepthash_tpu/native): libjpeg/libpng decode, bilinear short-side resize
and center crop (``decode.cc``), compiled with g++ at first use into
``concepthash_tpu_torch/_build/`` and called through ctypes, which releases
the GIL for the call.

Where the library cannot be built or loaded (no g++, or no libjpeg/libpng
headers on the machine), and for a file it cannot decode,
``decode_resize_crop`` returns None and the caller decodes with PIL, as the
reference does; the first of each is logged at WARNING, and ``counts``
tallies the images each route took.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from concepthash_tpu_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "decode.cc"
FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng")

_lock = threading.Lock()
_lib = None
_tried = False
_warned_file = False
# images decoded by the library, and images sent to PIL under use_native
counts = {"native": 0, "fallback": 0}


def library_path() -> Path:
    """Where ``decode.cc`` builds to: the name carries a digest of the
    source and the flags, so an edited source selects a new library."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"libdecode-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str | None:
    """Compile the library to ``out``; the error text on failure."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return str(e)
    if proc.returncode != 0:
        return (proc.stderr or proc.stdout).strip().splitlines()[0]
    os.replace(tmp, out)
    return None


def get_lib():
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (logged once at WARNING)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        error = None if out.exists() else _build(out)
        if error is None:
            try:
                lib = ctypes.CDLL(str(out))
                lib.decode_resize_crop.restype = ctypes.c_int
                lib.decode_resize_crop.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8)]
                _lib = lib
            except OSError as e:
                error = str(e)
        if error is not None:
            logging.warning("native_decode: the C++ decoder is unavailable "
                            "(%s); every image is decoded with PIL", error)
        return _lib


def available() -> bool:
    return get_lib() is not None


def _count(route: str) -> None:
    with _lock:
        counts[route] += 1


def decode_resize_crop(data: bytes, resize: int) -> np.ndarray | None:
    """bytes -> (resize, resize, 3) uint8, or None when the library is not
    there or cannot decode ``data`` (the caller decodes with PIL)."""
    global _warned_file
    lib = get_lib()
    if lib is None:
        _count("fallback")
        return None
    out = np.empty((resize, resize, 3), np.uint8)
    rc = lib.decode_resize_crop(
        data, len(data), resize,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc == 0:
        _count("native")
        return out
    _count("fallback")
    if not _warned_file:
        _warned_file = True
        logging.warning("native_decode: the C++ decoder cannot decode a file "
                        "(%d bytes); decoding it with PIL", len(data))
    return None


def reset_counts() -> None:
    with _lock:
        counts.update(native=0, fallback=0)
