"""Checkpoint IO in the port's own format, with a background save queue
(counterpart of concepthash_tpu/utils/io.py).

A checkpoint is one ``torch.save`` file of a dict of CPU tensors and plain
values (a model's state dict plus the epoch, codes and labels). ``fast_save``
copies the tensors to the host in the caller's thread, so the snapshot is
consistent, and leaves the write to a background thread.

``load_jax_checkpoint`` reads the JAX package's msgpack checkpoints (flax's
encoding: ext type 1 an ndarray packed as (shape, dtype name, bytes), ext
type 3 a numpy scalar) into nested dicts of numpy arrays, which
``weights.from_flax`` carries into the port.
"""

from __future__ import annotations

import logging
import os
import queue
import threading

import numpy as np
import torch

_save_queue: "queue.Queue | None" = None
_save_thread: "threading.Thread | None" = None


def _worker():
    while True:
        item = _save_queue.get()
        if item is None:
            _save_queue.task_done()
            break
        obj, path = item
        try:
            _write(obj, path)
        except Exception:
            logging.exception("async save of %s failed", path)
        finally:
            _save_queue.task_done()


def init_save_queue():
    """Start the background checkpoint-writer thread (idempotent)."""
    global _save_queue, _save_thread
    if _save_thread is not None and _save_thread.is_alive():
        return
    _save_queue = queue.Queue()
    _save_thread = threading.Thread(target=_worker, daemon=True,
                                    name="ckpt-writer")
    _save_thread.start()


def fast_save(obj, path: str):
    """Write ``obj`` to ``path`` in the background (synchronously if the
    queue was never started); its tensors are copied to the host first."""
    host = _to_host(obj)
    if _save_queue is None:
        _write(host, path)
    else:
        _save_queue.put((host, path))


def join_save_queue():
    """Block until all pending saves have been written."""
    if _save_queue is not None:
        _save_queue.join()


def _to_host(obj):
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # atomic publish


def load_checkpoint(path: str):
    """A port checkpoint back as written (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# the JAX package's msgpack checkpoints
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3     # flax's msgpack extension types


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _ext_hook(code, data):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def load_jax_checkpoint(path: str) -> dict:
    """A JAX package checkpoint (``.msgpack``) as nested dicts of numpy
    arrays and scalars."""
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
