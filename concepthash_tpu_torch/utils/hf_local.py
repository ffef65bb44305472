"""Hugging Face checkpoints from the local disk, never the network (the
port's counterpart of concepthash_tpu/utils/hf_offline.py, which guards
``transformers.from_pretrained``; the port reads the files itself).

``resolve_local(model_id)`` is a directory: ``model_id`` itself when it is
one, else the hub cache's snapshot of it,
``$HF_HOME/hub/models--<org>--<name>/snapshots/<rev>/`` (``$HF_HOME``
defaults to ``~/.cache/huggingface``), the revision ``refs/main`` names, or
the only snapshot there is. It raises ``OSError`` when there is
none. ``load_state_dict`` reads ``model.safetensors`` with a reader of its
own (an 8-byte little-endian header length, a JSON header, then the raw
tensor bytes), else ``pytorch_model.bin`` with
``torch.load(weights_only=True)``; ``load_config`` reads ``config.json``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def hub_cache() -> str:
    home = os.environ.get("HF_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface")
    return os.path.join(home, "hub")


def resolve_local(model_id: str) -> str:
    """The local directory of ``model_id`` (a path, or a hub id in the
    cache). Raises ``OSError`` if it is not on this disk."""
    if os.path.isdir(model_id):
        return model_id
    repo = os.path.join(hub_cache(),
                        "models--" + model_id.replace("/", "--"))
    snaps = os.path.join(repo, "snapshots")
    ref = os.path.join(repo, "refs", "main")
    if os.path.exists(ref):
        with open(ref) as f:
            cand = os.path.join(snaps, f.read().strip())
        if os.path.isdir(cand):
            return cand
    if os.path.isdir(snaps):
        revs = sorted(os.listdir(snaps))
        if len(revs) == 1:
            return os.path.join(snaps, revs[0])
    raise OSError(f"{model_id!r} is neither a directory nor in the local "
                  f"Hugging Face cache ({repo}); nothing is downloaded")


def load_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def read_safetensors(path: str) -> dict:
    """{name: CPU tensor} of a ``.safetensors`` file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             "which this reader does not take")
        start, end = info["data_offsets"]
        buf = np.frombuffer(data, dtype=np.uint8, count=end - start,
                            offset=start).copy()
        t = torch.from_numpy(buf).view(dtype) if end > start else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def load_state_dict(path: str) -> dict:
    """The checkpoint's tensors, from ``model.safetensors`` or else
    ``pytorch_model.bin``."""
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise OSError(f"{path} holds neither model.safetensors nor "
                  "pytorch_model.bin")
