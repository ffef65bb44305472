"""The process group of a data-parallel run (counterpart of
concepthash_tpu/parallel/mesh.py).

The reference places one global batch on a 1-D 'data' mesh of devices and
lets GSPMD shard it; here each rank is one process with one device, and the
mesh is an explicit ``torch.distributed`` group:

- ``init_distributed`` joins the group a launcher describes in the
  environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``): NCCL on the card (device
  ``cuda:LOCAL_RANK``), gloo on the CPU. Without that environment it does
  nothing and the run is the one-process run, bit for bit. A rank that
  cannot reach its group raises; nothing falls back to one process.
- ``make_mesh(n)`` is the group of the first ``n`` ranks (a ``Mesh``: the
  group, this process's rank in it, its size and device); a rank past
  ``n`` holds a mesh it is not a member of (``rank`` -1).
- ``shard_batch`` / ``shard_batch_chunk`` take the rank's contiguous block
  of the batch axis, rows ``[r B / W, (r + 1) B / W)``: what ``P('data')``
  places on device r.
- ``replicate`` broadcasts rank 0's parameters, buffers, optimizer state,
  generators and a method's train-state extras to every rank.
- ``pad_to_multiple`` pads a host batch to a multiple of the rank count.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from concepthash_tpu_torch import resolve_device

# seconds a rank waits for the others at the group's start
INIT_TIMEOUT_S = 300
_initialized_here = False


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a data-parallel run splits its batch over: the process
    group, this process's rank in it (-1 outside it), its size and the
    device this process computes on."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank >= 0

    @property
    def backend(self) -> str:
        """The default group's backend (a rank outside the mesh cannot ask
        the mesh's group)."""
        return dist.get_backend()

    def rows(self, n_local: int) -> slice:
        """This rank's block of a global axis of ``n_local * size``
        entries."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


def init_distributed(device=None) -> bool:
    """Join the process group of the launcher's environment, once per
    process: NCCL with this process's card ``cuda:LOCAL_RANK`` when
    ``device`` is CUDA (the default), gloo otherwise. Returns whether a
    group exists; with no launcher's environment it does nothing."""
    global _initialized_here
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False        # RANK missing beside it raises below
    dev = resolve_device(device)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        backend = "nccl"
        # the communicator is created now, before any graph captures a
        # collective
        kw["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
                            **kw)
    _initialized_here = True
    logging.info("torch.distributed: rank %d of %d (%s)", rank, world,
                 backend)
    return True


def shutdown() -> None:
    """Leave the group ``init_distributed`` joined (a group made by the
    caller stays)."""
    global _initialized_here
    if _initialized_here and dist.is_initialized():
        dist.destroy_process_group()
    _initialized_here = False


def group_device() -> torch.device:
    """The device this process's collectives run on: its card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the first ``n_devices`` ranks of the group (all of them
    by default). Every rank must call it: a smaller mesh is a new group."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    rank = dist.get_rank()
    return Mesh(group, rank if rank < n else -1, n, group_device())


def mesh_size_for(batch_size: int, n_devices: int) -> int:
    """The largest rank count up to ``n_devices`` that divides the batch
    (the reference's shrink, concepthash_tpu/experiments/hashing.py)."""
    return max(d for d in range(1, n_devices + 1) if batch_size % d == 0)


def _block(v, mesh: Mesh, axis: int):
    if not hasattr(v, "shape") or len(v.shape) <= axis:
        return v
    n = v.shape[axis]
    if n % mesh.size:
        raise ValueError(f"a batch axis of {n} does not split over "
                         f"{mesh.size} ranks")
    rows = mesh.rows(n // mesh.size)
    return v[rows] if axis == 0 else v[:, rows]


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """The rank's block of every array of a batch, along the batch axis
    (the reference places it with ``P('data')``); other values pass."""
    return {k: _block(v, mesh, 0) for k, v in batch.items()}


def shard_batch_chunk(batches: dict, mesh: Mesh) -> dict:
    """The rank's block of a stacked chunk (leaves (K, B, ...)): the chunk
    axis whole, the batch axis split (``P(None, 'data')``)."""
    return {k: _block(v, mesh, 1) for k, v in batches.items()}


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``t`` into ``t`` on every rank of the mesh, in place (a CPU
    tensor goes through the card under NCCL)."""
    if t.device.type == "cpu" and mesh.backend == "nccl":
        tmp = t.to(mesh.device)
        dist.broadcast(tmp, src=0, group=mesh.group)
        t.copy_(tmp)
    else:
        dist.broadcast(t, src=0, group=mesh.group)
    return t


def broadcast_array(arr: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Rank 0's numpy array (same shape and dtype on every rank)."""
    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return broadcast_(t, mesh).numpy()


def _tensors_of(obj) -> list:
    """The tensors of a train-state extra: a tensor, a module's parameters
    and buffers, or an optimizer's state."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        return [v for p in (q for g in obj.param_groups for q in g["params"])
                for v in obj.state.get(p, {}).values() if torch.is_tensor(v)]
    raise TypeError(f"cannot replicate a {type(obj).__name__}")


@torch.no_grad()
def replicate(state, mesh: Mesh):
    """Rank 0's training state on every rank, in place: the model's
    parameters and buffers, the optimizer's state, the generators and a
    method's extras of a ``TrainState``. Returns ``state``."""
    for g in state.generators.values():
        g.set_state(broadcast_(g.get_state(), mesh))
    for obj in (state.model, state.optimizer, *state.extra.values()):
        for t in _tensors_of(obj):
            broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t,
                       mesh)
    return state


def pad_to_multiple(batch: dict, multiple: int):
    """The batch axis zero-padded to a multiple of ``multiple`` (numpy
    copies); returns (batch, n_real)."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
    return out, n
