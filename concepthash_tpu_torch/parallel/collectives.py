"""The collectives a data-parallel step runs, with their gradients, and the
mesh a forward computes its batch statistics over.

Under GSPMD every reduction over the batch is global. Here each rank runs
its forward on its block of the global batch, and:

- a module that reduces over the batch (``models/layers.py``
  ``CodeBatchNorm`` and ``DecorrelatedBN``, SEMICON's suppression mask in
  ``models/finegrained.py``) reads ``current()``, the mesh of the forward
  running in ``sharded_batch(mesh)``, and sums its statistics over the
  ranks (``batch_mean``, ``sum_across``); one that mixes the batch's rows
  (TBH's graph, ``models/tbh.py``) takes the global batch's rows for its
  own (``gather_batch_rows``);
- a random draw over the batch (dropout, the augmentation, the MAE's
  mask) is drawn at the global batch's shape from the generator every rank
  holds in the same state, and the rank takes its rows (``rows_of``);
- a batch of ``views`` stacked views (a two-view method's ``[v1; v2]``)
  is, on each rank, its block of every view, stacked the same way: its
  draws and its gathered outputs follow the global batch's ``[v1; v2]``;
- the loss reads the outputs gathered over the ranks (``GatheredOutputs``:
  each output all-gathered the first time the loss reads it), so every
  rank computes the one-process loss and updates a method's state alike;
- after the backward each rank holds the gradient of its own rows (the
  gather's backward takes the rank's slice), and ``all_reduce_grads``
  sums them: every rank steps with the global gradient.

At one rank every collective is an identity, and a step through them equals
the plain step bit for bit.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Mapping
from typing import Callable

import torch
import torch.distributed as dist

# (mesh, views) of the forward running in ``sharded_batch``
_forward = contextvars.ContextVar("sharded_forward", default=(None, 1))

# outputs whose batch axis is not the first: ConceptHash's (M, B, C)
# concept logits
OUTPUT_BATCH_AXIS = {"logits_concept": 1}


@contextlib.contextmanager
def sharded_batch(mesh, views: int = 1):
    """Run a forward whose batch is this rank's block of ``mesh``'s global
    batch (of each of ``views`` stacked views): its batch statistics and
    draws are the global batch's."""
    token = _forward.set((mesh, views))
    try:
        yield
    finally:
        _forward.reset(token)


def current():
    """The mesh of the forward running in ``sharded_batch``, or None."""
    return _forward.get()[0]


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # newer torch names it all_gather_single and warns on the older name,
    # which older torch has alone
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=group)


def gather_rows_(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' (n, ...) blocks stacked in rank order, (W n, ...): no
    gradient."""
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
    _all_gather(out, x, mesh.group)
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather along the first axis; the backward takes this rank's
    slice of the gradient (every rank computes the same loss from the
    gathered rows, so summing the ranks' slices is the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = mesh.rows(x.shape[0])
        return gather_rows_(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


class _GatherRowsSummed(torch.autograd.Function):
    """All-gather along the first axis for a forward that each rank runs on
    its own rows only (TBH's graph over the batch): the backward sums the
    ranks' gradients of the gathered rows, then takes this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, mesh.rows(x.shape[0])
        return gather_rows_(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g[ctx.rows], None


class _SumAcross(torch.autograd.Function):
    """All-reduce sum; its backward is the all-reduce sum of the
    gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


def gather_rows(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """``x`` all-gathered over the mesh along ``dim``, in rank order, with
    the gradient of this rank's slice."""
    if dim:
        return _GatherRows.apply(x.movedim(dim, 0), mesh).movedim(0, dim)
    return _GatherRows.apply(x, mesh)


def gather_batch_rows(x: torch.Tensor) -> torch.Tensor:
    """In a forward over this rank's block (``sharded_batch``), ``x``'s
    rows of the whole global batch, for a product over the batch that the
    forward computes for its own rows (the gradient of every rank's use
    summed); ``x`` itself outside one."""
    mesh = current()
    if mesh is None:
        return x
    return _GatherRowsSummed.apply(x, mesh)


def sum_across(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, with its gradient."""
    return _SumAcross.apply(x, mesh)


def batch_mean(local_mean: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's mean from each rank's mean over its equal
    block."""
    return sum_across(local_mean * (1.0 / mesh.size), mesh)


def local_rows(mesh, n_local: int, views: int = 1):
    """This rank's rows of the global batch of a local batch of ``n_local``
    rows stacked from ``views`` views: its block of each view."""
    if views == 1:
        return mesh.rows(n_local)
    n = n_local // views
    start = torch.arange(views) * (mesh.size * n) + mesh.rank * n
    return (start[:, None] + torch.arange(n)).reshape(-1)


def rows_of(draw: Callable[[int], torch.Tensor],
            n_local: int) -> torch.Tensor:
    """``draw(n)`` (a tensor whose first axis is the batch, drawn from a
    generator) for this rank's ``n_local`` rows: in a forward under
    ``sharded_batch``, drawn at the global batch's ``n_local * W`` and
    sliced; as is outside one."""
    mesh, views = _forward.get()
    if mesh is None:
        return draw(n_local)
    full = draw(n_local * mesh.size)
    rows = local_rows(mesh, n_local, views)
    return full[rows.to(full.device) if torch.is_tensor(rows) else rows]


class GatheredOutputs(Mapping):
    """A forward's outputs as the loss reads them: each one all-gathered
    over the mesh along its batch axis (``OUTPUT_BATCH_AXIS``, else the
    first; tuples element by element; with ``views``, view by view) the
    first time it is read, so an output the loss never reads costs no
    collective."""

    def __init__(self, outputs: dict, mesh, n_local: int, views: int = 1):
        self._raw = outputs
        self._mesh = mesh
        self._n = n_local
        self._views = views
        self._done: dict = {}

    def _gather(self, key, v):
        if isinstance(v, (tuple, list)):
            return type(v)(self._gather(key, x) for x in v)
        if not torch.is_tensor(v):
            return v
        axis = OUTPUT_BATCH_AXIS.get(key, 0)
        if v.dim() <= axis or v.shape[axis] != self._n:
            raise ValueError(f"output {key!r} of shape {tuple(v.shape)} has "
                             f"no batch axis of {self._n} at {axis}")
        if self._views == 1:
            return gather_rows(v, self._mesh, axis)
        x = v.movedim(axis, 0)
        x = x.reshape(self._views, self._n // self._views, *x.shape[1:])
        x = gather_rows(x, self._mesh, 1)
        return x.reshape(-1, *x.shape[2:]).movedim(0, axis)

    def __getitem__(self, key):
        if key not in self._done:
            self._done[key] = self._gather(key, self._raw[key])
        return self._done[key]

    def __contains__(self, key):
        return key in self._raw

    def __iter__(self):
        return iter(self._raw)

    def __len__(self):
        return len(self._raw)


def gather_batch(batch: dict, mesh, skip=("image",)) -> dict:
    """A sharded batch's other keys (labels, indices) gathered into the
    global batch's, in rank order."""
    return {k: (gather_rows_(v, mesh) if torch.is_tensor(v) and k not in skip
                else v) for k, v in batch.items()}


@torch.no_grad()
def all_reduce_grads(optimizer: torch.optim.Optimizer, mesh) -> None:
    """Sum the gradient of every parameter of the optimizer's groups over
    the mesh, in place: one all-reduce per dtype over the gradients
    flattened in the groups' order (every rank's optimizer holds the same
    parameters, each with a gradient)."""
    by_dtype: dict = {}
    for p in (q for g in optimizer.param_groups for q in g["params"]):
        if p.grad is None:
            raise ValueError("all_reduce_grads: a parameter has no gradient "
                             "(zero_missing_grads gives one to every "
                             "trained parameter)")
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat_views = [g.view(-1) for g in grads]
        flat = torch.cat(flat_views)
        dist.all_reduce(flat, group=mesh.group)
        torch._foreach_copy_(flat_views, list(torch.split(
            flat, [g.numel() for g in grads])))
