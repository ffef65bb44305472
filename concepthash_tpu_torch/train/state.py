"""The train state, and the train and eval steps, one and several at a time
(counterpart of concepthash_tpu/train/state.py).

The reference steps an immutable pytree with pure jitted functions; here the
state is the model (parameters, and the code BatchNorm's running statistics
as buffers), the optimizer and its LR scheduler, updated in place by the
step, and the explicit generators the step and the data draw from
(``TrainState`` gathers them for checkpoints and resume).

``make_multi_train_step`` and ``make_multi_eval_step`` take K batches
stacked (K, B, ...) and return metrics (and codes) stacked (K, ...), with
the meaning of the reference's ``lax.scan``: K real optimizer steps in
order, equal to K calls of the single step. On the CPU they are that loop;
on the card, one CUDA graph replay per chunk (``train/graphs.py``).

The steps take preprocessed images: the reference runs its device
augmentation inside the step (``preprocess_fn``), the port runs it on the
card before the step, outside the graph, since TrivialAugment's grouping by
op gives shapes that depend on the draws.

With a ``mesh`` (``parallel.mesh.Mesh``, the reference's ``mesh=``) a
step takes this rank's block of the global batch (``shard_batch``; of
each view, stacked, for a two-view batch of ``views`` 2) and
computes what the one-process step computes on the whole batch: the
forward's batch statistics and draws are the global batch's, the loss,
the metrics and the codes are computed from the outputs, labels and
indices gathered over the ranks (``parallel.collectives``), and the
gradients are summed over the ranks after ``zero_missing_grads`` and
before the optimizer's step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from concepthash_tpu_torch.parallel import collectives
from concepthash_tpu_torch.train.optim import (follow_schedule,
                                               zero_missing_grads)


@dataclasses.dataclass
class TrainState:
    """What a training run steps, in one record: the model, its optimizer
    and LR schedule, the step counter, and the explicit generators
    (``generators``: dropout, the augmentation's draws on the card, the
    op-index draws on the host), plus the train loader, whose shuffle order
    is a function of its epoch, and a method's own extras (``extra``:
    tensors, modules and optimizers its train step updates in place:
    HashNet's bank, ODC's memory, an EMA teacher, TBH's discriminator and
    its optimizer). ``state_dict`` / ``load_state_dict`` carry everything
    but the model's own weights (``model.state_dict()``), which checkpoints
    keep apart, as the reference keeps ``params`` apart from
    ``opt_state``."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: object
    generators: dict
    loader: object = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def step(self) -> int:
        """Optimizer steps taken (the schedule's count)."""
        return int(self.scheduler.last_epoch)

    def state_dict(self) -> dict:
        sd = {"optimizer": self.optimizer.state_dict(),
              "scheduler": self.scheduler.state_dict(),
              "step": self.step,
              "generators": {k: g.get_state()
                             for k, g in self.generators.items()}}
        if self.loader is not None:
            sd["loader_epoch"] = int(self.loader.epoch)
        if self.extra:
            sd["extra"] = {k: (v.detach().cpu() if torch.is_tensor(v)
                               else v.state_dict())
                           for k, v in self.extra.items()}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore what ``state_dict`` wrote, keeping each optimizer's own
        form (``load_optimizer_state``)."""
        load_optimizer_state(self.optimizer, sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        if int(self.scheduler.last_epoch) != int(sd["step"]):
            raise ValueError(f"train state: schedule at step "
                             f"{self.scheduler.last_epoch}, record says "
                             f"{sd['step']}")
        for k, state in sd["generators"].items():
            self.generators[k].set_state(state)
        if self.loader is not None and "loader_epoch" in sd:
            self.loader.epoch = int(sd["loader_epoch"])
        for k, v in sd.get("extra", {}).items():
            own = self.extra[k]
            if torch.is_tensor(own):
                own.copy_(v)
            elif isinstance(own, torch.optim.Optimizer):
                load_optimizer_state(own, v)
            else:
                own.load_state_dict(v)


def load_optimizer_state(optimizer: torch.optim.Optimizer, sd: dict) -> None:
    """``optimizer.load_state_dict(sd)``, keeping the optimizer's own form:
    a capturable optimizer (``optim.make_capturable``) keeps its device
    ``lr`` tensors and step counters on the device."""
    own = [(g["lr"], g.get("capturable")) for g in optimizer.param_groups]
    # load_state_dict replaces the group dicts: the new ones take this
    # optimizer's own lr tensors back (a graph and its runner hold them)
    optimizer.load_state_dict(sd)
    for g, (lr, capturable) in zip(optimizer.param_groups, own):
        loaded = g["lr"]
        if torch.is_tensor(lr):
            lr.fill_(float(loaded))
            g["lr"] = lr
        else:
            g["lr"] = float(loaded)
        if capturable is None:      # sgd: no flag, no step counter
            continue
        g["capturable"] = capturable
        for p in g["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(
                    p.device if capturable else "cpu", torch.float32)


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       scheduler, generators: dict, loader=None,
                       extra: Optional[dict] = None) -> TrainState:
    """The record of one run's training state (the reference's
    ``create_train_state``; here the parts already exist and are gathered,
    not initialised)."""
    return TrainState(model, optimizer, scheduler, dict(generators), loader,
                      dict(extra or {}))


def sharded_forward(model: nn.Module, batch: dict, mesh, views: int = 1,
                    **kw) -> tuple:
    """(outputs, batch) as the loss reads them: ``model(batch['image'],
    **kw)`` and the batch, or, under a mesh, the forward of this rank's
    block (of each of ``views`` stacked views) with the global batch's
    statistics and draws, its outputs gathered as they are read and the
    batch's other keys gathered."""
    if mesh is None:
        return model(batch["image"], **kw), batch
    with collectives.sharded_batch(mesh, views):
        out = model(batch["image"], **kw)
    return (collectives.GatheredOutputs(out, mesh, batch["image"].shape[0],
                                        views),
            collectives.gather_batch(batch, mesh))


def backward(total: torch.Tensor, optimizer: torch.optim.Optimizer,
             mesh=None) -> None:
    """The gradients of ``total`` for the optimizer's step: every trained
    parameter's (``zero_missing_grads``), summed over the mesh's ranks
    under one."""
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    zero_missing_grads(optimizer)
    if mesh is not None:
        collectives.all_reduce_grads(optimizer, mesh)


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer, scheduler=None,
                    output_attentions: bool = False,
                    generator: Optional[torch.Generator] = None,
                    mesh=None, views: int = 1) -> Callable:
    """loss_fn(outputs, batch) -> (total, parts). Returns step(batch) ->
    metrics: one call runs the forward with ``train=True`` (dropout drawn
    from ``generator``), the loss, the backward, the optimizer step and the
    schedule step, and returns the loss, its parts and the accuracies as
    detached 0-d tensors (reading them waits for the device). batch holds
    image (B, H, W, C) normalized and label (B, C) one-hot f32. Every step
    takes the float32 rate of the schedule: a capturable optimizer
    (``optim.make_capturable``, what the card builds) through
    ``optim.follow_schedule``, one with float rates (the CPU) through
    ``optim.EpochLambdaLR``."""

    def step(batch: dict) -> dict:
        out, batch = sharded_forward(model, batch, mesh, views, train=True,
                                     output_attentions=output_attentions,
                                     generator=generator)
        total, parts = loss_fn(out, batch)
        backward(total, optimizer, mesh)
        follow_schedule(optimizer, scheduler)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        with torch.no_grad():
            return {"loss": total.detach(),
                    **{k: v.detach() for k, v in parts.items()},
                    **accuracy_metrics(out, batch["label"])}

    return step


def make_eval_step(model: nn.Module,
                   loss_fn: Optional[Callable] = None, mesh=None) -> Callable:
    """step(batch) -> (codes, metrics): the forward in inference mode; codes
    are the 2-d outputs whose key contains 'codes'. Under a mesh, the
    codes and metrics of the global batch, on every rank."""

    def step(batch: dict):
        with torch.inference_mode():
            out, batch = sharded_forward(model, batch, mesh, train=False)
            metrics = {}
            if loss_fn is not None:
                total, parts = loss_fn(out, batch)
                metrics = {"loss": total, **parts,
                           **accuracy_metrics(out, batch["label"])}
            codes = {k: out[k] for k in out
                     if "codes" in k and out[k].dim() == 2}
        return codes, metrics

    return step


def _stacked(per_step: list) -> dict:
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_multi_train_step(model: nn.Module, loss_fn: Callable,
                          optimizer: torch.optim.Optimizer, scheduler=None,
                          output_attentions: bool = False,
                          generator: Optional[torch.Generator] = None,
                          mesh=None, views: int = 1) -> Callable:
    """K train steps per call: ``multi_step(batches) -> metrics``, batches a
    dict of (K, B, ...) tensors, each metric stacked (K,). Equal to K calls
    of ``make_train_step``'s step in order. On the CPU it is that loop; on
    the card it is ``graphs.GraphedTrainSteps``: the first call runs its K
    steps eagerly (the warm-up, whose steps are real), the second captures
    the K steps into one CUDA graph, and every call from then on is one
    replay. ``multi_step.last_lrs`` holds the (K,) learning rates of the
    first parameter group that the last call's steps used."""
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        from concepthash_tpu_torch.train.graphs import GraphedTrainSteps

        return GraphedTrainSteps(model, loss_fn, optimizer, scheduler,
                                 output_attentions, generator, mesh, views)
    step = make_train_step(model, loss_fn, optimizer, scheduler,
                           output_attentions, generator, mesh, views)

    def multi_step(batches: dict) -> dict:
        per_step, lrs = [], []
        for k in range(next(iter(batches.values())).shape[0]):
            lrs.append(float(optimizer.param_groups[0]["lr"]))
            per_step.append(step({n: v[k] for n, v in batches.items()}))
        multi_step.last_lrs = torch.tensor(lrs, dtype=torch.float32)
        return _stacked(per_step)

    multi_step.last_lrs = None
    return multi_step


def make_multi_eval_step(model: nn.Module,
                         loss_fn: Optional[Callable] = None,
                         mesh=None) -> Callable:
    """K eval batches per call: ``multi(batches) -> (codes, metrics)``,
    batches (K, B, ...), codes (K, B, nbit) and metrics (K,). Equal to K
    calls of ``make_eval_step``'s step. On the card, one CUDA graph replay
    a call from the second call on (``graphs.GraphedEvalSteps``)."""
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        from concepthash_tpu_torch.train.graphs import GraphedEvalSteps

        return GraphedEvalSteps(model, loss_fn, mesh)
    step = make_eval_step(model, loss_fn, mesh)

    def multi(batches: dict):
        outs = [step({n: v[k] for n, v in batches.items()})
                for k in range(next(iter(batches.values())).shape[0])]
        codes = _stacked([c for c, _ in outs])
        metrics = _stacked([m for _, m in outs]) if outs[0][1] else {}
        return codes, metrics

    return multi


def accuracy_metrics(outputs: dict, onehot: torch.Tensor) -> dict:
    """Top-1 accuracy for every '*logits*' output; 3-d (Q, B, C) logits are
    averaged over concepts first."""
    y = onehot.argmax(dim=-1)
    metrics = {}
    for key in outputs:
        if "logits" not in key:
            continue
        val = outputs[key]
        if not torch.is_tensor(val):
            continue
        if val.dim() == 3:
            pred = val.mean(dim=0).argmax(dim=-1)
        elif val.dim() == 2:
            pred = val.argmax(dim=-1)
        else:
            continue
        suffix = key.split("_", 1)[1] if "_" in key else key[len("logits"):]
        name = "acc" if key == "logits" else f"acc_{suffix}"
        metrics[name] = (pred == y).float().mean()
    return metrics
