"""Train and eval steps (counterpart of concepthash_tpu/train/state.py).

The reference steps an immutable pytree with pure jitted functions; here the
state is the model (parameters, and the code BatchNorm's running statistics
as buffers), the optimizer and its LR scheduler, all updated in place by one
call of the step. Not ported: the reference's ``lax.scan`` chunking of
several steps into one dispatch (``make_multi_train_step``) and the fused
device augmentation (``preprocess_fn``): the steps take preprocessed images.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer, scheduler=None,
                    output_attentions: bool = False,
                    generator: Optional[torch.Generator] = None) -> Callable:
    """loss_fn(outputs, batch) -> (total, parts). Returns step(batch) ->
    metrics: one call runs the forward with ``train=True`` (dropout drawn
    from ``generator``), the loss, the backward, the optimizer step and the
    schedule step, and returns the loss, its parts and the accuracies as
    detached 0-d tensors (reading them waits for the device). batch holds
    image (B, H, W, C) normalized and label (B, C) one-hot f32."""

    def step(batch: dict) -> dict:
        out = model(batch["image"], train=True,
                    output_attentions=output_attentions, generator=generator)
        total, parts = loss_fn(out, batch)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        with torch.no_grad():
            return {"loss": total.detach(),
                    **{k: v.detach() for k, v in parts.items()},
                    **accuracy_metrics(out, batch["label"])}

    return step


def make_eval_step(model: nn.Module,
                   loss_fn: Optional[Callable] = None) -> Callable:
    """step(batch) -> (codes, metrics): the forward in inference mode; codes
    are the 2-d outputs whose key contains 'codes'."""

    def step(batch: dict):
        with torch.inference_mode():
            out = model(batch["image"], train=False)
            metrics = {}
            if loss_fn is not None:
                total, parts = loss_fn(out, batch)
                metrics = {"loss": total, **parts,
                           **accuracy_metrics(out, batch["label"])}
            codes = {k: v for k, v in out.items()
                     if "codes" in k and v.dim() == 2}
        return codes, metrics

    return step


def accuracy_metrics(outputs: dict, onehot: torch.Tensor) -> dict:
    """Top-1 accuracy for every '*logits*' output; 3-d (Q, B, C) logits are
    averaged over concepts first."""
    y = onehot.argmax(dim=-1)
    metrics = {}
    for key, val in outputs.items():
        if "logits" not in key or not torch.is_tensor(val):
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
