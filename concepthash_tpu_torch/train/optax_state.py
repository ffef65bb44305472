"""A JAX package run's optimizer state onto the port's optimizer, for
``resume_logdir`` on a run directory that holds ``optims/last.msgpack``
(the reference's ``{"opt_state", "step", "rng", "epoch"}``).

The reference's optimizer (concepthash_tpu/train/optim.py) is an optax
chain per config, inside ``multi_transform`` over the parameter labels
('train', 'backbone') when the backbone has a rate of its own or is frozen;
a frozen label is ``set_to_zero`` and keeps no state, and inside a label
the other label's leaves are masked (an empty node). Named tuples come as
sequences (or as dicts keyed '0', '1', ...). The chains:

- adam: [add_decayed_weights (with weight decay)], scale_by_adam
  (count, mu, nu), scale_by_learning_rate (count);
- adamw: scale_by_adam, add_decayed_weights, scale_by_learning_rate;
- sgd: [add_decayed_weights], [trace (with momentum)],
  scale_by_learning_rate;
- lars: add_decayed_weights, masked trust ratio, scale_by_learning_rate,
  trace.

``mu`` / ``nu`` / ``count`` become torch Adam's ``exp_avg`` /
``exp_avg_sq`` / ``step``; sgd's ``trace`` the momentum buffer of
``CapturableSGD`` as it is, and lars's that of ``Lars`` negated: lars
scales by the learning rate (times -lr) before its ``trace``, so that
sums -lr * u, where ``Lars``'s buffer sums +lr * u and is subtracted.
Each tree of moments is a tree of the parameters' shape, so the model's
flax -> torch bridge carries it across (transposes and the q|k|v
concatenation act element by element).
"""

from __future__ import annotations

import numpy as np
import torch


def _seq(node) -> list:
    """A serialized named tuple as a list."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def _chain_slots(optim_cfg: dict) -> dict:
    """Where the moments sit in the config's chain: {'adam': i} or
    {'trace': i, 'sign': s} (s the sign that turns the trace into the
    port's momentum buffer), or {} (sgd without momentum keeps none)."""
    name = optim_cfg.get("name", "adam")
    wd = float(optim_cfg.get("weight_decay", 0.0))
    if name == "adam":
        return {"adam": 1 if wd else 0}
    if name == "adamw":
        return {"adam": 0}
    if name == "sgd":
        return ({"trace": 1 if wd else 0, "sign": 1.0}
                if float(optim_cfg.get("momentum", 0.0)) else {})
    if name == "lars":
        return {"trace": 3, "sign": -1.0}
    raise ValueError(f"unknown optimizer {name!r}")


def _label_states(opt_state, labelled: bool) -> list:
    """The chain states of each label that keeps state."""
    if not labelled:
        return [_seq(opt_state)]
    inner = _seq(opt_state)[0]
    out = []
    for label in ("train", "backbone"):
        masked = _seq(inner[label])
        if masked and _seq(masked[0]):       # set_to_zero keeps none
            out.append(_seq(masked[0]))
    return out


def _fill(params, *trees):
    """A tree of ``params``' shape taking each leaf from the first of
    ``trees`` that holds an array there (a masked leaf holds none), else
    zeros."""
    if isinstance(params, dict):
        return {k: _fill(v, *[t.get(k, {}) if isinstance(t, dict) else {}
                              for t in trees])
                for k, v in params.items()}
    for t in trees:
        if isinstance(t, np.ndarray) and t.shape == np.shape(params):
            return t
    return np.zeros(np.shape(params), np.float32)


def load_optax_state(optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module, blob: dict, model_blob: dict,
                     bridge, optim_cfg: dict, labelled: bool) -> int:
    """Set the state of ``optimizer`` (over ``model``'s parameters) from
    the reference's ``blob`` (``optims/last.msgpack``). ``model_blob``: the
    run's model checkpoint
    (``params``, ``batch_stats``, ``constants``); ``bridge``: the model's
    flax -> torch state-dict function; ``labelled``: whether the
    reference's optimizer is a ``multi_transform``. Returns the
    reference's step count."""
    slots = _chain_slots(optim_cfg)
    states = _label_states(blob["opt_state"], labelled)
    params = model_blob["params"]

    def moments(pick):
        tree = _fill(params, *[pick(s) for s in states])
        return bridge({**model_blob, "params": tree})

    by_name = {}
    if "adam" in slots:
        adam = [_seq(s[slots["adam"]]) for s in states]
        mu, nu = moments(lambda s: _seq(s[slots["adam"]])[1]), \
            moments(lambda s: _seq(s[slots["adam"]])[2])
        counts = {int(np.asarray(a[0])) for a in adam}
        if len(counts) > 1:
            raise ValueError(f"the reference's labels stepped {counts} "
                             "times: one count per run expected")
        count = counts.pop() if counts else 0
        for n in mu:
            by_name[n] = {"exp_avg": mu[n], "exp_avg_sq": nu[n]}
    elif "trace" in slots:
        tr = moments(lambda s: _seq(s[slots["trace"]])[0])
        by_name = {n: {"momentum_buffer": slots["sign"] * v}
                   for n, v in tr.items()}
    names = {p: n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        capturable = bool(group.get("capturable", False))
        for p in group["params"]:
            state = {k: v.to(p.device, p.dtype).reshape(p.shape).clone()
                     for k, v in by_name.get(names[p], {}).items()}
            if "adam" in slots:
                state["step"] = torch.tensor(
                    float(count), dtype=torch.float32,
                    device=p.device if capturable else "cpu")
            if state:
                optimizer.state[p] = state
    return int(np.asarray(blob["step"]))
