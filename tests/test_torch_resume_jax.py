"""A JAX package run resumed by the port, on the CPU: the reference's
``main.py`` experiment trains one epoch of ``model=orthohash_adapter
backbone=tiny_test`` (16 bits, batch 8, 3 steps; a frozen backbone, so its
optax state is a ``multi_transform`` with a ``set_to_zero`` label) with
``save_training_state=true`` under adam and under sgd, and
``main_gpu.py --device cpu resume_logdir=<that run>`` resumes it.

Held:

- the model's parameters and BatchNorm statistics equal the reference's
  (through ``weights.baseline_from_flax``) exactly;
- each trained parameter's optimizer state equals optax's, carried by the
  same bridge from the live optax state (named tuples read by attribute,
  not through the checkpoint's serialized form): adam's ``mu``, ``nu`` and
  ``count`` as ``exp_avg``, ``exp_avg_sq`` and ``step``, sgd's ``trace``
  as the momentum buffer; frozen parameters hold none;
- the schedule stands at the reference's step count and the train loader
  at the next epoch;
- one train step from there (a fixed batch, no augmentation) equals the
  reference's ``make_train_step`` from its state within 1e-5: the loss,
  every parameter and the running statistics.
"""

import copy
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.config import loader as jloader
from concepthash_tpu.data.synthetic import make_synthetic_dataset
from concepthash_tpu.experiments.hashing import (RetrievalExperiment as
                                                 JExperiment)
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu_torch.weights import baseline_from_flax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import main_gpu  # noqa: E402

TOL = 1e-5


def _args(wd, logdir, optim, *extra):
    return ["dataset=synthetic", "model=orthohash_adapter",
            "backbone=tiny_test", "model.nbit=16", "batch_size=8",
            "eval_interval=1", f"data_dir={wd}", f"logdir={logdir}",
            "seed=7", f"optim={optim}", "save_training_state=true", *extra]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("resume_jax")
    make_synthetic_dataset(str(wd / "data" / "synthetic"), nclass=3,
                           per_class_train=8, per_class_test=4, image_size=64)
    return str(wd)


def _moments(jexp, pick) -> dict:
    """The port-named tensors of one optax moment tree: ``pick(state)`` of
    each label that keeps state, masked leaves as zeros."""
    params = jax.tree_util.tree_map(np.asarray, jexp.state.params)
    inner = jexp.state.opt_state.inner_states
    trees = [pick(s.inner_state) for label, s in inner.items()
             if label == "train"]

    def leaf(p, *ts):
        for t in ts:
            if hasattr(t, "shape"):
                return np.asarray(t)
        return np.zeros_like(p)

    tree = jax.tree_util.tree_map(leaf, params, *trees,
                                  is_leaf=lambda x: x is None)
    v = jax.tree_util.tree_map(np.asarray, jexp.state.variables())
    return baseline_from_flax({**v, "params": tree})


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_port_resumes_a_jax_run(workdir, optim):
    ref = os.path.join(workdir, f"jax_{optim}")
    cfg = jloader.load_config(str(ROOT / "configs"), "train",
                              _args(workdir, ref, optim, "epochs=1"))
    jexp = JExperiment(cfg)
    jexp.main()
    assert os.path.exists(os.path.join(ref, "optims", "last.msgpack"))

    port = main_gpu.build_experiment([
        "--device", "cpu", *_args(workdir, os.path.join(workdir, f"port_"
                                                        f"{optim}"), optim,
                                  "epochs=2", f"resume_logdir={ref}")])
    assert port.start_epoch == 1
    want = baseline_from_flax(jax.tree_util.tree_map(
        np.asarray, jexp.state.variables()))
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, want[k]), k

    tr = port.training
    steps = int(jexp.state.step)
    assert port.state.step == steps == 3
    assert port.loaders["train"].epoch == 1
    chain = jexp.state.opt_state.inner_states["train"].inner_state
    if optim == "adam":
        adam = chain[1]            # after add_decayed_weights
        mus = _moments(jexp, lambda s: s[1].mu)
        nus = _moments(jexp, lambda s: s[1].nu)
        count = float(adam.count)
        assert count == steps
    else:
        traces = _moments(jexp, lambda s: s[1].trace)
    held = 0
    for name, p in port.model.named_parameters():
        st = tr.optimizer.state.get(p, {})
        if not p.requires_grad:
            assert not st, name
            continue
        held += 1
        if optim == "adam":
            assert float(st["step"]) == count
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          mus[name].numpy(), err_msg=name)
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                          nus[name].numpy(), err_msg=name)
        else:
            np.testing.assert_array_equal(st["momentum_buffer"].numpy(),
                                          traces[name].numpy(),
                                          err_msg=name)
    assert held > 0

    rng = np.random.default_rng(11)
    batch = {"image": rng.standard_normal((8, 48, 48, 3)).astype(np.float32),
             "label": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]}
    jstep = jmake_train_step(jexp.model, jexp.loss_fn, jexp.tx, donate=False)
    jstate, jmet = jstep(jexp.state, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    tmet = tr.step({k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=TOL, atol=TOL)
    want = baseline_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.variables()))
    moved = 0
    for k, v in port.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
        moved += not torch.equal(v, baseline_from_flax(
            jax.tree_util.tree_map(np.asarray,
                                   jexp.state.variables()))[k])
    assert moved > 0
    port_copy = copy.deepcopy(port.training.scheduler.state_dict())
    assert port_copy["last_epoch"] == steps + 1
