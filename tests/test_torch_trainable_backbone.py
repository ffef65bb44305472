"""A trainable backbone (``backbone_lr_scale=0.1``) on the CPU against the JAX
package. optax updates every leaf of a trained label, also one the loss never
reaches (its gradient is zero): weight decay and the moments still move it.
The port's optimizers skip a parameter without a gradient, so every step
gives such a parameter a zero one (``optim.zero_missing_grads``). Held:

- three steps of ``orthohash_adapter`` and of ``concepthash`` (the config
  dicts of their configs/model/*.yaml on configs/backbone/tiny_test.yaml,
  16 bits, adapters of width 16, adam at weight decay 1e-5, dropout 0)
  against the reference's ``make_train_step`` from the same weights: each
  step's loss and every parameter and running statistic within
  1e-6 + 1e-4 |ref| (entries whose gradient is zero in exact arithmetic
  within the updates' bound, as ``test_torch_train_slice.py`` holds
  them), and
  ``backbone.tower.visual_projection.weight`` (orthohash) or
  ``backbone.visual_projection.weight`` and
  ``backbone.post_layernorm.weight`` (concepthash), which no loss
  reaches, moved on both sides;
- a JAX ``main.py`` run of orthohash_adapter at ``backbone_lr_scale=0.1``
  resumed by ``main_gpu.py --device cpu``, then one step on each side from
  the equal states: every tensor within 1e-5 + 1e-5 |ref| (null-gradient
  entries as above), and the visual projection moved.
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

from concepthash_tpu import methods as jmethods
from concepthash_tpu.config import loader as jloader
from concepthash_tpu.data.synthetic import make_synthetic_dataset
from concepthash_tpu.experiments.hashing import (RetrievalExperiment as
                                                 JExperiment)
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.weights import baseline_from_flax, from_flax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import main_gpu  # noqa: E402

NCLASS, NBIT, BATCH, IMAGE, STEPS, SPE = 10, 16, 6, 48, 3, 2
SCALE = 0.1
RTOL, ATOL = 1e-4, 1e-6
RESUME_TOL = 1e-5
# configs/backbone/tiny_test.yaml
TINY_TEST = {"name": "tiny", "hidden_size": 64, "intermediate_size": 128,
             "num_layers": 2, "num_heads": 4, "patch_size": 8,
             "image_size": IMAGE, "projection_dim": 32}
# entries with a gradient of zero in exact arithmetic, whose rounding noise
# adam turns into updates no two frameworks share (see
# test_torch_train_slice.py): concepthash's two leaves; with the tower
# trained, every layer's key bias (the middle third of q|k|v's bias: a
# softmax row is invariant to it); under orthohash the tower's last
# LayerNorm bias (a shift of every code, which the code BatchNorm removes);
# and the code BatchNorm's running mean, which that bias (orthohash) or
# hash_pe (concepthash) shifts, by less than their own bound.
# Held within 2 x the summed rates of the three steps (1e-4, 1e-4, 2e-4 in
# the train group), which also bounds the resumed run's one step (2e-4).
NULL_GRADIENT = {"orthohash": ("backbone.tower.post_layernorm.bias",
                               "hash_bn.running_mean"),
                 "concepthash": ("hash_attention.sa.key.bias", "hash_pe",
                                 "hash_bn.running_mean")}
KEY_BIAS = "self_attn.qkv_proj.bias"
NULL_BOUND = 2 * 4e-4
# the leaves no loss reaches, by model, that decay (a zero bias stays zero)
UNREACHED = {
    "orthohash": ("backbone.tower.visual_projection.weight",),
    "concepthash": ("backbone.visual_projection.weight",
                    "backbone.post_layernorm.weight"),
}


def config(name: str) -> dict:
    common = {"backbone": dict(TINY_TEST),
              "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
              "scheduler": {"name": "csw", "warmup_epochs": 10},
              "epochs": 100, "backbone_lr_scale": SCALE, "batch_size": BATCH,
              "compute_dtype": "float32", "seed": 0,
              "dataset": {"nclass": NCLASS, "multiclass": False}}
    if name == "orthohash":
        return {**common,
                "model": {"name": "orthohash", "nbit": NBIT,
                          "nclass": NCLASS, "has_adapter": True,
                          "adapter_bottleneck_dim": 16, "add_bn": True},
                "criterion": {"name": "orthohash", "ce": 1, "s": 8, "m": 0.2,
                              "m_type": "cos", "multiclass": False,
                              "quan": 0, "quan_type": "cs",
                              "multiclass_loss": "label_smoothing"}}
    return {**common,
            "model": {"name": "concepthash", "nbit": NBIT, "nclass": NCLASS,
                      "ncontext": 4, "has_adapter": True,
                      "adapter_bottleneck_dim": 16,
                      "upt_config": {"multi": True, "num_heads": 8,
                                     "dropout": 0.0,
                                     "ensemble_method": "concat",
                                     "single_hash_fc": True, "hash_pe": True},
                      "add_bn": True, "use_before_projection": True,
                      "concept_reg": True, "text_projection_dims": [32]},
            "criterion": {"name": "lgh", "margin": 0.2, "scale": 8,
                          "loss_scales": {"logits": 0, "hash_logits": 0,
                                          "bin_logits": 1, "cont_logits": 1,
                                          "attn_div_loss": 0,
                                          "concept_logits": 1},
                          "avg_before_softmax": False, "lmbd": 0.5,
                          "div_method": 1, "ncontext": 4}}


def batches(seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal(
                 (BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
             "label": np.eye(NCLASS, dtype=np.float32)[
                 rng.integers(0, NCLASS, BATCH)]} for _ in range(STEPS)]


def _seed_adapter_ups(tree, rng):
    """The adapters' up-projections start at zero, which would leave their
    down-projections without a gradient: seeded values instead."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if k.startswith("adapter") and "up" in v:
            v["up"]["kernel"] = (0.1 * rng.standard_normal(
                v["up"]["kernel"].shape)).astype(np.float32)
        else:
            _seed_adapter_ups(v, rng)


def _assert_leaves_match(got: dict, want: dict, name: str, rtol: float,
                         atol: float) -> None:
    """Every tensor within atol + rtol |ref|, null-gradient entries within
    ``NULL_BOUND``."""
    assert set(got) == set(want)
    for k in got:
        g, w = got[k].numpy(), want[k].numpy()
        null = np.zeros(g.shape, bool)
        if k in NULL_GRADIENT[name]:
            null[...] = True
        elif k.endswith(KEY_BIAS):
            D = g.shape[0] // 3
            null[D:2 * D] = True
        assert np.abs(g - w)[null].max(initial=0) <= NULL_BOUND, k
        np.testing.assert_allclose(g[~null], w[~null], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["orthohash", "concepthash"])
def test_three_steps_move_every_trained_leaf_as_jax(name):
    cfg = config(name)
    rng = np.random.default_rng(1)
    if name == "orthohash":
        cb = np.where(rng.standard_normal((NCLASS, NBIT)) > 0, 1.0,
                      -1.0).astype(np.float32)
        method = jmethods.get_method("orthohash")
        jm, jloss = method.build_model(cfg, cb), method.build_loss(cfg, cb)
        bridge = baseline_from_flax
    else:
        cb = rng.standard_normal((NCLASS, 32)).astype(np.float32)
        jm = jmethods._build_concepthash(cfg, cb)
        jloss = jmethods._lgh_build_loss(cfg, cb)
        bridge = from_flax
    sample = jnp.zeros((BATCH, IMAGE, IMAGE, 3))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)}, sample)
    variables = jax.tree_util.tree_map(np.array, variables)
    _seed_adapter_ups(variables["params"]["backbone"], rng)
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], SPE,
                          variables["params"], backbone_lr_scale=SCALE)
    state = create_train_state(jm, tx, sample, key, variables=variables)
    jstep = jmake_train_step(jm, jloss, tx, donate=False)

    tr = tmethods.build_training(cfg, cb, SPE, device="cpu")
    tr.model.load_state_dict(bridge(variables), strict=True)
    assert len(tr.optimizer.param_groups) == 2      # train, backbone x 0.1
    before = copy.deepcopy(tr.model.state_dict())
    for i, b in enumerate(batches(2)):
        state, jmet = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        tmet = tr.step({k: torch.tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {i}")
    want = bridge(jax.tree_util.tree_map(np.asarray, state.variables()))
    got = tr.model.state_dict()
    _assert_leaves_match(got, want, name, RTOL, ATOL)
    for k in UNREACHED[name]:
        assert not torch.equal(want[k], before[k]), k
        assert not torch.equal(got[k], before[k]), k
    assert all(p.requires_grad for p in tr.model.parameters())


# ---------------------------------------------------------------------------
# a JAX run at backbone_lr_scale=0.1, resumed by the port
# ---------------------------------------------------------------------------

def _args(wd, logdir, *extra):
    return ["dataset=synthetic", "model=orthohash_adapter",
            "backbone=tiny_test", "model.nbit=16", "batch_size=8",
            "eval_interval=1", f"data_dir={wd}", f"logdir={logdir}",
            "seed=7", "optim=adam", f"backbone_lr_scale={SCALE}",
            "save_training_state=true", *extra]


def test_jax_run_resumed_steps_every_trained_leaf_as_jax(tmp_path):
    wd = str(tmp_path)
    make_synthetic_dataset(os.path.join(wd, "data", "synthetic"), nclass=3,
                           per_class_train=8, per_class_test=4, image_size=64)
    ref = os.path.join(wd, "jax")
    jexp = JExperiment(jloader.load_config(str(ROOT / "configs"), "train",
                                           _args(wd, ref, "epochs=1")))
    jexp.main()
    port = main_gpu.build_experiment(
        ["--device", "cpu", *_args(wd, os.path.join(wd, "port"), "epochs=2",
                                   f"resume_logdir={ref}")])
    assert port.state.step == int(jexp.state.step) == 3
    start = baseline_from_flax(jax.tree_util.tree_map(
        np.asarray, jexp.state.variables()))
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, start[k]), k

    rng = np.random.default_rng(11)
    batch = {"image": rng.standard_normal((8, 48, 48, 3)).astype(np.float32),
             "label": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]}
    jstep = jmake_train_step(jexp.model, jexp.loss_fn, jexp.tx, donate=False)
    jstate, jmet = jstep(jexp.state, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    tmet = port.training.step({k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=RESUME_TOL, atol=RESUME_TOL)
    want = baseline_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.variables()))
    _assert_leaves_match(port.model.state_dict(), want, "orthohash",
                         RESUME_TOL, RESUME_TOL)
    k = UNREACHED["orthohash"][0]
    assert not torch.equal(port.model.state_dict()[k], start[k])
