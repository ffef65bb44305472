"""The supervised baselines of the PyTorch port against the JAX package, on
the CPU at a tiny size: the CLIP-adapter trunk at hidden 64, 2 layers, 4
heads, 32^2 images in patches of 8, adapters of 16; 16 bits, 10 classes;
float32. Each JAX model is built once per head and its seeded variables
(the adapters' zero up-projections given seeded values, so they carry
signal) are carried across by ``weights.baseline_from_flax``.

Held:

- each head's forward (orthohash with its code BatchNorm and bcs's
  sign-centroid logits, csq, pairwise, ce linear and cosine, greedyhash,
  descriptor, clip) at ``train=False``, and orthohash's at ``train=True``
  with the running statistics after it, at rtol 1e-5;
- each loss on seeded outputs, single-label and multi-label, with
  DTSH's rows that have no positive or no negative and CSQ's zero-sum
  centers, at rtol 1e-5;
- three steps of ``methods.build_training`` against the reference's
  ``make_train_step`` for every method but hashnet (adam, the csw
  schedule, a frozen backbone), and three HashNet steps against
  ``_hashnet_step`` with the bank off and on, at ``step_continuation=1``
  and one step an epoch so that beta changes every step: metrics,
  parameters, running statistics and the bank at rtol 1e-4, the train
  slice's tolerance;
- the pairwise hash layer's torch-default init bound.

The trunk's layers take the reference's ``auto`` routes on the CPU (its
plain XLA layers); the port's take the whole-layer function's plain
version in eval, as ``tests/test_torch_concepthash_options.py`` does.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu import methods as jmethods
from concepthash_tpu.losses import baselines as JL
from concepthash_tpu.losses import common as JC
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.losses import baselines as TL
from concepthash_tpu_torch.losses import common as TC
from concepthash_tpu_torch.weights import baseline_from_flax

NCLASS, NBIT, BATCH, IMAGE, STEPS, SPE, PROJ = 10, 16, 6, 32, 3, 2, 32
RTOL = 1e-5
TRAIN_RTOL = 1e-4

BACKBONE = {"name": "tiny", "hidden_size": 64, "intermediate_size": 128,
            "num_layers": 2, "num_heads": 4, "patch_size": 8,
            "image_size": IMAGE, "projection_dim": PROJ}
ORTHOHASH = {"ce": 1, "s": 8, "m": 0.2, "m_type": "cos", "quan": 0,
             "quan_type": "cs", "multiclass_loss": "label_smoothing"}
# the method's model and criterion keys, as configs/model/*.yaml hold them
METHODS = {
    "orthohash": ({"add_bn": True}, ORTHOHASH),
    "orthohash_bcs": ({"add_bn": True}, dict(ORTHOHASH, bcs_scale=0.5)),
    "csq": ({}, {"lambda_q": 0.001}),
    "dpn": ({}, {"sl": 1, "margin": 1, "reg": 0.1}),
    "hashnet": ({}, {"alpha": 1, "beta": 1, "step_continuation": 1}),
    "dpsh": ({}, {"alpha": 1}),
    "dtsh": ({}, {"alpha": 5, "lmbd": 1}),
    "greedyhash": ({}, {"alpha": 0.1, "pow": 3}),
    "ce": ({"m_type": "ce"}, {}),
    "ce_cossim": ({"m_type": "cos"}, {"m_type": "cos", "margin": 0.2,
                                      "scale": 8}),
    "descriptor": ({}, {}),
    "clip": ({}, {}),
}
SIGNED = ("orthohash", "orthohash_bcs", "csq", "dpn")


def config(name: str, **criterion) -> dict:
    model, crit = METHODS[name]
    return {
        "model": {"name": "ce" if name == "ce_cossim" else name,
                  "nbit": NBIT, "nclass": NCLASS, "has_adapter": True,
                  "adapter_bottleneck_dim": 16, **model},
        "backbone": dict(BACKBONE),
        "criterion": {**crit, **criterion},
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 10},
        "epochs": 100, "backbone_lr_scale": 0, "batch_size": BATCH,
        "compute_dtype": "float32", "seed": 0,
        "dataset": {"nclass": NCLASS, "multiclass": False},
    }


def codebook(name: str):
    rng = np.random.default_rng(5)
    if name in SIGNED:
        return np.where(rng.standard_normal((NCLASS, NBIT)) > 0, 1.0,
                        -1.0).astype(np.float32)
    if name == "clip":
        return rng.standard_normal((NCLASS, PROJ)).astype(np.float32)
    return None


def images(seed, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n, IMAGE, IMAGE, 3)).astype(np.float32)


def onehot(labels):
    return np.eye(NCLASS, dtype=np.float32)[labels]


def batches(seed, n_rows=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"image": images(int(rng.integers(1 << 30))),
             "label": onehot(rng.integers(0, NCLASS, BATCH))}
        if n_rows:
            b["index"] = rng.choice(n_rows, BATCH, replace=False).astype(
                np.int32)
        out.append(b)
    return out


def _seed_adapters(tree, rng):
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if k.startswith("adapter") and "up" in v:
            v["up"]["kernel"] = (0.1 * rng.standard_normal(
                v["up"]["kernel"].shape)).astype(np.float32)
        else:
            _seed_adapters(v, rng)


@functools.lru_cache(maxsize=None)
def reference(name: str):
    """The JAX model of ``name`` with seeded variables (numpy leaves), and
    the port's model carrying them."""
    cfg = config(name)
    cb = codebook(name)
    method = jmethods.get_method(cfg["model"]["name"])
    jm = method.build_model(cfg, cb)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        jnp.zeros((BATCH, IMAGE, IMAGE, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)
    _seed_adapters(variables["params"]["backbone"], np.random.default_rng(2))
    model, _ = tmethods.build_model(cfg, cb, device="cpu")
    model.load_state_dict(baseline_from_flax(variables), strict=True)
    return cfg, cb, jm, variables, model


def _assert_close(got: dict, want: dict, rtol, atol=1e-6):
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


HEADS = ["orthohash_bcs", "csq", "hashnet", "ce", "ce_cossim", "greedyhash",
         "descriptor", "clip"]


@pytest.mark.parametrize("name", HEADS)
def test_head_forward_matches_jax(name):
    """The eval forward of each head within rtol 1e-5; orthohash's
    train-mode forward (batch statistics) too, with the running statistics
    it leaves."""
    cfg, _, jm, variables, model = reference(name)
    x = images(11)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = copy.deepcopy(model)(torch.tensor(x))
    # clip's logits are cosines times exp(logit_scale) = 1 / 0.07: atol
    # 1e-6 a unit of cosine
    _assert_close(got, want, RTOL, atol=1e-6 / 0.07 if name == "clip"
                  else 1e-6)
    if name != "orthohash_bcs":
        return
    assert {"logits", "logits2"} <= set(got)
    want, stats = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    pm = copy.deepcopy(model)
    got = pm(torch.tensor(x), train=True)
    _assert_close(got, want, RTOL)
    new = baseline_from_flax({**variables, "batch_stats": jax.tree_util
                              .tree_map(np.asarray, stats["batch_stats"])})
    for k in ("hash_bn.running_mean", "hash_bn.running_var"):
        np.testing.assert_allclose(pm.state_dict()[k].numpy(),
                                   new[k].numpy(), rtol=RTOL, atol=1e-7,
                                   err_msg=k)


def test_checkpoint_layout():
    """orthohash's fixed centroids are a buffer (the reference's
    constants), clip's ``logit_scale`` a parameter at log(1/0.07) and its
    text centers outside the state dict, descriptor has no head."""
    orth = reference("orthohash_bcs")[4]
    assert "ce_fc.centroids" in dict(orth.named_buffers())
    assert "ce_fc.centroids" not in dict(orth.named_parameters())
    clip = tmethods.build_model(config("clip"), codebook("clip"),
                                device="cpu")[0]
    assert float(clip.logit_scale.detach()) == pytest.approx(np.log(1 / 0.07))
    assert not any(k.startswith("text_centers") for k in clip.state_dict())
    desc = reference("descriptor")[4]
    assert all(k.startswith("backbone.") for k in desc.state_dict())


def test_pairwise_init_is_torch_default():
    """The pairwise hash layer draws weight and bias from U(+-1/sqrt(64)),
    filling the interval (not flax's lecun normal), as the reference's."""
    cfg, _, jm, variables, _ = reference("hashnet")
    bound = 1 / np.sqrt(BACKBONE["hidden_size"])
    model = tmethods.build_model(cfg, None, device="cpu")[0]
    for t in (model.hash_fc.weight, model.hash_fc.bias):
        a = t.detach().abs()
        assert a.max() <= bound and a.max() > 0.9 * bound
    for leaf in variables["params"]["hash_fc"].values():
        assert np.abs(leaf).max() <= bound


# ---------------------------------------------------------------------------
# losses on seeded outputs
# ---------------------------------------------------------------------------

def _outputs(seed, multiclass=False, zero_row=False, one_class=False):
    rng = np.random.default_rng(seed)
    codes = (1.5 * rng.standard_normal((BATCH, NBIT))).astype(np.float32)
    logits = np.tanh(rng.standard_normal((BATCH, NCLASS))).astype(np.float32)
    logits2 = np.tanh(rng.standard_normal((BATCH, NCLASS))).astype(
        np.float32)
    if one_class:
        y = onehot(np.zeros(BATCH, int))
    elif multiclass:
        y = (rng.random((BATCH, NCLASS)) < 0.25).astype(np.float32)
        y[np.arange(BATCH), rng.integers(0, NCLASS, BATCH)] = 1.0
    else:
        y = onehot(rng.integers(0, NCLASS, BATCH))
    if zero_row:
        y[0] = 0.0
    out = {"codes": codes, "logits": logits, "logits2": logits2}
    return out, y


LOSSES = [
    ("orthohash", {}, {}),
    ("orthohash", {"m_type": "arc"}, {}),
    ("orthohash", {"quan": 0.1, "quan_type": "cs", "bcs_scale": 0.5}, {}),
    ("orthohash", {"quan": 0.1, "quan_type": "l1"}, {}),
    ("orthohash", {"quan": 0.1, "quan_type": "l2", "m_type": "arc"}, {}),
    ("orthohash", {"multiclass": True, "multiclass_loss": "bce"},
     {"multiclass": True}),
    ("orthohash", {"multiclass": True}, {"multiclass": True}),
    ("orthohash", {"multiclass": True,
                   "multiclass_loss": "label_smoothing_unscaled",
                   "m_type": "arc"}, {"multiclass": True}),
    ("csq", {"lambda_q": 0.001}, {}),
    ("csq", {"multiclass": True}, {"multiclass": True}),
    ("dpn", {}, {}),
    ("dpn", {"multiclass": True, "reg": 0.0}, {"multiclass": True}),
    ("hashnet", {"beta": 1.5, "alpha": 0.5}, {}),
    ("hashnet", {}, {"multiclass": True}),
    ("dpsh", {}, {}),
    ("dpsh", {"imbalance_scheme": "mean"}, {"multiclass": True}),
    ("dtsh", {}, {}),
    ("dtsh", {}, {"multiclass": True, "zero_row": True}),
    ("dtsh", {"alpha": 1.0}, {"one_class": True}),
    ("greedyhash", {"alpha": 0.1}, {}),
    ("greedyhash", {"multiclass": True}, {"multiclass": True}),
    ("ce", {}, {}),
    ("ce", {"multiclass": True}, {"multiclass": True}),
    ("ce", {"m_type": "cos", "margin": 0.2, "scale": 8}, {}),
    ("ce", {"m_type": "arc", "margin": 0.2, "scale": 8}, {}),
]


@pytest.mark.parametrize("name, kw, data", LOSSES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LOSSES)])
def test_loss_matches_jax(name, kw, data):
    out, y = _outputs(7, **data)
    kw = dict(kw)
    if name in SIGNED:
        kw["codebook"] = codebook(name)
    jfn, tfn = getattr(JL, f"{name}_loss"), getattr(TL, f"{name}_loss")
    jtotal, jparts = jfn({k: jnp.asarray(v) for k, v in out.items()},
                         jnp.asarray(y), **{k: (jnp.asarray(v)
                                                if k == "codebook" else v)
                                            for k, v in kw.items()})
    ttotal, tparts = tfn({k: torch.tensor(v) for k, v in out.items()},
                         torch.tensor(y), **{k: (torch.tensor(v)
                                                 if k == "codebook" else v)
                                             for k, v in kw.items()})
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=RTOL,
                               atol=1e-6)
    _assert_close(tparts, jparts, RTOL)
    if data.get("one_class"):       # no row has a negative
        assert float(tparts["likelihood"]) == 0.0


def test_margin_helpers_match_jax():
    out, y = _outputs(8, multiclass=True)
    lg = out["logits"]
    np.testing.assert_allclose(
        TC.arc_margin_logits(torch.tensor(lg), torch.tensor(y), 0.3,
                             8.0).numpy(),
        np.asarray(JC.arc_margin_logits(jnp.asarray(lg), jnp.asarray(y), 0.3,
                                        8.0)), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        float(TC.binary_cross_entropy_with_logits(torch.tensor(4 * lg),
                                                  torch.tensor(y))),
        float(JC.binary_cross_entropy_with_logits(jnp.asarray(4 * lg),
                                                  jnp.asarray(y))),
        rtol=RTOL)


# ---------------------------------------------------------------------------
# three train steps
# ---------------------------------------------------------------------------

def _torch_batch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


TRAINED = ["orthohash", "orthohash_bcs", "csq", "dpn", "dpsh", "dtsh",
           "greedyhash", "ce", "descriptor", "clip"]


@pytest.mark.parametrize("name", TRAINED)
def test_three_train_steps_match_jax(name):
    """Each step's loss, parts and accuracies, then every parameter and
    running statistic, at rtol 1e-4; the frozen backbone bit-unchanged;
    descriptor's loss zero (the adapters move by adam's weight decay, as
    in the reference)."""
    cfg, cb, jm, variables, model = (_orthohash() if name == "orthohash"
                                     else reference(name))
    jloss = jmethods.get_method(cfg["model"]["name"]).build_loss(cfg, cb)
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], SPE,
                          variables["params"], backbone_lr_scale=0.0)
    key = jax.random.PRNGKey(0)
    state = create_train_state(jm, tx, jnp.zeros((BATCH, IMAGE, IMAGE, 3)),
                               key, variables=variables)
    jstep = jmake_train_step(jm, jloss, tx, donate=False)
    tloss = tmethods.get_method(cfg["model"]["name"]).build_loss(cfg, cb)
    tr = tmethods.training_for(cfg, copy.deepcopy(model), tloss, SPE)
    before = copy.deepcopy(tr.model.state_dict())
    for i, b in enumerate(batches(3)):
        state, jm_ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tr.step(_torch_batch(b))
        assert set(tm) == set(jm_), (set(tm), set(jm_))
        for k in jm_:
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=TRAIN_RTOL, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
        if name == "descriptor":
            assert float(tm["loss"]) == 0.0
    want = baseline_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     state.variables()))
    got = tr.model.state_dict()
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=TRAIN_RTOL, atol=1e-6, err_msg=k)
    frozen = [n for n, p in tr.model.named_parameters()
              if not p.requires_grad]
    assert frozen and all(n.startswith("backbone.") and "adapter" not in n
                          for n in frozen)
    for n in frozen:
        assert torch.equal(got[n], before[n]), n
    moved = [n for n, p in tr.model.named_parameters()
             if p.requires_grad and not torch.equal(got[n], before[n])]
    assert moved


@functools.lru_cache(maxsize=None)
def _orthohash():
    """orthohash without bcs: the orthohash_bcs model's variables, which
    hold no more than orthohash's, in an orthohash model."""
    _, cb, _, variables, _ = reference("orthohash_bcs")
    cfg = config("orthohash")
    jm = jmethods.get_method("orthohash").build_model(cfg, cb)
    model, _ = tmethods.build_model(cfg, cb, device="cpu")
    model.load_state_dict(baseline_from_flax(variables), strict=True)
    return cfg, cb, jm, variables, model


@pytest.mark.parametrize("keep", [0, 1], ids=["in_batch", "bank"])
def test_hashnet_steps_match_jax(keep):
    """Three HashNet steps at one step an epoch and step_continuation 1
    (beta 1, sqrt 2, sqrt 3) against the reference's ``_hashnet_step``:
    metrics, parameters and, with ``keep_train_size``, the bank (each
    batch's rows written detached at its indices) at rtol 1e-4."""
    from concepthash_tpu.methods import _hashnet_extra, _hashnet_step

    n_rows = 2 * BATCH
    cfg, cb, jm, variables, model = reference("hashnet")
    cfg = copy.deepcopy(cfg)
    cfg["criterion"]["keep_train_size"] = keep
    cfg["_train_size_"] = n_rows
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], 1,
                          variables["params"], backbone_lr_scale=0.0)
    state = create_train_state(jm, tx, jnp.zeros((BATCH, IMAGE, IMAGE, 3)),
                               jax.random.PRNGKey(0), variables=variables)
    state = _hashnet_extra(state, cfg)
    jstep = _hashnet_step(jm, cfg, tx, None, cfg["epochs"])
    tloss = tmethods.get_method("hashnet").build_loss(cfg, cb)
    tr = tmethods.training_for(cfg, copy.deepcopy(model), tloss, 1)
    assert tr.custom and set(tr.extra) == ({"U", "Y"} if keep else set())
    betas = []
    for i, b in enumerate(batches(4, n_rows)):
        state, jm_ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tr.step(_torch_batch(b))
        assert set(tm) == set(jm_) == {"loss", "pairwise", "beta"}
        for k in jm_:
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=TRAIN_RTOL, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
        betas.append(float(tm["beta"]))
    assert betas == [1.0, float(np.sqrt(np.float32(2))),
                     float(np.sqrt(np.float32(3)))]
    want = baseline_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     state.variables()))
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   rtol=TRAIN_RTOL, atol=1e-6, err_msg=k)
    if keep:
        for k in ("U", "Y"):
            np.testing.assert_allclose(tr.extra[k].numpy(),
                                       np.asarray(state.extra[k]),
                                       rtol=TRAIN_RTOL, atol=1e-6, err_msg=k)
        seen = np.unique(np.concatenate([b["index"]
                                         for b in batches(4, n_rows)]))
        assert tr.extra["U"][seen].abs().sum(1).min() > 0


# ---------------------------------------------------------------------------
# every baseline config through main_gpu.py
# ---------------------------------------------------------------------------

CONFIGS = ["orthohash_adapter", "orthohash_adapter_lg_pca",
           "orthohash_bcs_adapter", "csq_adapter", "dpn_adapter",
           "hashnet_adapter", "dpsh_adapter", "dtsh_adapter", "sgh_adapter",
           "ce_adapter", "clip_finetune"]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset

    wd = tmp_path_factory.mktemp("baselines")
    make_synthetic_dataset(str(wd / "data" / "synthetic"), nclass=3,
                           per_class_train=4, per_class_test=2,
                           image_size=48)
    return str(wd)


@pytest.mark.parametrize("model", CONFIGS)
def test_config_trains_and_rescores(synthetic, model):
    """``main_gpu.py --device cpu model=<config>`` on the tiny backbone
    trains an epoch, evaluates and checkpoints; ``exp=validation
    use_last=true`` re-scores its last model to its last mAP (within
    1e-6). lg_pca's PCA codebook takes 2 bits: 3 classes give 3 samples."""
    import json
    import os
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import main_gpu

    logdir = os.path.join(synthetic, model)
    nbit = 2 if model.endswith("lg_pca") else 16
    best = main_gpu.main([
        "--device", "cpu", "dataset=synthetic", f"model={model}",
        "backbone=tiny_test", f"model.nbit={nbit}", "batch_size=4",
        "epochs=1", "dataset.resize=48", "dataset.crop=32",
        f"data_dir={synthetic}", f"logdir={logdir}", "seed=3"])
    with open(os.path.join(logdir, "train_history.json")) as f:
        train = json.load(f)
    with open(os.path.join(logdir, "test_history.json")) as f:
        test = json.load(f)
    assert len(train) == len(test) == 1 and np.isfinite(train[0]["loss"])
    assert best == test[0]["mAP"]
    assert os.path.exists(os.path.join(logdir, "models", "last.pt"))
    res = main_gpu.main(["--device", "cpu", "exp=validation",
                         f"logdir={logdir}", f"data_dir={synthetic}",
                         "use_last=true",
                         f"eval_logdir={os.path.join(logdir, 'val')}"])
    assert abs(res["mAP"] - test[0]["mAP"]) <= 1e-6


def test_hashnet_bank_resumes(synthetic):
    """HashNet's ``keep_train_size`` bank is saved with the train state
    (``optims/last.pt``) and restored on resume: a run stopped after epoch
    1 and resumed reaches the uninterrupted run's train records, parameters
    and bank exactly."""
    import json
    import os
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import main_gpu

    def argv(name, *extra):
        return ["--device", "cpu", "dataset=synthetic",
                "model=hashnet_adapter", "backbone=tiny_test",
                "model.nbit=16", "batch_size=4", "epochs=2",
                "eval_interval=1", "dataset.resize=48", "dataset.crop=32",
                "+criterion.keep_train_size=1", "save_training_state=true",
                f"data_dir={synthetic}",
                f"logdir={os.path.join(synthetic, name)}", "seed=4", *extra]

    whole = main_gpu.build_experiment(argv("bank_whole"))
    whole.main()
    first = main_gpu.build_experiment(argv("bank_first"))
    first.epochs = 1
    first.main()
    resumed = main_gpu.build_experiment(argv(
        "bank_resumed",
        f"resume_logdir={os.path.join(synthetic, 'bank_first')}"))
    assert torch.equal(resumed.state.extra["U"], first.state.extra["U"])
    resumed.main()
    hist = []
    for name in ("bank_whole", "bank_resumed"):
        with open(os.path.join(synthetic, name, "train_history.json")) as f:
            hist.append([{k: v for k, v in r.items() if k != "time"}
                         for r in json.load(f)])
    assert hist[0] == hist[1] and len(hist[0]) == 2
    for k in ("U", "Y"):
        assert torch.equal(whole.state.extra[k], resumed.state.extra[k]), k
    assert whole.state.extra["U"].abs().min() > 0
    sw, sr = whole.model.state_dict(), resumed.model.state_dict()
    for k in sw:
        assert torch.equal(sw[k], sr[k]), k
