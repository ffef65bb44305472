"""The pretraining methods (moco, dino, mae, autoencoder), TBH and ODC of the
PyTorch port against the JAX package, on the CPU at a tiny size: the
CLIP-adapter trunk at hidden 32, 2 layers, 4 heads, 16^2 images in patches
of 8 (the JAX package's tests/test_pretrain.py geometry), adapters of 16,
projections and codes of 16; the MAE at 32^2 in patches of 8 (16 patches),
encoder 32 x 2 layers x 4 heads, decoder 16 x 1 layer x 4 heads; float32.
JAX variables are carried across by ``weights``' bridges.

Held:

- the forwards of ProjectorNet (with and without the predictor), TBHNet,
  its Discriminator and the MAE (eval, and train with the mask's noise
  given to both: the reference's draw is patched to return it) at rtol
  1e-4 / atol 1e-5, TBH's bits exactly; ``mae_loss`` and the autoencoder's
  loss;
- three train steps of moco, dino and tbh, both views fixed (the port's
  batch is ``[v1; v2]``, the reference's two preprocessing calls return
  v1 then v2) and TBH's uniform prior fixed, against
  ``make_moco_step`` / ``make_dino_step`` / ``make_tbh_step``: losses,
  metrics, the teacher, DINO's center, the discriminator and every
  parameter within 1e-4 (sgd, as the JAX package's own tests step them);
- three ODC steps against the reference's ``_odc_step`` from the same
  injected memory: labels exactly; memory, centroids and weights within
  1e-6; the refresh on steps 0 and 2 of interval 2 and not on step 1;
- the port's k-means against sklearn: the same partition of seeded
  well-separated blobs up to relabelling, and on seeded random unit rows
  an inertia at most 2% above sklearn's;
- the registry: all 31 methods, every config of configs/model/ among
  them; moco and dino take two views.
"""

import copy
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu import methods as jmethods
from concepthash_tpu.models.mae import MAE as JMAE
from concepthash_tpu.models.mae import MAEConfig as JMAEConfig
from concepthash_tpu.models.mae import mae_loss as jmae_loss
from concepthash_tpu.models.tbh import Discriminator as JDiscriminator
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.models.mae import MAE, MAEConfig, mae_loss
from concepthash_tpu_torch.models.tbh import Discriminator
from concepthash_tpu_torch.train import pretrain_steps as P
from concepthash_tpu_torch.train.kmeans import kmeans
from concepthash_tpu_torch.weights import (baseline_from_flax,
                                           discriminator_from_flax,
                                           mae_from_flax, pretrain_from_flax,
                                           tbh_from_flax)

ROOT = Path(__file__).resolve().parent.parent
NBIT, BATCH, IMAGE, SPE, EPOCHS = 16, 6, 16, 2, 2
RTOL, ATOL = 1e-4, 1e-5
STEP_TOL = 1e-4

BACKBONE = {"name": "tiny", "pretrained": False, "hidden_size": 32,
            "intermediate_size": 64, "num_layers": 2, "num_heads": 4,
            "patch_size": 8, "image_size": IMAGE, "projection_dim": 32}
# the criterion keys of configs/model/*.yaml (tbh's disc_lr raised so that
# three critic steps move the discriminator visibly)
CRITERIA = {
    "moco": {"momentum": 0.99, "temperature": 0.2},
    "dino": {"momentum": 0.996, "tau_s": 0.1, "tau_t": 0.04},
    "tbh": {"adv_weight": 1.0, "disc_lr": 0.01},
    "odc": {"update_interval": 2, "memory_momentum": 0.5},
}
BRIDGES = {"moco": pretrain_from_flax, "dino": pretrain_from_flax,
           "tbh": tbh_from_flax, "odc": baseline_from_flax}


def config(name: str) -> dict:
    return {
        "model": {"name": name, "nbit": NBIT, "nclass": 4, "zdim": NBIT,
                  "hidden_dim": 16, "has_adapter": True,
                  "adapter_bottleneck_dim": 16},
        "backbone": dict(BACKBONE),
        "criterion": dict(CRITERIA[name]),
        "optim": {"name": "sgd", "lr": 0.05, "momentum": 0.9},
        "scheduler": {"name": "no_decay"},
        "epochs": EPOCHS, "backbone_lr_scale": 0, "batch_size": BATCH,
        "compute_dtype": "float32", "seed": 0,
        "dataset": {"nclass": 4, "multiclass": False},
    }


def _seed_tree(tree, rng):
    """Seeded adapter up-projections (flax zero-inits them)."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if k.startswith("adapter") and "up" in v:
            v["up"]["kernel"] = (0.1 * rng.standard_normal(
                v["up"]["kernel"].shape)).astype(np.float32)
        else:
            _seed_tree(v, rng)


@functools.lru_cache(maxsize=None)
def reference(name: str):
    """(config, JAX model, its seeded variables as numpy, the port's model
    carrying them)."""
    cfg = config(name)
    jm = jmethods.get_method(name).build_model(cfg, None)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        jnp.zeros((BATCH, IMAGE, IMAGE, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)
    _seed_tree(variables["params"], np.random.default_rng(2))
    model, _ = tmethods.build_model(cfg, None, device="cpu")
    model.load_state_dict(BRIDGES[name](variables), strict=True)
    return cfg, jm, variables, model


def images(seed, n=BATCH, side=IMAGE):
    return np.random.default_rng(seed).standard_normal(
        (n, side, side, 3)).astype(np.float32)


def _close(got, want, tol=(RTOL, ATOL), msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol[0], atol=tol[1], err_msg=msg)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["moco", "dino", "tbh"])
def test_forward_matches_jax(name):
    """ProjectorNet with the predictor (moco) and without (dino), and
    TBHNet: every output; TBH's codes (its bits) exactly."""
    _, jm, variables, model = reference(name)
    x = images(11)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = copy.deepcopy(model)(torch.tensor(x))
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        _close(got[k].numpy(), want[k], msg=k)
    if name == "tbh":
        np.testing.assert_array_equal(got["codes"].numpy(),
                                      np.asarray(want["codes"]))
        assert set(np.unique(got["codes"].numpy())) == {-1.0, 1.0}
    assert ("pred" in got) == (name == "moco")


def test_discriminator_matches_jax():
    disc = JDiscriminator()
    params = jax.tree_util.tree_map(np.array, disc.init(
        jax.random.PRNGKey(3), jnp.zeros((1, NBIT)))["params"])
    port = Discriminator(NBIT, device="cpu")
    port.load_state_dict(discriminator_from_flax(params), strict=True)
    z = np.random.default_rng(4).uniform(size=(9, NBIT)).astype(np.float32)
    want = disc.apply({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        got = port(torch.tensor(z))
    assert got.shape == (9,)
    _close(got.numpy(), want)


MAE_GEOMETRY = dict(image_size=32, patch_size=8, enc_dim=32, enc_layers=2,
                    enc_heads=4, dec_dim=16, dec_layers=1, dec_heads=4)


@functools.lru_cache(maxsize=None)
def mae_pair(mask_ratio: float):
    jcfg = JMAEConfig(mask_ratio=mask_ratio, **MAE_GEOMETRY)
    jm = JMAE(jcfg)
    key = jax.random.PRNGKey(5)
    variables = jax.tree_util.tree_map(np.array, jm.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        jnp.zeros((2, 32, 32, 3)), train=True))
    port = MAE(MAEConfig(mask_ratio=mask_ratio, **MAE_GEOMETRY),
               device="cpu")
    port.load_state_dict(mae_from_flax(variables), strict=True)
    return jm, variables, port


@pytest.mark.parametrize("mask_ratio", [0.75, 0.0])
def test_mae_matches_jax(mask_ratio, monkeypatch):
    """The eval forward, and the train forward with the mask's noise given
    to both (the reference's uniform draw patched to return it): features,
    recon, target, mask; ``mae_loss`` at 0.75 and the autoencoder's loss
    at 0; an eval forward's loss is 0 for both."""
    jm, variables, port = mae_pair(mask_ratio)
    B, P = 3, 16
    x = images(12, B, 32)
    noise = np.random.default_rng(13).uniform(size=(B, P)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.tensor(x))
    assert set(got) == set(want) == {"features", "codes"}
    _close(got["features"].numpy(), want["features"], msg="eval features")
    assert float(mae_loss(got)[0]) == float(jmae_loss(want, None)[0]) == 0.0

    real_uniform = jax.random.uniform

    def given(key, shape=(), *a, **kw):
        if tuple(shape) == (B, P):
            return jnp.asarray(noise)
        return real_uniform(key, shape, *a, **kw)

    monkeypatch.setattr(jax.random, "uniform", given)
    want = jm.apply(variables, jnp.asarray(x), train=True,
                    rngs={"dropout": jax.random.PRNGKey(0)})
    monkeypatch.setattr(jax.random, "uniform", real_uniform)
    with torch.no_grad():
        got = port(torch.tensor(x), train=True,
                   noise=torch.tensor(noise))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    n_keep = max(1, int(P * (1 - mask_ratio)))
    assert (got["mask"].sum(1) == P - n_keep).all()
    for k in ("features", "recon", "target"):
        _close(got[k].numpy(), want[k], msg=k)
    name = "mae" if mask_ratio else "autoencoder"
    jloss = jmethods.get_method(name).build_loss({"model": {}}, None)
    tloss = tmethods.get_method(name).build_loss({"model": {}}, None)
    jl, jparts = jloss(want, {"label": None})
    tl, tparts = tloss(got, {"label": None})
    assert set(tparts) == set(jparts) == {"recon_mse"}
    _close(float(tl), float(jl), msg="loss")


def test_mae_config_from_the_config_groups():
    """``methods`` builds the MAE's geometry as the reference does: the
    encoder from the backbone group, the decoder and the mask ratio from
    the model's keys; ViT-B/16 at the crop without a backbone group."""
    from dataclasses import asdict

    for backbone in (dict(BACKBONE), None):
        cfg = {"model": {"name": "mae", "nbit": 64, "nclass": 4,
                         "mask_ratio": 0.75, "dec_dim": 16,
                         "dec_layers": 1, "dec_heads": 4},
               "backbone": backbone, "dataset": {"crop": 32},
               "compute_dtype": "float32"}
        want = jmethods.get_method("mae").build_model(cfg, None).cfg
        got = tmethods.build_model(cfg, None, device="cpu")[0].cfg
        assert asdict(got) == asdict(want)
        assert got.enc_dim == (768 if backbone is None else 32)
        assert got.image_size == (32 if backbone is None else IMAGE)
        assert got.dec_dim == 16


# ---------------------------------------------------------------------------
# three train steps
# ---------------------------------------------------------------------------

def _two_view_pp():
    """The reference's preprocessing given [v1; v2]: its first call in the
    step returns v1, its second v2 (each trace calls it twice, in order)."""
    calls = []

    def pp(imgs, key):
        half = imgs.shape[0] // 2
        i = len(calls) % 2
        calls.append(i)
        return imgs[i * half:(i + 1) * half]

    return pp


def _jax_training(name, variables, jm, pp):
    cfg = config(name)
    method = jmethods.get_method(name)
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], SPE,
                          variables["params"], backbone_lr_scale=0.0)
    state = create_train_state(jm, tx, jnp.zeros((BATCH, IMAGE, IMAGE, 3)),
                               jax.random.PRNGKey(0), variables=variables)
    if method.init_extra is not None:
        state = method.init_extra(state, cfg)
    return state, method.custom_step(jm, cfg, tx, pp, EPOCHS * SPE)


@pytest.mark.parametrize("name", ["moco", "dino", "tbh"])
def test_three_steps_match_jax(name, monkeypatch):
    cfg, jm, variables, model = reference(name)
    prior = np.random.default_rng(21).uniform(
        size=(BATCH, NBIT)).astype(np.float32)
    if name == "tbh":       # the critic's prior, the same on both sides
        real_uniform = jax.random.uniform
        monkeypatch.setattr(
            jax.random, "uniform",
            lambda key, shape=(), *a, **kw: jnp.asarray(prior)
            if tuple(shape) == prior.shape else real_uniform(key, shape, *a,
                                                             **kw))
        monkeypatch.setattr(P, "uniform_prior",
                            lambda z, generator: torch.tensor(prior))
    two = tmethods.get_method(name).two_view
    assert two == (name != "tbh")
    state, jstep = _jax_training(name, variables, jm,
                                 _two_view_pp() if two
                                 else (lambda imgs, key: imgs))
    tr = tmethods.training_for(cfg, copy.deepcopy(model),
                               tmethods.get_method(name).build_loss(cfg,
                                                                    None),
                               SPE)
    if name == "tbh":
        tr.extra["disc"].load_state_dict(discriminator_from_flax(
            jax.tree_util.tree_map(np.array, state.extra["disc"])))
    before = copy.deepcopy(tr.model.state_dict())
    teacher0 = (copy.deepcopy(tr.extra["teacher"].state_dict())
                if "teacher" in tr.extra else None)
    disc0 = (copy.deepcopy(tr.extra["disc"].state_dict())
             if "disc" in tr.extra else None)
    rng = np.random.default_rng(3)
    for i in range(3):
        x = images(int(rng.integers(1 << 30)), 2 * BATCH if two else BATCH)
        state, jm_ = jstep(state, {"image": jnp.asarray(x)})
        tm = tr.step({"image": torch.tensor(x)})
        assert set(tm) == set(jm_), (set(tm), set(jm_))
        for k in jm_:
            _close(float(tm[k]), float(jm_[k]), (STEP_TOL, 1e-6),
                   f"step {i}: {k}")
    assert int(tr.scheduler.last_epoch) == int(state.step) == 3
    jstate = jax.tree_util.tree_map(np.array, jax.device_get(state))
    want = BRIDGES[name]({"params": jstate.params})
    got = tr.model.state_dict()
    assert set(got) == set(want)
    for k in got:
        _close(got[k].numpy(), want[k].numpy(), (STEP_TOL, 1e-6), k)
    frozen = [n for n, p in tr.model.named_parameters()
              if not p.requires_grad]
    assert frozen and all(torch.equal(got[n], before[n]) for n in frozen)
    if teacher0 is not None:
        want_t = pretrain_from_flax({"params": jstate.extra["teacher"]})
        got_t = tr.extra["teacher"].state_dict()
        for k in got_t:
            _close(got_t[k].numpy(), want_t[k].numpy(), (STEP_TOL, 1e-6),
                   "teacher " + k)
        assert max((got_t[k] - teacher0[k]).abs().max() for k in got_t) \
            > 1e-5      # the EMA moved the teacher
    if name == "dino":
        _close(tr.extra["center"].numpy(), jstate.extra["center"],
               (STEP_TOL, 1e-6), "center")
        assert tr.extra["center"].abs().max() > 0
    if name == "tbh":
        want_d = discriminator_from_flax(jstate.extra["disc"])
        got_d = tr.extra["disc"].state_dict()
        for k in got_d:
            _close(got_d[k].numpy(), want_d[k].numpy(), (STEP_TOL, 1e-6),
                   "disc " + k)
            assert not torch.equal(got_d[k], disc0[k])


def test_moco_momentum_follows_the_cosine_schedule():
    """The teacher's momentum in float32: base at step 0, up to 1 at the
    end, the reference's _cosine_momentum at each step within an ulp."""
    from concepthash_tpu.train.pretrain_steps import _cosine_momentum

    total = 40
    for step in range(0, total + 3):
        want = float(_cosine_momentum(jnp.float32(step), total, 0.99))
        got = P.cosine_momentum(step, total, 0.99)
        assert got == pytest.approx(want, rel=1.2e-7, abs=0)
    assert P.cosine_momentum(0, total, 0.99) == pytest.approx(0.99, rel=1e-7)
    assert P.cosine_momentum(total, total, 0.99) == 1.0


# ---------------------------------------------------------------------------
# ODC
# ---------------------------------------------------------------------------

def test_odc_steps_match_jax():
    """From the same injected memory (16 rows, 4 clusters, unit weights)
    and weights: three steps over the rows 0-5, 6-11, 2-7."""
    cfg, jm, variables, model = reference("odc")
    n, k = 16, 4
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((n, NBIT)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    labels = rng.integers(0, k, n).astype(np.int32)
    cents = np.stack([feats[labels == c].mean(0) for c in range(k)])
    weights = np.ones(k, np.float32)
    state, jstep = _jax_training("odc", variables, jm, None)
    state = state.replace(extra={
        "features": jnp.asarray(feats), "labels": jnp.asarray(labels),
        "centroids": jnp.asarray(cents), "weights": jnp.asarray(weights)})
    tr = tmethods.training_for(dict(cfg, _train_size_=n),
                               copy.deepcopy(model),
                               tmethods.get_method("odc").build_loss(cfg,
                                                                     None),
                               SPE)
    for key, v in (("features", feats), ("labels", labels),
                   ("centroids", cents), ("weights", weights)):
        tr.extra[key].copy_(torch.from_numpy(v))
    x_rng = np.random.default_rng(8)
    for i, rows in enumerate((range(0, 6), range(6, 12), range(2, 8))):
        idx = np.asarray(rows, np.int32)
        x = images(int(x_rng.integers(1 << 30)))
        cents_before = tr.extra["centroids"].clone()
        mem_before = tr.extra["features"].clone()
        state, jm_ = jstep(state, {"image": jnp.asarray(x),
                                   "label": jnp.zeros((BATCH, k)),
                                   "index": jnp.asarray(idx)})
        tm = tr.step({"image": torch.tensor(x),
                      "label": torch.zeros(BATCH, k),
                      "index": torch.from_numpy(idx)})
        assert set(tm) == set(jm_)
        for key in jm_:
            _close(float(tm[key]), float(jm_[key]), (1e-5, 1e-6),
                   f"step {i}: {key}")
        ex = jax.tree_util.tree_map(np.asarray, state.extra)
        np.testing.assert_array_equal(tr.extra["labels"].numpy(),
                                      ex["labels"])
        for key in ("features", "centroids", "weights"):
            _close(tr.extra[key].numpy(), ex[key], (0, 1e-6),
                   f"step {i}: {key}")
        untouched = np.setdiff1d(np.arange(n), idx)
        assert torch.equal(tr.extra["features"][untouched],
                           mem_before[untouched])
        refreshed = not torch.equal(tr.extra["centroids"], cents_before)
        assert refreshed == (i % 2 == 0), i
        if refreshed:
            assert float(tr.extra["weights"].sum()) == pytest.approx(1.0,
                                                                     abs=1e-6)


def test_odc_initial_weights_match_the_reference():
    """N_c^-0.5 over the non-empty clusters, mean 1 over them (the
    reference's _odc_setup), an empty cluster at 0."""
    from concepthash_tpu_torch.train.custom_steps import odc_init_weights

    counts = np.array([4, 0, 9, 1, 25], np.float32)
    rw = np.where(counts > 0, 1.0 / np.sqrt(np.maximum(counts, 1.0)), 0.0)
    want = (rw / max(rw.sum() / max((counts > 0).sum(), 1), 1e-12)) \
        .astype(np.float32)
    got = odc_init_weights(torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[1] == 0.0


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def test_kmeans_recovers_sklearns_partition_of_blobs():
    from sklearn.cluster import KMeans

    rng = np.random.default_rng(31)
    k, per, dim = 6, 40, 8
    centers = 5.0 * rng.standard_normal((k, dim))
    x = (centers[:, None] + 0.1 * rng.standard_normal((k, per, dim))) \
        .reshape(k * per, dim).astype(np.float32)
    x = x[rng.permutation(len(x))]
    want = KMeans(n_clusters=k, n_init=3, random_state=0).fit(x).labels_
    labels, cents, inertia = kmeans(torch.from_numpy(x), k, seed=0)
    got = labels.numpy()
    pairs = set(zip(got.tolist(), want.tolist()))
    assert len(pairs) == k == len(set(got.tolist()))
    assert cents.shape == (k, dim) and cents.dtype == torch.float32
    # the centroids are the clusters' means
    for c in range(k):
        np.testing.assert_allclose(cents[c].numpy(), x[got == c].mean(0),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_inertia_near_sklearns_on_random_rows(seed):
    from sklearn.cluster import KMeans

    rng = np.random.default_rng(40 + seed)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    want = KMeans(n_clusters=12, n_init=3, random_state=seed).fit(x)
    labels, cents, inertia = kmeans(torch.from_numpy(x), 12, seed=seed)
    d = ((x[:, None] - cents.numpy()[None]) ** 2).sum(-1)
    assert (labels.numpy() == d.argmin(1)).all()
    assert inertia == pytest.approx(d.min(1).sum(), rel=1e-5)
    assert inertia <= 1.02 * want.inertia_, (inertia, want.inertia_)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_every_config_is_registered():
    names = tmethods.list_methods()
    assert len(names) == len(set(names)) == 31 and names[0] == "concepthash"
    assert set(names) == set(jmethods.list_methods())
    import yaml

    for f in sorted(os.listdir(ROOT / "configs" / "model")):
        with open(ROOT / "configs" / "model" / f) as fh:
            assert tmethods.get_method(yaml.safe_load(fh)["model"]["name"])
    with pytest.raises(KeyError):
        tmethods.get_method("no_such_method")
    for name in ("moco", "dino"):
        m = tmethods.get_method(name)
        assert m.two_view and m.custom_step is not None
    assert tmethods.get_method("odc").regime == "odc"
