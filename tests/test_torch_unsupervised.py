"""The unsupervised methods and the shallow regime of the PyTorch port
against the JAX package, on the CPU at a tiny size: the CLIP-adapter trunk
at hidden 64, 2 layers, 4 heads, 32^2 images in patches of 8, adapters of
16; 16 bits; float32. Each JAX model is built once per head and its seeded
variables are carried across by ``weights.baseline_from_flax``.

Held:

- the five losses (cibhash, bihalf, ssdh with and without a structure,
  nsh, unsup_greedyhash) and their gradients on seeded outputs at rtol
  1e-5, at an even and an odd row count; ``bihalf_binarize`` at an even
  and an odd batch (the even median is the mean of the middle two);
- ``ssdh_structure`` exactly;
- each shallow fitter (``fit_pca`` at every ``whiten``) and
  ``encode_shallow``: lsh exactly, the others at rtol 1e-5, signs equal;
- the ``nsh`` and ``unsup_greedyhash`` heads' eval forward at rtol 1e-5;
- three train steps of cibhash and bihalf (2B-row two-view batches), nsh
  and ssdh (with ``aux``) against the reference's ``make_train_step`` at
  rtol 1e-4, the train slice's tolerance;
- the experiment's parts on a 3-class synthetic set: the two-view
  preprocessing is ``[v1; v2]`` from two successive draws, and a chunked
  run equals one step a dispatch; SSDH's structure comes from the train
  split's codes in dataset order and each shuffled batch carries
  ``S[idx, idx]``; the shallow fit takes train-augmented features; and
  ``_main_shallow``'s fit and mAP equal the reference's on the same
  features.
"""

import copy
import functools
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
from concepthash_tpu.losses import baselines as JL
from concepthash_tpu.losses import shallow as JS
from concepthash_tpu.losses import unsupervised as JU
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu.utils.io import load_checkpoint as jload_checkpoint
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.data.preprocess import preprocess_batch
from concepthash_tpu_torch.losses import baselines as TL
from concepthash_tpu_torch.losses import shallow as TS
from concepthash_tpu_torch.losses import unsupervised as TU
from concepthash_tpu_torch.weights import baseline_from_flax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import main_gpu  # noqa: E402

NBIT, BATCH, IMAGE, STEPS, SPE, LATENT = 16, 6, 32, 3, 2, 8
RTOL = 1e-5
TRAIN_RTOL = 1e-4

BACKBONE = {"name": "tiny", "hidden_size": 64, "intermediate_size": 128,
            "num_layers": 2, "num_heads": 4, "patch_size": 8,
            "image_size": IMAGE, "projection_dim": 32}
# the criterion keys of configs/model/*.yaml
CRITERIA = {
    "cibhash": {"temperature": 0.3, "beta": 0.001},
    "bihalf": {"alpha": 0.01, "gamma": 6},
    "nsh": {"tau": 1.0, "temperature": 0.3, "lambda_q": 0.1,
            "lambda_c": 1.0},
    "ssdh": {"alpha": 2.0},
    "unsup_greedyhash": {"alpha": 1.0, "pow": 3},
}


def config(name: str) -> dict:
    return {
        "model": {"name": name, "nbit": NBIT, "nclass": 10,
                  "has_adapter": True, "adapter_bottleneck_dim": 16,
                  "latent_dim": LATENT},
        "backbone": dict(BACKBONE),
        "criterion": dict(CRITERIA[name]),
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 10},
        "epochs": 100, "backbone_lr_scale": 0, "batch_size": BATCH,
        "compute_dtype": "float32", "seed": 0,
        "dataset": {"nclass": 10, "multiclass": False},
    }


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the losses on seeded outputs
# ---------------------------------------------------------------------------

def _outputs(seed, rows):
    rng = np.random.default_rng(seed)
    codes = (1.5 * rng.standard_normal((rows, NBIT))).astype(np.float32)
    return {"codes": codes,
            "features": rng.standard_normal((rows, 64)).astype(np.float32),
            "latents": rng.standard_normal((rows, LATENT)).astype(np.float32),
            "codes_bin": np.sign(codes)}


def _structure_block(seed, rows):
    rng = np.random.default_rng(seed)
    S = rng.integers(-1, 2, (rows, rows)).astype(np.int8)
    np.fill_diagonal(S, 1)
    return S


def _losses(rows):
    """(name, jax fn, port fn, kwargs, keys differentiated)."""
    S = _structure_block(9, rows)
    return [
        ("cibhash", JU.cibhash_loss, TU.cibhash_loss, CRITERIA["cibhash"],
         ("codes",)),
        ("bihalf", JU.bihalf_loss, TU.bihalf_loss, CRITERIA["bihalf"],
         ("codes", "features")),
        ("nsh", JU.nsh_loss, TU.nsh_loss, CRITERIA["nsh"],
         ("codes", "latents")),
        ("ssdh", JU.ssdh_loss, TU.ssdh_loss, {"S_batch": S}, ("codes",)),
        ("ssdh_eval", JU.ssdh_loss, TU.ssdh_loss, {}, ()),
        ("unsup_greedyhash", JL.unsup_greedyhash_loss,
         TL.unsup_greedyhash_loss, CRITERIA["unsup_greedyhash"],
         ("codes", "features")),
    ]


@pytest.mark.parametrize("rows", [12, 13], ids=["even", "odd"])
@pytest.mark.parametrize("i", range(6), ids=[
    "cibhash", "bihalf", "nsh", "ssdh", "ssdh_eval", "unsup_greedyhash"])
def test_loss_matches_jax(i, rows):
    """Total and parts at rtol 1e-5, and the gradient of the total into
    the outputs it reads (the straight-through paths included). NSH's
    reference raises at an odd row count (its eval batches are padded to
    the full size); the port leaves the odd row out, so it is held
    against the reference on the first 12 rows there."""
    name, jfn, tfn, kw, wrt = _losses(rows)[i]
    out = _outputs(7, rows)
    y = np.eye(10, dtype=np.float32)[np.arange(rows) % 10]
    jout = out
    if name == "nsh" and rows % 2:
        jout = {k: v[:rows - 1] for k, v in out.items()}
    jkw = {k: (jnp.asarray(v) if k == "S_batch" else v)
           for k, v in kw.items()}

    def jtotal(sub):
        total, _ = jfn({**_j(jout), **sub}, jnp.asarray(y), **jkw)
        return total

    jt, jparts = jfn(_j(jout), jnp.asarray(y), **jkw)
    tin = {k: torch.tensor(v, requires_grad=k in wrt) for k, v in out.items()}
    tt, tparts = tfn(tin, torch.tensor(y), **kw)
    np.testing.assert_allclose(float(tt), float(jt), rtol=RTOL, atol=1e-6)
    assert set(tparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    if not wrt:
        assert float(tt) == 0.0 and not tparts
        return
    jg = jax.grad(jtotal)({k: jnp.asarray(jout[k]) for k in wrt})
    # the features reach the structure losses detached: no gradient
    tg = torch.autograd.grad(tt, [tin[k] for k in wrt], allow_unused=True)
    for k, g in zip(wrt, tg):
        g = torch.zeros_like(tin[k]) if g is None else g
        want = np.asarray(jg[k])
        got = g.numpy()[:want.shape[0]]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7,
                                   err_msg=f"d total / d {k}")
        assert not g[want.shape[0]:].any()


@pytest.mark.parametrize("rows", [8, 9], ids=["even", "odd"])
def test_bihalf_binarize_matches_jax(rows):
    """At an even batch the threshold is the mean of the two middle values
    (``jnp.median``), so exactly half the rows are +1 on each bit with no
    ties; the proxy gradient is gamma."""
    h = np.random.default_rng(3).standard_normal((rows, NBIT)) \
        .astype(np.float32)
    want = np.asarray(JU.bihalf_binarize(jnp.asarray(h), 6.0))
    ht = torch.tensor(h, requires_grad=True)
    got = TU.bihalf_binarize(ht, 6.0)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    if rows % 2 == 0:
        assert ((got > 0).sum(0) == rows // 2).all()
    got.sum().backward()
    assert torch.equal(ht.grad, torch.full_like(ht, 6.0))


def test_ssdh_structure_matches_jax_exactly():
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((4, NBIT))
    codes = (centers[rng.integers(0, 4, 60)]
             + 0.8 * rng.standard_normal((60, NBIT))).astype(np.float32)
    want = JU.ssdh_structure(codes, alpha=1.0)
    got = TU.ssdh_structure(codes, alpha=1.0)
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert (np.diag(got) == 1).all() and (got > 0).any() and (got < 0).any()
    assert np.array_equal(TU.ssdh_structure(codes), JU.ssdh_structure(codes))


FITS = [("itq", {}), ("pca", {}), ("pca", {"whiten": True}),
        ("pca", {"whiten": "pca"}), ("pca", {"whiten": "zca"}),
        ("pca", {"whiten": "cholesky"}), ("lsh", {}), ("sh", {})]


@pytest.mark.parametrize("name, kw", FITS, ids=[
    f"{n}-{kw.get('whiten', '')}" for n, kw in FITS])
def test_shallow_fit_matches_jax(name, kw):
    """The fit's state and the codes of new features: lsh exactly, the
    others within rtol 1e-5, their signs equal. zca rotates back into the
    input's orientation, so it fits as many bits as features."""
    rng = np.random.default_rng(6)
    D = 12
    nbit = D if kw.get("whiten") == "zca" else 8
    train = (rng.standard_normal((80, D)) * np.linspace(3, 0.5, D)) \
        .astype(np.float32)
    new = rng.standard_normal((20, D)).astype(np.float32)
    want_state = JS.FITTERS[name](train, nbit, **kw)
    got_state = TS.FITTERS[name](train, nbit, **kw)
    assert set(got_state) == set(want_state)
    assert got_state["kind"] == want_state["kind"]
    for k, v in want_state.items():
        if k != "kind":
            np.testing.assert_allclose(got_state[k], v, rtol=RTOL, atol=1e-7,
                                       err_msg=k)
    want = JS.encode_shallow(want_state, new)
    got = TS.encode_shallow(got_state, new)
    assert got.dtype == np.float32 and got.shape == (20, nbit)
    if name == "lsh":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))


# ---------------------------------------------------------------------------
# the heads and three train steps
# ---------------------------------------------------------------------------

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
    jm = jmethods.get_method(name).build_model(cfg, None)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        jnp.zeros((BATCH, IMAGE, IMAGE, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)
    _seed_adapters(variables["params"]["backbone"], np.random.default_rng(2))
    model, _ = tmethods.build_model(cfg, None, device="cpu")
    model.load_state_dict(baseline_from_flax(variables), strict=True)
    return cfg, jm, variables, model


def images(seed, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n, IMAGE, IMAGE, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["nsh", "unsup_greedyhash"])
def test_head_forward_matches_jax(name):
    _, jm, variables, model = reference(name)
    x = images(11)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = copy.deepcopy(model)(torch.tensor(x))
    assert set(got) == set(want) == (
        {"features", "latents", "codes"} if name == "nsh"
        else {"features", "codes", "codes_bin"})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    if name == "nsh":
        assert model.hash_fc.bias is None
        assert tuple(model.latent_fc1.weight.shape) == (2 * LATENT, 64)


def _batches(name, seed):
    """Three train batches: 2B rows of images for a two-view method (B
    labels), SSDH's with a seeded structure block."""
    rng = np.random.default_rng(seed)
    two = tmethods.get_method(name).two_view
    out = []
    for _ in range(STEPS):
        b = {"image": images(int(rng.integers(1 << 30)),
                             2 * BATCH if two else BATCH),
             "label": np.eye(10, dtype=np.float32)[
                 rng.integers(0, 10, BATCH)]}
        if name == "ssdh":
            b["aux"] = _structure_block(int(rng.integers(1 << 30)), BATCH)
        out.append(b)
    return out


@pytest.mark.parametrize("name", ["cibhash", "bihalf", "nsh", "ssdh"])
def test_three_train_steps_match_jax(name):
    """Each step's loss and parts, then every parameter, at rtol 1e-4, under
    the configs' adam (at float32 on the CPU no straight-through sign
    differs between the two packages on these batches); the frozen
    backbone bit-unchanged."""
    cfg, jm, variables, model = reference(
        "unsup_greedyhash" if name == "bihalf"
        else "cibhash" if name == "ssdh" else name)
    cfg = dict(cfg, model=dict(cfg["model"], name=name),
               criterion=dict(CRITERIA[name]))
    jloss = jmethods.get_method(name).build_loss(cfg, None)
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], SPE,
                          variables["params"], backbone_lr_scale=0.0)
    state = create_train_state(jm, tx, jnp.zeros((BATCH, IMAGE, IMAGE, 3)),
                               jax.random.PRNGKey(0), variables=variables)
    jstep = jmake_train_step(jm, jloss, tx, donate=False)
    tloss = tmethods.get_method(name).build_loss(cfg, None)
    tr = tmethods.training_for(cfg, copy.deepcopy(model), tloss, SPE)
    before = copy.deepcopy(tr.model.state_dict())
    for i, b in enumerate(_batches(name, 3)):
        state, jm_ = jstep(state, _j(b))
        tm = tr.step(_t(b))
        assert set(tm) == set(jm_), (set(tm), set(jm_))
        assert "acc" not in tm      # no logits: the labels meet no codes
        for k in jm_:
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=TRAIN_RTOL, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    want = baseline_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     state.variables()))
    got = tr.model.state_dict()
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=TRAIN_RTOL, atol=1e-6, err_msg=k)
    frozen = [n for n, p in tr.model.named_parameters()
              if not p.requires_grad]
    assert frozen and all(torch.equal(got[n], before[n]) for n in frozen)
    assert any(not torch.equal(got[n], before[n])
               for n, p in tr.model.named_parameters() if p.requires_grad)


# ---------------------------------------------------------------------------
# the experiment's parts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torch_unsup")
    make_synthetic_dataset(str(wd / "data" / "synthetic"), nclass=3,
                           per_class_train=8, per_class_test=4, image_size=64)
    return str(wd)


def _args(wd, logdir, model, *extra):
    return ["dataset=synthetic", f"model={model}", "backbone=tiny_test",
            "model.nbit=16", "batch_size=8", "epochs=1", f"data_dir={wd}",
            f"logdir={logdir}", "seed=7", *extra]


def _port(wd, name, model, *extra):
    return main_gpu.build_experiment(
        ["--device", "cpu", *_args(wd, os.path.join(wd, name), model,
                                   *extra)])


def test_two_view_batches_are_two_successive_draws(workdir):
    """The train preprocessing of a two-view method is [v1; v2]: two
    augmentations of the same images drawn one after the other (the
    generators' states advanced as two calls advance them); a one-view
    method's is one draw."""
    exp = _port(workdir, "two_view", "cibhash")
    batch = next(iter(exp.loaders["train"]))
    x = torch.from_numpy(batch["image"])
    states = (exp.aug_generator.get_state(), exp.op_generator.get_state())
    got = exp._train_images(x)
    after = (exp.aug_generator.get_state(), exp.op_generator.get_state())
    exp.aug_generator.set_state(states[0])
    exp.op_generator.set_state(states[1])
    views = [preprocess_batch(x, exp.aug_generator, crop=exp.crop,
                              norm=exp.norm, train=True, augment=exp.augment,
                              op_generator=exp.op_generator)
             for _ in range(2)]
    assert got.shape[0] == 2 * x.shape[0]
    assert torch.equal(got, torch.cat(views))
    assert not torch.equal(views[0], views[1])
    assert torch.equal(after[0], exp.aug_generator.get_state())
    assert torch.equal(after[1], exp.op_generator.get_state())
    one = _port(workdir, "one_view", "ssdh")
    assert one._train_images(x).shape[0] == x.shape[0]
    for e in (exp, one):
        for loader in e.loaders.values():
            loader.close()


@pytest.mark.parametrize("model", ["cibhash", "ssdh"])
def test_chunked_epoch_equals_single_steps(workdir, model):
    """An epoch at train_chunk=2 (a chunk of two and a single step) equals
    one at train_chunk=1: records and weights, bit for bit (the two views'
    draws and SSDH's staged ``aux`` in the single steps' order)."""
    runs = []
    for chunk in (1, 2):
        exp = _port(workdir, f"{model}_chunk{chunk}", model,
                    f"train_chunk={chunk}")
        assert (exp.train_multi_step is not None) == (chunk > 1)
        res = exp.train_one_epoch(0)
        runs.append((res, exp.model.state_dict()))
        for loader in exp.loaders.values():
            loader.close()
    (r1, sd1), (r2, sd2) = runs
    assert {k: v for k, v in r1.items() if k != "time"} == \
        {k: v for k, v in r2.items() if k != "time"}
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)


def test_ssdh_structure_in_dataset_order(workdir):
    """SSDH's structure is ``ssdh_structure`` of the train split's eval
    codes in dataset order (held against one encode of the whole split,
    read in manifest order), built once before the first epoch; each
    shuffled train batch carries ``S[idx, idx]`` as its ``aux``."""
    exp = _port(workdir, "ssdh_structure", "ssdh")
    ds = exp.datasets["train"]
    whole = exp.loaders["train"].source.get_many(np.arange(len(ds)))
    codes = exp._eval_codes_batch({"image": whole,
                                   "label": ds.onehot_labels()})
    mat = exp._extract_train_matrix(exp._eval_codes_batch)
    np.testing.assert_allclose(mat, codes.numpy(), rtol=1e-5, atol=1e-5)
    seen = []
    exp.train_step = lambda b: seen.append(b["aux"]) or {
        "loss": torch.zeros(())}
    loader = exp.loaders["train"]
    batches = list(loader)
    exp.loaders["train"] = [dict(b) for b in batches]
    exp.train_one_epoch(0)
    S = exp._structure
    assert np.array_equal(S, TU.ssdh_structure(mat, alpha=2.0))
    assert len(seen) == len(batches) == 3
    for b, aux in zip(batches, seen):
        idx = b["index"]
        assert aux.dtype == torch.int8
        assert np.array_equal(aux.numpy(), S[np.ix_(idx, idx)])
    assert not all(np.array_equal(b["index"], np.sort(b["index"]))
                   for b in batches)
    structure = exp._structure
    exp.loaders["train"] = [dict(b) for b in batches]
    exp.train_one_epoch(1)
    assert exp._structure is structure      # built once
    exp.loaders["train"] = loader
    for loader in exp.loaders.values():
        loader.close()


def test_fit_features_take_the_train_augmentation(workdir):
    """The shallow fit's features go through the train preprocessing, in
    dataset order, from generators seeded by the run's seed: two
    extractions agree, and they differ from the center-crop eval codes."""
    exp = _port(workdir, "fit_features", "itq")
    a = exp._extract_fit_features()
    b = exp._extract_fit_features()
    center = exp._extract_train_matrix(exp._eval_codes_batch)
    assert a.shape == (24, 64) and np.array_equal(a, b)
    assert not np.allclose(a, center, atol=1e-3)
    for loader in exp.loaders.values():
        loader.close()


def test_main_shallow_matches_jax(workdir, monkeypatch):
    """``_main_shallow`` of each fitter given the same fit, test and
    database features as the reference's: the fit (``models/best.pt``'s
    ``criterion`` against ``best.msgpack``'s) and the mAP, recalls and
    precisions of its one test record."""
    rng = np.random.default_rng(8)
    centers = rng.standard_normal((3, 64)) * 3
    feats = {split: (centers[np.arange(n) % 3]
                     + rng.standard_normal((n, 64))).astype(np.float32)
             for split, n in (("train", 24), ("test", 12), ("db", 24))}
    labels = {split: np.eye(3, dtype=np.float32)[np.arange(n) % 3]
              for split, n in (("test", 12), ("db", 24))}
    jlog = os.path.join(workdir, "jshallow")
    jexp = JExperiment(jloader.load_config(
        str(ROOT / "configs"), "train", _args(workdir, jlog, "itq")))
    texp = _port(workdir, "tshallow", "itq")
    for exp, wrap in ((jexp, np.asarray), (texp, torch.from_numpy)):
        monkeypatch.setattr(exp, "_extract_fit_features",
                            lambda: feats["train"].copy())
        monkeypatch.setattr(exp, "encode_split", lambda split, wrap=wrap: (
            {"codes": wrap(feats[split].copy())}, labels[split], {}))
    for name in ("itq", "pca", "lsh", "sh"):
        for exp in (jexp, texp):
            exp.config["model"]["name"] = name
        want, got = jexp.main(), texp.main()
        jrec, trec = jexp.test_history.history[-1], \
            texp.test_history.history[-1]
        assert trec["ep"] == jrec["ep"] == 0
        assert got == texp.best_metric and 0.0 <= got <= 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        for k in ("recalls", "precisions"):
            np.testing.assert_allclose(trec[k], jrec[k], rtol=0, atol=1e-6)
        jfit = jload_checkpoint(os.path.join(jlog, "models",
                                             "best.msgpack"))["criterion"]
        blob = torch.load(os.path.join(workdir, "tshallow", "models",
                                       "best.pt"))
        assert blob["epoch"] == 0 and blob["criterion"]["kind"] == name
        for k, v in jfit.items():
            if k != "kind":
                np.testing.assert_allclose(
                    blob["criterion"][k].numpy(), np.asarray(v), rtol=RTOL,
                    atol=1e-7, err_msg=f"{name}: {k}")
