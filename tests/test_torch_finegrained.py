"""The fine-grained heads and the adsh regime's objective of the PyTorch
port against the JAX package, on the CPU at a tiny size: the CLIP-adapter
trunk at hidden 64, 2 layers, 4 heads, 32^2 images in patches of 8 (a
4 x 4 patch grid), adapters of 16; 16 bits, 10 classes, 4 attention maps;
float32. Each JAX model is built once and its seeded variables (the
adapters' zero up-projections given seeded values) are carried across by
``weights.finegrained_from_flax``.

Held:

- each head's eval forward (A2NetCE, SemiconCE, each with a Dense and with
  a TempCE classifier, and Semicon) with ``output_attentions``: codes,
  logits, A2-Net's ``codes_tanh``, ``all_x`` and ``rec_all_x``, the
  attention maps and SEMICON's suppression maps, at rtol 1e-5;
- SEMICON's codes on a padded eval batch (n_valid < batch), whose
  batch-global mask sees the padding rows, and on the valid rows alone;
- the A2-Net-CE, SEMICON-CE and adsh losses (with and without tanh) at
  rtol 1e-5; ``soften_sim`` exactly, the all-positive guard included;
  ``solve_dcc``'s database codes bit for bit on seeded inputs;
- three steps of ``methods.build_training`` against the reference's
  ``make_train_step`` for ``a2net_ce`` and ``semicon_ce`` (adam, csw, a
  frozen backbone) at rtol 1e-4, the train slice's tolerance.

Run as a script from the repository's root, ``JAX_PLATFORMS=cpu
PYTHONPATH=. python3 tests/test_torch_finegrained.py [--layers 12]
[--steps 5]``, it prints A2-Net-CE's train loss and its parts at full
width and depth (``configs/model/a2net_ce_adapter.yaml``'s ViT-B/32 model,
B=32, float32 on the CPU) for the reference and for the port from the
reference's init, step by step: about four minutes on eight cores.
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
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.losses import baselines as TL
from concepthash_tpu_torch.weights import finegrained_from_flax

NCLASS, NBIT, BATCH, IMAGE, STEPS, SPE, CDIM = 10, 16, 6, 32, 3, 2, 12
RTOL = 1e-5
TRAIN_RTOL = 1e-4

BACKBONE = {"name": "tiny", "hidden_size": 64, "intermediate_size": 128,
            "num_layers": 2, "num_heads": 4, "patch_size": 8,
            "image_size": IMAGE, "projection_dim": 32}
# the criterion keys of configs/model/{a2net_ce,semicon_ce}_adapter.yaml
CRITERION = {"a2net_ce": {"gamma": 0, "hash": 1, "decorr": 0.01},
             "semicon_ce": {"gamma": 0.001, "loss_method": "ce"},
             "semicon": {"gamma": 200, "num_samples": 2000, "max_iters": 3}}


def config(method: str, layers: int = 2) -> dict:
    return {
        "model": {"name": method, "nbit": NBIT, "nclass": NCLASS,
                  "num_attns": 4, "has_adapter": True,
                  "adapter_bottleneck_dim": 16},
        "backbone": dict(BACKBONE, num_layers=layers),
        "criterion": dict(CRITERION[method]),
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 10},
        "epochs": 100, "backbone_lr_scale": 0, "batch_size": BATCH,
        "compute_dtype": "float32", "seed": 0,
        "dataset": {"nclass": NCLASS, "multiclass": False},
    }


def images(seed, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n, IMAGE, IMAGE, 3)).astype(np.float32)


def onehot(labels):
    return np.eye(NCLASS, dtype=np.float32)[labels]


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
def reference(method: str, centers: bool = False, layers: int = 2):
    """The JAX model of ``method`` (with TempCE's seeded fixed centers when
    ``centers``) on a trunk of ``layers`` layers, its seeded variables
    (numpy leaves), and the port's model carrying them."""
    cfg = config(method, layers)
    cb = (np.random.default_rng(5).standard_normal((NCLASS, CDIM))
          .astype(np.float32) if centers else None)
    jm = jmethods.get_method(method).build_model(cfg, cb)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        jnp.zeros((BATCH, IMAGE, IMAGE, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)
    _seed_adapters(variables["params"]["backbone"], np.random.default_rng(2))
    model, _ = tmethods.build_model(cfg, cb, device="cpu")
    model.load_state_dict(finegrained_from_flax(variables), strict=True)
    return cfg, cb, jm, variables, model


def _assert_close(got: dict, want: dict, rtol, atol=1e-6):
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


HEADS = [("a2net_ce", False), ("a2net_ce", True), ("semicon_ce", False),
         ("semicon_ce", True), ("semicon", False)]


@pytest.mark.parametrize("method, centers", HEADS,
                         ids=[f"{m}{'-tempce' if c else ''}"
                              for m, c in HEADS])
def test_head_forward_matches_jax(method, centers):
    """The eval forward with the attention maps, every output within
    rtol 1e-5; TempCE's fixed centers are the ``ce_fc.center`` buffer."""
    _, _, jm, variables, model = reference(method, centers)
    x = images(11)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False,
                                         output_attentions=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.tensor(x), output_attentions=True)
    # TempCE's logits are cosines times temp = 10: atol 1e-6 a unit of
    # cosine
    logits = {k: got.pop(k) for k in ("logits",) if centers}
    _assert_close(got, {k: v for k, v in want.items() if k not in logits},
                  RTOL)
    if centers:
        np.testing.assert_allclose(logits["logits"].numpy(),
                                   np.asarray(want["logits"]), rtol=RTOL,
                                   atol=1e-6 * 10.0)
    assert got["codes"].shape == (BATCH, NBIT)
    if centers:
        assert "ce_fc.center" in dict(model.named_buffers())
    if method == "a2net_ce":
        assert model.hash_w.dtype == torch.float32
        assert tuple(model.hash_w.shape) == (5 * 64, NBIT)
    if method != "a2net_ce":    # the maps' LayerNorm is over the 16 patches
        assert tuple(model.sem_norm[0].weight.shape) == (16,)


def test_semicon_padded_tail_batch_matches_jax():
    """A padded eval batch (3 valid rows, 3 zero rows, as the loader pads):
    the mask is standardized over the whole batch, so the valid rows' codes
    differ from the 3 rows encoded alone; both equal the reference's."""
    _, _, jm, variables, model = reference("semicon")
    x = images(12)
    x[3:] = 0.0
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=False)["codes"])
    with torch.no_grad():
        padded = model(torch.tensor(x))["codes"][:3].numpy()
        alone = model(torch.tensor(x[:3]))["codes"].numpy()
    np.testing.assert_allclose(padded, np.asarray(apply(variables, x))[:3],
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(alone, np.asarray(apply(variables, x[:3])),
                               rtol=RTOL, atol=1e-6)
    assert np.abs(padded - alone).max() > 1e-4


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _outputs(seed):
    rng = np.random.default_rng(seed)
    codes = (1.5 * rng.standard_normal((BATCH, NBIT))).astype(np.float32)
    all_x = rng.standard_normal((BATCH, 40)).astype(np.float32)
    return {"codes": codes, "codes_tanh": np.tanh(codes),
            "logits": (3 * rng.standard_normal((BATCH, NCLASS))).astype(
                np.float32),
            "all_x": all_x,
            "rec_all_x": (all_x + 0.3 * rng.standard_normal(all_x.shape))
            .astype(np.float32)}, onehot(rng.integers(0, NCLASS, BATCH))


LOSSES = [("a2net_ce", {}), ("a2net_ce", {"gamma": 0, "decorr": 0.01}),
          ("semicon_ce", {}), ("semicon_ce", {"gamma": 0.001,
                                              "loss_method": "cos"})]


@pytest.mark.parametrize("name, kw", LOSSES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(LOSSES)])
def test_loss_matches_jax(name, kw):
    out, y = _outputs(7)
    jtotal, jparts = getattr(JL, f"{name}_loss")(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(y), **kw)
    ttotal, tparts = getattr(TL, f"{name}_loss")(
        {k: torch.tensor(v) for k, v in out.items()}, torch.tensor(y), **kw)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=RTOL)
    _assert_close(tparts, jparts, RTOL)


def _adsh_targets(seed, n_rows=20):
    rng = np.random.default_rng(seed)
    S = np.where(rng.random((BATCH, n_rows)) < 0.2, 1.0, -1.0).astype(
        np.float32)
    V = np.sign(rng.standard_normal((n_rows, NBIT))).astype(np.float32)
    rows = rng.choice(n_rows, BATCH, replace=False)
    return {"S": np.asarray(TL.soften_sim(S)), "V": V, "V_omega": V[rows]}


@pytest.mark.parametrize("apply_tanh", [True, False])
def test_adsh_loss_matches_jax(apply_tanh):
    out, _ = _outputs(8)
    codes = out["codes"] if apply_tanh else out["codes_tanh"]
    tgt = _adsh_targets(9)
    kw = dict(gamma=200.0, nbit=NBIT, apply_tanh=apply_tanh)
    jtotal, jparts = JL.adsh_loss({"codes": jnp.asarray(codes)},
                                  {k: jnp.asarray(v) for k, v in tgt.items()},
                                  **kw)
    ttotal, tparts = TL.adsh_loss({"codes": torch.tensor(codes)},
                                  {k: torch.tensor(v) for k, v in tgt.items()},
                                  **kw)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=RTOL)
    _assert_close(tparts, jparts, RTOL)


def test_soften_sim_is_the_references():
    """Exactly the reference's values, on numpy and on tensors; an
    all-positive matrix comes back unchanged."""
    rng = np.random.default_rng(3)
    S = np.where(rng.random((30, 50)) < 0.1, 1.0, -1.0).astype(np.float32)
    want = np.asarray(JL.soften_sim(S))
    np.testing.assert_array_equal(TL.soften_sim(S), want)
    np.testing.assert_array_equal(TL.soften_sim(torch.tensor(S)).numpy(),
                                  want)
    assert set(np.unique(want)) == {1.0, float(want.min())}
    ones = np.ones((4, 6), np.float32)
    np.testing.assert_array_equal(TL.soften_sim(torch.tensor(ones)).numpy(),
                                  ones)
    np.testing.assert_array_equal(np.asarray(JL.soften_sim(ones)), ones)


def test_solve_dcc_matches_jax_bit_for_bit():
    """The database codes after a DCC update, from seeded continuous
    subset codes, a softened similarity and a seeded V: every entry equal,
    and the update moves some bits."""
    rng = np.random.default_rng(4)
    n_train, m, nbit = 60, 24, NBIT
    y = rng.integers(0, 5, n_train)
    omega = rng.choice(n_train, m, replace=False)
    S = TL.soften_sim((y[omega][:, None] == y[None, :]).astype(np.float32)
                      * 2 - 1)
    U = np.tanh(rng.standard_normal((m, nbit))).astype(np.float32)
    V = np.sign(rng.standard_normal((n_train, nbit))).astype(np.float32)
    want = np.asarray(JL.solve_dcc(jnp.asarray(V), jnp.asarray(U),
                                   jnp.asarray(S), jnp.asarray(omega), 200.0,
                                   nbit))
    got = TL.solve_dcc(torch.tensor(V), torch.tensor(U), torch.tensor(S),
                       omega, 200.0, nbit).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != V).any() and set(np.unique(got)) <= {-1.0, 1.0}


# ---------------------------------------------------------------------------
# three train steps
# ---------------------------------------------------------------------------

def _batches(seed):
    rng = np.random.default_rng(seed)
    return [{"image": images(int(rng.integers(1 << 30))),
             "label": onehot(rng.integers(0, NCLASS, BATCH))}
            for _ in range(STEPS)]


# configs/optim/sgd.yaml
SGD = {"name": "sgd", "lr": 0.001, "momentum": 0.9, "weight_decay": 0.0005}


@pytest.mark.parametrize("method", ["a2net_ce", "semicon_ce"])
def test_three_train_steps_match_jax(method):
    """Each step's loss, parts and accuracy, then every parameter, at rtol
    1e-4; the frozen backbone bit-unchanged. SEMICON-CE steps with sgd:
    its maps gate tokens that a LayerNorm over D then normalizes, so their
    gradient comes from the few tokens whose gate is near zero, where the
    LayerNorm's eps acts; a 2^-22 relative change of the images moves the
    reference's own gradients of ``sem_norm_i`` by 2e-4 to 4e-3 relative,
    and its attention key biases have a gradient that is zero in exact
    arithmetic. Adam's per-parameter normalization turns such rounding
    into updates no two implementations share; sgd keeps them
    rounding-sized."""
    cfg, cb, jm, variables, model = reference(method)
    if method == "semicon_ce":
        cfg = dict(cfg, optim=dict(SGD))
    jloss = jmethods.get_method(method).build_loss(cfg, cb)
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], SPE,
                          variables["params"], backbone_lr_scale=0.0)
    state = create_train_state(jm, tx, jnp.zeros((BATCH, IMAGE, IMAGE, 3)),
                               jax.random.PRNGKey(0), variables=variables)
    jstep = jmake_train_step(jm, jloss, tx, donate=False)
    tloss = tmethods.get_method(method).build_loss(cfg, cb)
    tr = tmethods.training_for(cfg, copy.deepcopy(model), tloss, SPE)
    before = copy.deepcopy(tr.model.state_dict())
    for i, b in enumerate(_batches(3)):
        state, jm_ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tr.step({k: torch.tensor(v) for k, v in b.items()})
        assert set(tm) == set(jm_), (set(tm), set(jm_))
        for k in jm_:
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=TRAIN_RTOL, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    want = finegrained_from_flax(jax.tree_util.tree_map(np.asarray,
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
    assert any(not torch.equal(got[n], before[n])
               for n, p in tr.model.named_parameters() if p.requires_grad)


def test_a2net_ce_loss_rises_with_the_reference():
    """On a 12-layer random trunk the features are large, and A2-Net-CE's
    reconstruction through its tied hash layer outgrows the hash loss under
    the config's adam: five steps on one batch raise the total loss in the
    reference, and the port's losses and parts follow it step by step at
    rtol 1e-4 (so a card's rising A2-Net-CE loss is the reference's)."""
    cfg, cb, jm, variables, model = reference("a2net_ce", layers=12)
    jloss = jmethods.get_method("a2net_ce").build_loss(cfg, cb)
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], SPE,
                          variables["params"], backbone_lr_scale=0.0)
    state = create_train_state(jm, tx, jnp.zeros((BATCH, IMAGE, IMAGE, 3)),
                               jax.random.PRNGKey(0), variables=variables)
    jstep = jmake_train_step(jm, jloss, tx, donate=False)
    tr = tmethods.training_for(cfg, copy.deepcopy(model), tmethods.get_method(
        "a2net_ce").build_loss(cfg, cb), SPE)
    b = _batches(4)[0]
    want, got = [], []
    for i in range(5):
        state, jm_ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tr.step({k: torch.tensor(v) for k, v in b.items()})
        for k in ("loss", "hash", "decorr", "rec"):
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=TRAIN_RTOL, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
        want.append(float(jm_["loss"]))
        got.append(float(tm["loss"]))
    assert want[-1] > want[0] and got[-1] > got[0], (want, got)


# ---------------------------------------------------------------------------
# A2-Net-CE at full width and depth (run as a script)
# ---------------------------------------------------------------------------

def a2net_full_depth(layers: int = 12, steps: int = 5) -> None:
    """Print A2-Net-CE's train loss and parts, the reference against the
    port, for ``steps`` steps of the config's adam and csw schedule (188
    steps an epoch, CUB-200's) on one seeded batch of 32 images."""
    image, batch, nclass = 224, 32, 200
    cfg = config("a2net_ce")
    cfg["model"].update(nbit=64, nclass=nclass, adapter_bottleneck_dim=384)
    cfg["backbone"] = {"name": "vit-b-32", "hidden_size": 768,
                       "intermediate_size": 3072, "num_layers": layers,
                       "num_heads": 12, "patch_size": 32,
                       "image_size": image, "projection_dim": 512}
    cfg["batch_size"] = batch
    cfg["dataset"]["nclass"] = nclass
    jm = jmethods.get_method("a2net_ce").build_model(cfg, None)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        jnp.zeros((2, image, image, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)
    _seed_adapters(variables["params"]["backbone"], np.random.default_rng(2))
    model, _ = tmethods.build_model(cfg, None, device="cpu")
    model.load_state_dict(finegrained_from_flax(variables), strict=True)
    rng = np.random.default_rng(0)
    b = {"image": rng.standard_normal((batch, image, image, 3)).astype(
        np.float32),
         "label": np.eye(nclass, dtype=np.float32)[
             rng.integers(0, nclass, batch)]}
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], 188,
                          variables["params"], backbone_lr_scale=0.0)
    state = create_train_state(jm, tx, jnp.zeros((2, image, image, 3)), key,
                               variables=variables)
    jstep = jmake_train_step(jm, jmethods.get_method("a2net_ce").build_loss(
        cfg, None), tx, donate=False)
    tr = tmethods.training_for(cfg, model, tmethods.get_method(
        "a2net_ce").build_loss(cfg, None), 188)
    print(f"A2-Net-CE, {layers} layers, B={batch}, float32 on the CPU: "
          "JAX / port")
    for i in range(steps):
        state, jm_ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tr.step({k: torch.tensor(v) for k, v in b.items()})
        print(f"step {i}: " + ", ".join(
            f"{k} {float(jm_[k]):.6g} / {float(tm[k]):.6g}"
            for k in ("loss", "hash", "decorr", "rec")), flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
    a2net_full_depth(**vars(ap.parse_args()))
