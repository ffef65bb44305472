"""The non-CLIP trunks of the PyTorch port against the JAX package, on the
CPU at tiny sizes, float32: ResNet-18 (``frozen_bn``) and ResNet-50 at 32^2,
the Swin ``test`` variant at 32^2 with window 4 (stage 0 shifts, stage 1's
window covers its grid and does not), AlexNet at 64^2, VGG16 at 32^2, the
``vit`` family at ``tiny_test``'s geometry with adapters of 16, and
``identity`` fed through ``array_loader``. Each JAX trunk's variables,
drawn by numpy in flax's tree (``seeded_variables``: the BatchNorm
statistics and the adapters' up-projections too, so they carry signal),
are carried across by ``weights.trunk_from_flax``.

Held, for each family:

- the eval forward's ``features`` and ``tokens`` at rtol 1e-4, atol 1e-5
  (f32 convolutions summed in another order, through up to 50 layers);
- a train forward's outputs at the same tolerance and the running
  statistics it leaves against flax's mutated ``batch_stats`` within 1e-5;
  with ``frozen_bn`` the statistics unchanged and the output the eval one;

and then: the pieces of Swin that are easy to get wrong, each on its own
(the relative-position index, the shift mask, the roll, the window that
covers the grid, the patch-merging order); every group of
``configs/backbone`` building through ``trunk_from_config``; three
orthohash train steps on a ResNet-18 trunk (its BatchNorm moving) against
the reference's ``make_train_step`` at rtol 1e-4, the train slice's
tolerance; ``a2net_ce`` on ResNet-50 tokens and SEMICON on Swin tokens
against the reference's heads; and the ``ValueError`` of a fine-grained
head over a trunk without tokens.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from concepthash_tpu import methods as jmethods
from concepthash_tpu.data import pipeline as jpipeline
from concepthash_tpu.models import swin as jswin
from concepthash_tpu.models import trunk as jtrunk
from concepthash_tpu.models.clip import AdapterConfig as JAdapterConfig
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.data import pipeline as tpipeline
from concepthash_tpu_torch.models import swin as tswin
from concepthash_tpu_torch.models import trunk as ttrunk
from concepthash_tpu_torch.models.clip import AdapterConfig
from concepthash_tpu_torch.weights import (baseline_from_flax,
                                           finegrained_from_flax,
                                           trunk_from_flax)

RTOL, ATOL = 1e-4, 1e-5
STATS_TOL = 1e-5
TRAIN_RTOL = 1e-4
BATCH = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_VIT = {"family": "vit", "hidden_size": 64, "intermediate_size": 128,
            "num_layers": 2, "num_heads": 4, "patch_size": 8,
            "image_size": 48, "projection_dim": 32}
GROUPS = {
    "resnet18": ({"family": "resnet", "depth": 18, "frozen_bn": True}, 32),
    "resnet50": ({"family": "resnet", "depth": 50}, 32),
    "swin_test": ({"family": "swin", "variant": "test", "image_size": 32,
                   "window_size": 4}, 32),
    "alexnet": ({"family": "alexnet"}, 64),
    "vgg16": ({"family": "vgg16"}, 32),
    "vit": (TINY_VIT, 48),
}


def images(seed, side, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n, side, side, 3)).astype(np.float32)


def seeded_variables(module, side: int, seed: int, **init_kw) -> dict:
    """``module``'s variables drawn by numpy at ``seed``, in flax's tree:
    the shapes from ``jax.eval_shape`` of its init (nothing is compiled),
    kernels at flax's lecun-normal scale (1/sqrt(fan-in)), scales around 1,
    BatchNorm variances in [0.5, 1.5], and biases, BatchNorm means,
    embeddings and every other table around 0 (the adapters' up-projections
    too, so they carry signal)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": key, "dropout": key}, jnp.zeros((BATCH, side, side, 3)),
        **init_kw))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        z = rng.standard_normal(shape, np.float32)
        if name == "scale":
            return 1 + np.float32(0.1) * z
        std = 1 / np.sqrt(np.prod(shape[:-1])) if name == "kernel" else 0.1
        return np.float32(std) * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def reference(name: str):
    """(JAX trunk, its seeded variables, the port's trunk carrying them)."""
    group, side = GROUPS[name]
    group = {**group, "image_size": group.get("image_size", side)}
    jadapters = JAdapterConfig(bottleneck_dim=16) if name == "vit" else None
    jt = jtrunk.trunk_from_config(group, jadapters)
    variables = seeded_variables(jt, side, 1)
    tt = ttrunk.trunk_from_config(
        group, AdapterConfig(bottleneck_dim=16) if name == "vit" else None)
    tt.load_state_dict(trunk_from_flax(variables), strict=True)
    return jt, variables, tt, side


def _assert_close(got: dict, want: dict, keys, rtol=RTOL, atol=ATOL):
    """In float64, which holds either side's float32 or float64 exactly."""
    for k in keys:
        np.testing.assert_allclose(got[k].detach().double().numpy(),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


def _stats(trunk) -> dict:
    return {k: v.clone() for k, v in trunk.state_dict().items()
            if "running" in k}


@pytest.mark.parametrize("name", list(GROUPS))
def test_trunk_eval_forward_matches_jax(name):
    jt, variables, tt, side = reference(name)
    x = images(3, side)
    want = jax.jit(lambda v, x: jt.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tt(torch.tensor(x))
    keys = ["features"] + (["tokens"] if name != "alexnet" else [])
    assert set(keys) <= set(got) and ("tokens" in got) == ("tokens" in want)
    _assert_close(got, want, keys)
    assert got["features"].shape[1] == tt.features_size
    if "tokens" in got:
        assert got["tokens"].shape[1:] == (tt.num_tokens, tt.tokens_size)


def _float64(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` computing in float64 (its parameters stay float32, as a
    flax module's do at a float64 ``dtype``)."""
    for m in module.modules():
        if getattr(m, "dtype", None) in (torch.float32, torch.bfloat16):
            m.dtype = torch.float64
    return module


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "swin_test",
                                  "vit"])
def test_trunk_train_forward_and_batch_stats_match_jax(name):
    """A train forward: outputs as the reference's; a ResNet's running
    statistics as flax's mutated ``batch_stats`` within 1e-5 (ResNet-50),
    or unchanged with ``frozen_bn`` (ResNet-18, whose output is then the
    eval forward's).

    ResNet-50 is held with both sides computing in float64: at 32^2 its
    last stages normalize 4 x 2 x 2 and 4 x 1 x 1 values a channel, where
    float32's E[x^2] - E[x]^2 cancels (measured on this test's batch: the
    features of the port's float32 forward within 0.027 of float64's, the
    reference's within 0.038), so float32 would compare rounding, not the
    arithmetic."""
    jt, variables, tt, side = reference(name)
    x = images(4, side)
    pt = copy.deepcopy(tt)
    wide = name == "resnet50"
    if wide:
        _float64(pt)
        with jax.enable_x64(True):
            want, mutated = jax.jit(lambda v, x: jt.clone(
                dtype=jnp.float64).apply(v, x, train=True,
                                         mutable=["batch_stats"]))(
                variables, jnp.asarray(x, jnp.float64))
            want = jax.tree_util.tree_map(np.asarray, want)
            mutated = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), dict(mutated))
    else:
        want, mutated = jax.jit(lambda v, x: jt.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables,
                                                         jnp.asarray(x))
        mutated = jax.tree_util.tree_map(np.asarray, dict(mutated))
    before = _stats(pt)
    got = pt(torch.tensor(x, dtype=torch.float64 if wide else None),
             train=True)
    _assert_close(got, want, ["features", "tokens"],
                  rtol=1e-9 if wide else RTOL, atol=1e-9 if wide else ATOL)
    after = _stats(pt)
    if not name.startswith("resnet"):
        return
    new = trunk_from_flax({**variables, **mutated})
    for k, v in after.items():
        np.testing.assert_allclose(v.numpy(), new[k].numpy(),
                                   rtol=STATS_TOL, atol=STATS_TOL, err_msg=k)
    counts = {k: int(v) for k, v in pt.state_dict().items()
              if k.endswith("num_batches_tracked")}
    if name == "resnet18":      # frozen_bn: eval-mode BatchNorm throughout
        assert all(torch.equal(after[k], before[k]) for k in after)
        assert set(counts.values()) == {0}
        with torch.no_grad():
            _assert_close(got, {k: v.numpy() for k, v in
                                tt(torch.tensor(x)).items()},
                          ["features", "tokens"], rtol=0, atol=0)
    else:
        assert any(not torch.equal(after[k], before[k]) for k in after)
        assert set(counts.values()) == {1}


def test_identity_through_array_loader_matches_jax():
    """``ArrayDataset`` / ``array_loader`` batches (padded tail, one-hots,
    indices) equal the reference's, and the identity trunk passes the
    feature rows through as float32."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((10, 12)).astype(np.float32)
    labels = rng.integers(0, 3, 10)
    jds = jpipeline.ArrayDataset(feats, labels)
    tds = tpipeline.ArrayDataset(feats, labels)
    assert tds.num_classes == jds.num_classes == 3
    jt = jtrunk.trunk_from_config({"family": "identity"})
    tt = ttrunk.trunk_from_config({"family": "identity", "hidden_size": 12})
    assert tt.features_size == 12 and not list(tt.parameters())
    jb = list(jpipeline.array_loader(jds, 4, shuffle=True, seed=3))
    tb = list(tpipeline.array_loader(tds, 4, shuffle=True, seed=3))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        want = jt.apply({}, jnp.asarray(b["image"]))
        got = tt(torch.tensor(a["image"]))
        _assert_close(got, want, ["features"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Swin's parts, each on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", [2, 4, 7])
def test_swin_relative_position_index(ws):
    np.testing.assert_array_equal(tswin.relative_position_index(ws),
                                  jswin._relative_position_index(ws))


@pytest.mark.parametrize("H, ws, shift", [(8, 4, 2), (56, 7, 3), (14, 7, 3)])
def test_swin_shift_mask(H, ws, shift):
    np.testing.assert_array_equal(tswin.shift_attn_mask(H, H, ws, shift),
                                  jswin._shift_attn_mask(H, H, ws, shift))


def test_swin_window_partition_roll_and_merge_order():
    """Window partition and reverse, the roll by -shift and +shift, and
    patch merging's concatenation (timm's x[0::2, 0::2], x[1::2, 0::2],
    x[0::2, 1::2], x[1::2, 1::2]) against the reference's reshapes."""
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    t = torch.tensor(x)
    w = tswin.window_partition(t, 4)
    np.testing.assert_array_equal(w.numpy(), np.asarray(
        jswin._window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        tswin.window_reverse(w, 4, 2, 8, 8).numpy(), x)
    np.testing.assert_array_equal(
        torch.roll(t, (-2, -2), dims=(1, 2)).numpy(),
        np.asarray(jnp.roll(jnp.asarray(x), (-2, -2), axis=(1, 2))))
    merged = t.reshape(2, 4, 2, 4, 2, 3).permute(0, 1, 3, 4, 2, 5).reshape(
        2, 4, 4, 12)
    timm = torch.cat([t[:, 0::2, 0::2], t[:, 1::2, 0::2], t[:, 0::2, 1::2],
                      t[:, 1::2, 1::2]], dim=-1)
    assert torch.equal(merged, timm)


def test_swin_window_covering_the_grid_takes_no_shift():
    """At 32^2, patch 4, window 4 the grids are 8, 4, 2, 1: stage 0's odd
    block shifts by 2 under a mask, every later window is the whole grid
    (min(window, H, W)) with no shift and a bias table sized to it."""
    tt = reference("swin_test")[2].tower
    blocks = [(si, b) for si, st in enumerate(tt.layers) for b in st.blocks]
    assert [(si, b.ws, b.shift) for si, b in blocks] == [
        (0, 4, 0), (0, 4, 2), (1, 4, 0), (1, 4, 0), (2, 2, 0), (3, 1, 0)]
    assert blocks[1][1].attn_mask.shape == (4, 16, 16)
    assert all(b.attn_mask is None for _, b in blocks if not b.shift)
    assert blocks[4][1].attn.relative_position_bias_table.shape == (9, 2)
    assert not any("relative_position_index" in k or "attn_mask" in k
                   for k in tt.state_dict())


def test_every_backbone_group_builds():
    """Each of configs/backbone's non-CLIP groups builds through
    ``trunk_from_config`` (at full width: no forward here) with its
    features size."""
    want = {"alexnet": 4096, "clip_r50": 2048, "resnet18": 512,
            "resnet50": 2048, "resnet101": 2048, "swin_tiny": 768,
            "swin_small": 768, "swin_base": 1024, "vgg16": 4096,
            "vit_b16": 768, "vit_s16": 384}
    for name, width in want.items():
        with open(os.path.join(ROOT, "configs", "backbone",
                               f"{name}.yaml")) as f:
            group = yaml.safe_load(f)
        trunk = ttrunk.trunk_from_config(group, dtype=torch.bfloat16)
        assert trunk.family == group["family"]
        assert trunk.features_size == width, name
    vit = ttrunk.trunk_from_config({**TINY_VIT, "layer_norm_eps": 1e-12})
    cfg = vit.vision_cfg
    assert (cfg.hidden_act, cfg.patch_bias, cfg.use_pre_layernorm,
            cfg.layer_norm_eps) == ("gelu", True, False, 1e-12)


# ---------------------------------------------------------------------------
# heads over the new trunks
# ---------------------------------------------------------------------------

NCLASS, NBIT, SPE = 5, 16, 2


def _config(method: str, group: dict, side: int) -> dict:
    crit = {"orthohash": {"ce": 1, "s": 8, "m": 0.2, "m_type": "cos",
                          "quan": 0, "quan_type": "cs",
                          "multiclass_loss": "label_smoothing"},
            "a2net_ce": {"gamma": 0, "hash": 1, "decorr": 0.01},
            "semicon": {}}[method]
    return {
        "model": {"name": method, "nbit": NBIT, "nclass": NCLASS,
                  "add_bn": True, "num_attns": 2},
        "backbone": {**group, "image_size": side},
        "criterion": crit,
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 10},
        "epochs": 100, "backbone_lr_scale": 0.1, "batch_size": BATCH,
        "compute_dtype": "float32", "seed": 0,
        "dataset": {"nclass": NCLASS, "multiclass": False, "crop": side},
    }


def _head_models(method: str, trunk_name: str, codebook=None):
    group, side = GROUPS[trunk_name]
    cfg = _config(method, group, side)
    jm = jmethods.get_method(method).build_model(cfg, codebook)
    variables = seeded_variables(jm, side, 2, train=True)
    tm, _ = tmethods.build_model(cfg, codebook, device="cpu")
    bridge = (baseline_from_flax if method == "orthohash"
              else finegrained_from_flax)
    tm.load_state_dict(bridge(variables), strict=True)
    return cfg, jm, variables, tm, side


def _orthohash_codebook():
    rng = np.random.default_rng(5)
    return np.where(rng.standard_normal((NCLASS, NBIT)) > 0, 1.0,
                    -1.0).astype(np.float32)


def test_orthohash_steps_on_resnet18_match_jax():
    """Three orthohash steps on a ResNet-18 trunk (without frozen_bn, so
    its BatchNorm trains and its statistics move; the backbone at 0.1 of
    the rate): each step's metrics, then every parameter and running
    statistic, at rtol 1e-4. Both sides compute in float64 (parameters and
    optimizer in float32), for the reason the ResNet-50 train forward
    does: the last stage's BatchNorm over 4 x 1 x 1 values a channel. The
    parameters' atol is 1e-5, one backbone step (lr 1e-3 x warm-up 0.1 x
    scale 0.1): adam moves an element whose gradient is near zero by a
    full step whose sign that gradient's last bits decide."""
    cb = _orthohash_codebook()
    GROUPS["resnet18_train"] = ({"family": "resnet", "depth": 18}, 32)
    cfg, jm, variables, tm, side = _head_models("orthohash",
                                                "resnet18_train", cb)
    _float64(tm)
    tr = tmethods.training_for(cfg, tm, tmethods.get_method(
        "orthohash").build_loss(cfg, cb), SPE)
    before = copy.deepcopy(tm.state_dict())
    rng = np.random.default_rng(6)
    batches = [{"image": images(int(rng.integers(1 << 30)), side).astype(
                    np.float64),
                "label": np.eye(NCLASS, dtype=np.float32)[
                    rng.integers(0, NCLASS, BATCH)]} for _ in range(3)]
    with jax.enable_x64(True):
        jm = jm.clone(dtype=jnp.float64)
        jloss = jmethods.get_method("orthohash").build_loss(cfg, cb)
        tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"],
                              SPE, variables["params"],
                              backbone_lr_scale=0.1)
        state = create_train_state(jm, tx, jnp.zeros((BATCH, side, side, 3)),
                                   jax.random.PRNGKey(0),
                                   variables=variables)
        jstep = jmake_train_step(jm, jloss, tx, donate=False)
        jmets = []
        for b in batches:
            state, jmet = jstep(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            jmets.append({k: float(v) for k, v in jmet.items()})
        jvars = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       state.variables())
    for i, (b, jmet) in enumerate(zip(batches, jmets)):
        tmet = tr.step({k: torch.tensor(v) for k, v in b.items()})
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), jmet[k],
                                       rtol=TRAIN_RTOL, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    want = baseline_from_flax(jvars)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in got:
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 3, k
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=TRAIN_RTOL, atol=1e-5, err_msg=k)
    assert not torch.equal(got["backbone.tower.bn1.running_mean"],
                           before["backbone.tower.bn1.running_mean"])
    assert not torch.equal(got["backbone.tower.conv1.weight"],
                           before["backbone.tower.conv1.weight"])


@pytest.mark.parametrize("method, trunk_name", [("a2net_ce", "resnet50"),
                                                ("semicon", "swin_test")])
def test_finegrained_heads_on_grid_tokens_match_jax(method, trunk_name):
    """A2NetCE over ResNet-50's (B, 1, 2048) grid at 32^2 and SEMICON over
    Swin's tokens (its map LayerNorm sized by the trunk's token count),
    eval forward at rtol 1e-4."""
    cfg, jm, variables, tm, side = _head_models(method, trunk_name)
    x = images(8, side)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.tensor(x))
    _assert_close(got, want, ["codes"] + (["logits"] if method == "a2net_ce"
                                          else []))


def test_finegrained_head_without_tokens_raises():
    cfg = _config("a2net_ce", {"family": "alexnet"}, 64)
    with pytest.raises(ValueError, match="token"):
        tmethods.build_model(cfg, None, device="cpu")
