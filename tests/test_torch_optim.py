"""The port's optimizers, schedules and freeze policy (``train/optim.py``)
against the JAX package's (optax): each schedule at and around its epoch
boundaries, three updates of adam, adamw, sgd (with and without nesterov)
and lars (with a zero-norm leaf, as a tensor rate too), with and without a
backbone group at a scaled rate, and the freeze labels on the ConceptHash
parameter tree."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from concepthash_tpu.models.clip import AdapterConfig as JAdapterConfig
from concepthash_tpu.models.clip import ClipVisionConfig as JVisionConfig
from concepthash_tpu.models.concepthash import ConceptHash as JConceptHash
from concepthash_tpu.models.concepthash import (ConceptHashConfig as
                                                JConceptHashConfig)
from concepthash_tpu.train import optim as joptim
from concepthash_tpu_torch.models.clip import AdapterConfig, ClipVisionConfig
from concepthash_tpu_torch.models.concepthash import (ConceptHash,
                                                      ConceptHashConfig)
from concepthash_tpu_torch.train import optim as toptim
from concepthash_tpu_torch.weights import from_flax

SCHEDULES = [{"name": "csw", "warmup_epochs": 10},
             {"name": "csw", "warmup_epochs": 0},
             {"name": "step", "step_size": 30, "gamma": 0.1},
             {"name": "milestones", "milestones": [30, 60], "gamma": 0.5},
             {"name": "no_decay"}]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: str(s))
def test_schedules_match_at_epoch_boundaries(sched):
    """lr(step) at 5 steps per epoch around the boundaries of epochs 0, 1,
    9, 10, 29, 30, 60 and 99: rtol 1e-6, and atol 1e-7 x lr where the
    cosine nears zero (the reference computes it in f32, the port in
    double)."""
    spe, epochs, lr = 5, 100, 1e-3
    want = joptim.build_schedule(sched, epochs, spe, lr)
    got = toptim.build_schedule(sched, epochs, spe, lr)
    for ep in (0, 1, 9, 10, 29, 30, 60, 99):
        for step in (ep * spe - 1, ep * spe, ep * spe + spe - 1):
            if step >= 0:
                np.testing.assert_allclose(got(step), float(want(step)),
                                           rtol=1e-6, atol=1e-7 * lr,
                                           err_msg=str(step))


def _module(tree: dict) -> nn.Module:
    """A module whose parameters are the leaves of ``tree``, named by
    their paths (``backbone.fc.kernel``)."""
    mod = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            mod.add_module(k, _module(v))
        else:
            mod.register_parameter(k, nn.Parameter(torch.tensor(v)))
    return mod


def _tree(seed):
    rng = np.random.default_rng(seed)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"backbone": {"fc": {"kernel": a(4, 3), "bias": a(3)},
                         "adapter_attn": {"down": {"kernel": a(3, 2)}}},
            "head": {"kernel": a(3, 5), "bias": a(5)}}


OPTIMS = [{"name": "adam", "lr": 1e-2, "weight_decay": 1e-2},
          {"name": "adam", "lr": 1e-2},
          {"name": "adamw", "lr": 1e-2, "weight_decay": 0.1},
          {"name": "sgd", "lr": 0.1, "momentum": 0.9, "weight_decay": 1e-2},
          {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True},
          {"name": "sgd", "lr": 0.1}]


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("opt", OPTIMS, ids=lambda o: str(o))
def test_three_updates_match_optax(opt, scale):
    """Three updates with seeded gradients under the csw schedule at one
    step per epoch (the rate changes every step): every leaf equal to
    optax's within f32 rounding (rtol 1e-5, atol 1e-7). Scale 0 leaves the
    backbone bit-unchanged, with no gradient and no optimizer state."""
    _check_three_updates(opt, scale, _tree(0))


LARS = [{"name": "lars", "lr": 0.1, "momentum": 0.9, "weight_decay": 1e-2},
        {"name": "lars", "lr": 0.5}]


@pytest.mark.parametrize("capturable", [False, True])
@pytest.mark.parametrize("scale", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("opt", LARS, ids=lambda o: str(o))
def test_lars_matches_optax(opt, scale, capturable):
    """lars as ``optax.lars`` (weight decay, the trust ratio, the rate, then
    momentum on the scaled update), three updates as above, with a leaf
    whose norm is 0 (its trust ratio is 1); ``capturable``: with the rates
    as tensors (``make_capturable``, which a CUDA graph needs), set from
    ``scheduled_lrs`` as a graphed chunk sets them."""
    tree = _tree(0)
    tree["head"]["zero"] = np.zeros((2, 5), np.float32)
    _check_three_updates(opt, scale, tree, capturable)


def _check_three_updates(opt, scale, tree, capturable=False):
    sched = {"name": "csw", "warmup_epochs": 2}
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = joptim.build_optimizer(opt, sched, 10, 1, params,
                                backbone_lr_scale=scale)
    state = tx.init(params)
    mod = _module(tree)
    optimizer, scheduler = toptim.build_optimizer(opt, sched, 10, 1, mod,
                                                  backbone_lr_scale=scale)
    if capturable:
        toptim.make_capturable(optimizer)
    named = dict(mod.named_parameters())
    rng = np.random.default_rng(1)
    for _ in range(3):
        toptim.follow_schedule(optimizer, scheduler)
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), tree)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   state, params)
        params = optax.apply_updates(params, updates)
        flat = jax.tree_util.tree_leaves_with_path(grads)
        for path, g in flat:
            p = named[".".join(k.key for k in path)]
            if p.requires_grad:
                p.grad = torch.tensor(g)
        optimizer.step()
        scheduler.step()
    for path, want in jax.tree_util.tree_leaves_with_path(params):
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(named[name].detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    frozen = ["backbone.fc.kernel", "backbone.fc.bias"]
    for name in frozen:
        assert named[name].requires_grad == (scale != 0.0)
        if scale == 0.0:
            assert named[name] not in optimizer.state
            np.testing.assert_array_equal(
                named[name].detach().numpy(),
                tree["backbone"]["fc"][name.split(".")[-1]])


def test_freeze_labels_match_on_the_concepthash_tree():
    """Each parameter of the port's ConceptHash carries the label the
    reference's ``param_labels`` gives the JAX leaves it comes from: the
    labels, written as 1.0 (backbone) or 0.0 (train) into the JAX leaves,
    are carried across by ``from_flax``."""
    vision = dict(hidden_size=32, intermediate_size=64, num_layers=2,
                  num_heads=4, image_size=16, patch_size=8, projection_dim=32)
    head = dict(nbit=16, nclass=5, ncontext=4, center_dim=32,
                text_projection_dims=(32,))
    jm = JConceptHash(JVisionConfig(**vision), JConceptHashConfig(**head),
                      adapters=JAdapterConfig(bottleneck_dim=8),
                      fixed_center=jnp.zeros((5, 32)))
    variables = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, 16, 3)), train=False))
    labels = joptim.param_labels(variables["params"])
    marked = jax.tree_util.tree_map(
        lambda s, lab: np.full(s.shape, 1.0 if lab == "backbone" else 0.0,
                               np.float32), variables["params"], labels)
    other = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   {k: v for k, v in variables.items()
                                    if k != "params"})
    sd = from_flax({"params": marked, **other})
    pm = ConceptHash(ClipVisionConfig(**vision), ConceptHashConfig(**head),
                     AdapterConfig(bottleneck_dim=8), device="cpu")
    got = toptim.param_labels(pm)
    assert set(got) == {n for n, _ in pm.named_parameters()}
    n_backbone = 0
    for name, label in got.items():
        want = sd[name]
        assert bool((want == 1.0).all()) == (label == "backbone"), name
        assert bool((want == 0.0).all()) == (label == "train"), name
        n_backbone += label == "backbone"
    assert 0 < n_backbone < len(got)
