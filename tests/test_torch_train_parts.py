"""Pieces of the port's train slice on their own, against the JAX package
where it has a counterpart: the seeded init (its draws and nothing of the
global generator), the flax-style dropout (rate, mask shape and
broadcast, a fixed generator repeats), the train-mode code BatchNorm against
flax's ``nn.BatchNorm`` (output and running statistics), the accuracies,
``from_flax`` on the discrete path's parameter tree, and the config-dict
builders of ``methods``."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu import methods as jmethods
from concepthash_tpu.models import backbone_factory as jfactory
from concepthash_tpu.models.clip import AdapterConfig as JAdapterConfig
from concepthash_tpu.models.clip import ClipVisionConfig as JVisionConfig
from concepthash_tpu.models.concepthash import ConceptHash as JConceptHash
from concepthash_tpu.models.concepthash import (ConceptHashConfig as
                                                JConceptHashConfig)
from concepthash_tpu.train.state import accuracy_metrics as jaccuracy
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.models import backbone_factory as tfactory
from concepthash_tpu_torch.models.clip import AdapterConfig, ClipVisionConfig
from concepthash_tpu_torch.models.concepthash import (ConceptHash,
                                                      ConceptHashConfig)
from concepthash_tpu_torch.models.layers import (CodeBatchNorm, dropout,
                                                 linear, normal_)
from concepthash_tpu_torch.train.state import accuracy_metrics
from concepthash_tpu_torch.weights import from_flax

VISION = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
              image_size=48, patch_size=8, projection_dim=32)
HEAD = dict(nbit=16, nclass=10, ncontext=4, center_dim=32,
            text_projection_dims=(32,))


def test_dropout_rate_shape_and_broadcast():
    """Kept entries are scaled by 1/(1-rate) and the rest zeroed; about
    1-rate of them are kept (within 0.01 over 60,000 draws); along the
    broadcast dims the mask is one and the same."""
    x = torch.ones(3, 2, 200, 300)
    y = dropout(x, 0.25, torch.Generator().manual_seed(0),
                broadcast_dims=(0, 1))
    assert torch.unique(y).tolist() == [0.0, pytest.approx(1 / 0.75)]
    mask = y != 0
    assert torch.equal(mask, mask[:1, :1].expand_as(mask))
    assert abs(mask[0, 0].float().mean().item() - 0.75) < 0.01
    full = dropout(x[0, 0], 0.25, torch.Generator().manual_seed(0))
    assert abs((full != 0).float().mean().item() - 0.75) < 0.01
    assert dropout(x, 0.0, None) is x
    assert not dropout(x, 1.0, torch.Generator()).any()
    with pytest.raises(ValueError):
        dropout(x, 0.1, None)


def test_seeded_init_draws_only_from_its_generator():
    """``linear`` and ``normal_`` set ``torch.randn(shape, generator) * std``
    bit for bit, in place or (a non-contiguous or bfloat16 tensor) through a
    copy; a whole model's build leaves the global generator untouched."""
    lin = linear(40, 24, generator=torch.Generator().manual_seed(5))
    want = torch.randn((24, 40), generator=torch.Generator().manual_seed(5))
    assert torch.equal(lin.weight, want * (1.0 / 40 ** 0.5))
    assert torch.equal(lin.bias, torch.zeros(24))
    for t in (torch.empty(7, 5).t(), torch.empty(5, 7, dtype=torch.bfloat16)):
        normal_(t, 0.02, torch.Generator().manual_seed(6))
        want = torch.randn(t.shape, generator=torch.Generator().manual_seed(6))
        assert torch.equal(t, (want * 0.02).to(t.dtype))
    before = torch.get_rng_state()
    ConceptHash(ClipVisionConfig(**VISION), ConceptHashConfig(**HEAD),
                AdapterConfig(bottleneck_dim=16), device="cpu",
                generator=torch.Generator().manual_seed(0))
    assert torch.equal(torch.get_rng_state(), before)


def test_dropout_fixed_generator_repeats():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    a = dropout(x, 0.1, torch.Generator().manual_seed(7))
    b = dropout(x, 0.1, torch.Generator().manual_seed(7))
    c = dropout(x, 0.1, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_forward_draws_dropout_from_the_generator():
    """ConceptHash(train=True) at dropout 0.1: the same generator seed gives
    the same outputs, another seed others; no generator raises; the
    inference forward draws nothing."""
    pm = ConceptHash(ClipVisionConfig(**VISION),
                     ConceptHashConfig(**HEAD, dropout=0.1),
                     AdapterConfig(bottleneck_dim=16), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    img = torch.randn(4, 48, 48, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        run = lambda s: pm(img, train=True,
                           generator=torch.Generator().manual_seed(s))
        a, b, c = run(3), run(3), run(4)
        assert torch.equal(a["codes"], b["codes"])
        assert not torch.equal(a["codes"], c["codes"])
        with pytest.raises(ValueError):
            pm(img, train=True)
        assert torch.equal(pm(img)["codes"], pm(img)["codes"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_code_batchnorm_train_matches_flax(dtype):
    """Batch statistics in f32, the biased variance, and running stats
    r = 0.9 r + 0.1 batch_stat, against flax nn.BatchNorm(momentum=0.9):
    output atol 1e-5 at f32 (one bf16 ulp at bf16), stats rtol 1e-6."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((12, 16)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(16)).astype(np.float32)
    var = (1 + 0.5 * rng.random(16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jdt)
    want, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean, "var": var}},
                         jnp.asarray(x, jdt), mutable=["batch_stats"])
    m = CodeBatchNorm(16, dtype)
    with torch.no_grad():
        m.weight.copy_(torch.tensor(scale))
        m.bias.copy_(torch.tensor(bias))
        m.running_mean.copy_(torch.tensor(mean))
        m.running_var.copy_(torch.tensor(var))
    got = m(torch.tensor(x).to(dtype), train=True)
    assert got.dtype == dtype
    tol = (dict(atol=1e-5, rtol=0) if dtype == torch.float32
           else dict(atol=2 ** -7, rtol=2 ** -7))
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)


def test_accuracy_metrics_match_jax():
    rng = np.random.default_rng(4)
    out = {"logits": rng.standard_normal((9, 5)).astype(np.float32),
           "logits_cont": rng.standard_normal((9, 5)).astype(np.float32),
           "logits_concept": rng.standard_normal((4, 9, 5)).astype(
               np.float32),
           "codes": rng.standard_normal((9, 8)).astype(np.float32)}
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 9)]
    want = jaccuracy({k: jnp.asarray(v) for k, v in out.items()},
                     jnp.asarray(onehot))
    got = accuracy_metrics({k: torch.tensor(v) for k, v in out.items()},
                           torch.tensor(onehot))
    assert set(got) == set(want) == {"acc", "acc_cont", "acc_concept"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]))


def test_from_flax_carries_the_discrete_path_tree():
    """The reference's discrete path with fused_ln='pallas' and
    attention_impl='pallas' declares the same parameter tree, through its
    LN and Dense mirrors, as its default path; ``from_flax`` carries it,
    with batch_stats, into a port model of the same configuration."""
    trees = []
    for impl in ("auto", "pallas"):
        jm = JConceptHash(JVisionConfig(**VISION, attention_impl=impl,
                                        fused_ln=impl),
                          JConceptHashConfig(**HEAD),
                          adapters=JAdapterConfig(bottleneck_dim=16),
                          fixed_center=jnp.zeros((10, 32)))
        trees.append(jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, 48, 48, 3)), train=True)))
    assert (jax.tree_util.tree_structure(trees[0])
            == jax.tree_util.tree_structure(trees[1]))
    rng = np.random.default_rng(5)
    v = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), trees[1])
    pm = ConceptHash(ClipVisionConfig(**VISION, attention_impl="pallas",
                                      fused_ln="pallas"),
                     ConceptHashConfig(**HEAD),
                     AdapterConfig(bottleneck_dim=16), device="cpu")
    pm.load_state_dict(from_flax(v), strict=True)
    np.testing.assert_array_equal(
        pm.hash_bn.running_var.numpy(), v["batch_stats"]["hash_bn"]["bn"]["var"])
    lay = v["params"]["backbone"]["layers_1"]
    np.testing.assert_array_equal(
        pm.backbone.layers[1].layer_norm2.weight.detach().numpy(),
        lay["layer_norm2"]["scale"])
    np.testing.assert_array_equal(
        pm.backbone.layers[1].self_attn.qkv_proj.weight[64:128].detach()
        .numpy(), lay["self_attn"]["k_proj"]["kernel"].T)


def _flagship(dtype="float32"):
    return {"model": {"name": "concepthash", "nbit": 64, "nclass": 200,
                      "ncontext": 4, "has_adapter": True,
                      "adapter_bottleneck_dim": 384,
                      "upt_config": {"num_heads": 8, "dropout": 0.1,
                                     "ensemble_method": "concat",
                                     "hash_pe": True},
                      "add_bn": True, "concept_reg": True,
                      "text_projection_dims": [512]},
            "backbone": {"name": "openai/clip-vit-base-patch32"},
            "compute_dtype": dtype}


@pytest.mark.parametrize("backbone", [
    {"name": "openai/clip-vit-base-patch32"},
    {"name": "openai/clip-vit-base-patch16"},
    {"name": "tiny", **{k: v for k, v in VISION.items()}}])
def test_backbone_factory_matches_jax(backbone):
    want = jfactory.vision_config_from_backbone_cfg(backbone)
    got = tfactory.vision_config_from_backbone_cfg(backbone)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    model = _flagship()["model"]
    assert (dataclasses.asdict(tfactory.adapter_config_from_model_cfg(model))
            == dataclasses.asdict(jfactory.adapter_config_from_model_cfg(
                model)))
    assert tfactory.adapter_config_from_model_cfg({}) is None
    remat = {**backbone, "remat": True}
    got = tfactory.vision_config_from_backbone_cfg(remat)
    want = jfactory.vision_config_from_backbone_cfg(remat)
    assert got.remat is True
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_methods_build_the_reference_configuration():
    """_build_concepthash from the flagship's config dicts gives the
    reference's ConceptHashConfig (every field both have) and compute
    dtype; 'vision' overrides reach the tower's layers."""
    cfg = {**_flagship("bfloat16"),
           "backbone": {"name": "tiny", **VISION}}
    cfg["model"] = {**cfg["model"], "nbit": 16, "nclass": 10,
                    "adapter_bottleneck_dim": 16,
                    "text_projection_dims": [32]}
    centers = np.zeros((10, 32), np.float32)
    jm = jmethods._build_concepthash(cfg, centers)
    pm = tmethods._build_concepthash(
        cfg, centers, device="cpu",
        vision=dict(attention_impl="pallas", fused_ln="pallas"))
    for f in dataclasses.fields(pm.cfg):
        if f.name != "self_attn_at_last":
            assert getattr(pm.cfg, f.name) == getattr(jm.cfg, f.name), f.name
    assert pm.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
    layer = pm.backbone.layers[0]
    assert layer.fused_ln == "pallas"
    assert layer.self_attn.attention_impl == "pallas"
    assert tmethods._compute_dtype({}) == torch.float32
    with pytest.raises(ValueError):
        tmethods._compute_dtype({"compute_dtype": "float16"})
