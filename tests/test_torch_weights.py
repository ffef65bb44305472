"""Weights carried from the JAX package into the PyTorch port (``from_flax``)
and the port's small modules against their JAX counterparts: every
variable lands in the port's state dict with the right shape, and the
modules fed those weights compute the reference's function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.data import preprocess as jpre
from concepthash_tpu.models import clip as jclip
from concepthash_tpu.models.concepthash import (ConceptHash as JConceptHash,
                                                ConceptHashConfig as JCfg,
                                                HashQueryBlock as JHashBlock)
from concepthash_tpu.ops.numerics import l2_normalize as jl2
from concepthash_tpu_torch.data import preprocess as tpre
from concepthash_tpu_torch.models import clip as tclip
from concepthash_tpu_torch.models.concepthash import (ConceptHash,
                                                      ConceptHashConfig,
                                                      HashQueryBlock)
from concepthash_tpu_torch.ops.numerics import l2_normalize as tl2
from concepthash_tpu_torch.weights import from_flax

VISION = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
              image_size=32, patch_size=8, projection_dim=32)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("head", [
    dict(nbit=64, nclass=10, ncontext=4, center_dim=32,
         text_projection_dims=(32,)),
    dict(nbit=32, nclass=7, ncontext=4, center_dim=16,
         text_projection_dims=(16, 24), hash_pe=False, concept_cossim=False),
    dict(nbit=16, nclass=5, ncontext=2, learnable_center=True, nregs=1,
         add_bn=False),
])
def test_from_flax_fills_the_port_state_dict(head):
    """Every port parameter and buffer comes from the JAX variables, with
    the port's shape, and strict loading succeeds."""
    center = (None if head.get("learnable_center") else
              jnp.zeros((head["nclass"], head["center_dim"])))
    jm = JConceptHash(jclip.ClipVisionConfig(**VISION), JCfg(**head),
                      adapters=jclip.AdapterConfig(bottleneck_dim=32),
                      fixed_center=center)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    pm = ConceptHash(tclip.ClipVisionConfig(**VISION),
                     ConceptHashConfig(**head),
                     tclip.AdapterConfig(bottleneck_dim=32), device="cpu")
    sd = from_flax(v)
    want = pm.state_dict()
    assert set(sd) == set(want)
    for k, t in want.items():
        assert sd[k].shape == t.shape, k
    pm.load_state_dict(sd, strict=True)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(v))
    assert n_jax == sum(t.numel() for t in sd.values())
    q = v["params"]["backbone"]["layers_1"]["self_attn"]
    np.testing.assert_array_equal(
        sd["backbone.layers.1.self_attn.qkv_proj.weight"][64:128].numpy(),
        q["k_proj"]["kernel"].T)


def test_hash_query_block_matches(rng):
    """flax MultiHeadDotProductAttention's (D, H, hd) kernels map onto the
    port's Linear layers; LayerNorm eps 1e-6."""
    jb = JHashBlock(32, 64, 8, 0.1)
    x = rng.standard_normal((1, 5, 32)).astype(np.float32)
    p = _np_tree(jb.init(jax.random.PRNGKey(2), jnp.asarray(x), False))
    p = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), p)
    want = jb.apply(p, jnp.asarray(x), False)
    from concepthash_tpu_torch.weights import _hash_query_block

    sd = {}
    _hash_query_block(sd, "b", p["params"])
    tb = HashQueryBlock(32, 64, 8)
    tb.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = tb(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_resize_position_embedding_matches(rng):
    pos = rng.standard_normal((50, 16)).astype(np.float32)   # 7x7 + cls
    for n in (49, 16 * 16, 4 * 4):
        want = jclip.resize_position_embedding(jnp.asarray(pos), n)
        got = tclip.resize_position_embedding(torch.tensor(pos), n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_preprocess_and_l2_normalize_match(rng):
    imgs = rng.integers(0, 256, (2, 40, 36, 3)).astype(np.uint8)
    for norm in (0, 1, 2, 3):
        np.testing.assert_allclose(
            tpre.normalize(torch.tensor(imgs), norm).numpy(),
            np.asarray(jpre.normalize(jnp.asarray(imgs), norm)), rtol=0,
            atol=1e-6)
    np.testing.assert_array_equal(
        tpre.center_crop(torch.tensor(imgs), 32).numpy(),
        np.asarray(jpre.center_crop(jnp.asarray(imgs), 32)))
    x = rng.standard_normal((3, 8)).astype(np.float32)
    x[0] = 0.0
    np.testing.assert_allclose(tl2(torch.tensor(x)).numpy(),
                               np.asarray(jl2(jnp.asarray(x))), rtol=0,
                               atol=1e-6)
    z = torch.zeros(4, requires_grad=True)
    tl2(z).sum().backward()
    assert torch.isfinite(z.grad).all()
