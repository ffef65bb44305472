"""The port's ``CosSim`` against the JAX package's on the CPU, for each of
its options (``group``, ``single_quan``, ``input_group``, and the plain and
sign-centroid heads beside them): the logits and the gradient of a weighted
sum of them for the input and the centroids, float32 within 1e-5, and the
logits at a bfloat16 compute dtype within 1e-2 (the centroids are cast to
it before they are normalized, on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.models.layers import CosSim as JCosSim
from concepthash_tpu_torch.models.layers import CosSim

NFEAT, NCLASS, B = 16, 5, 6
TOL = 1e-5
BF16_TOL = 1e-2

CASES = [dict(group=4), dict(group=2, single_quan=True),
         dict(input_group=4), dict(input_group=4, group=2),
         dict(group=4, single_quan=True, sign_centroids=True), dict(),
         dict(sign_centroids=True)]
IDS = ["group", "single_quan", "input_group", "input_group_and_group",
       "single_quan_sign_centroids", "plain", "sign_centroids"]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, NFEAT)).astype(np.float32),
            rng.standard_normal((NCLASS, NFEAT)).astype(np.float32),
            rng.standard_normal((B, NCLASS)).astype(np.float32))


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_matches_jax_forward_and_gradient(kw):
    kw = dict(kw)
    sign_c = kw.pop("sign_centroids", False)
    x, cent, wts = _inputs(5)
    jlayer = JCosSim(nfeat=NFEAT, nclass=NCLASS, **kw)
    params = {"params": {"centroids": jnp.asarray(cent)}}

    def jloss(x_, c_):
        logits = jlayer.apply({"params": {"centroids": c_}}, x_,
                              sign_centroids=sign_c)
        return (logits * wts).sum(), logits

    (_, want), (gx_j, gc_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), params["params"]["centroids"])

    layer = CosSim(NFEAT, NCLASS, codebook=cent, **kw)
    tx = torch.tensor(x, requires_grad=True)
    got = layer(tx, sign_centroids=sign_c)
    (got * torch.tensor(wts)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == (B, NCLASS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(layer.centroids.grad.numpy(),
                               np.asarray(gc_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", CASES[:4], ids=IDS[:4])
def test_matches_jax_at_bfloat16(kw):
    x, cent, _ = _inputs(6)
    jlayer = JCosSim(nfeat=NFEAT, nclass=NCLASS, dtype=jnp.bfloat16, **kw)
    want = jlayer.apply({"params": {"centroids": jnp.asarray(cent)}},
                        jnp.asarray(x).astype(jnp.bfloat16))
    layer = CosSim(NFEAT, NCLASS, torch.bfloat16, codebook=cent, **kw)
    with torch.no_grad():
        got = layer(torch.tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
