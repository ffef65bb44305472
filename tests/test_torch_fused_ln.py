"""The port's LayerNorm -> matmul (``ops/fused_ln.py``) against the JAX
package's ``ln_matmul``: the plain version (what the CPU runs in place of the
CUDA kernel) against the Pallas kernel in interpret mode, forward at f32 and
bf16 with tail row counts, and all five gradients of the recomputing
backward against ``jax.grad`` through the reference's ``_fused_bwd``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.ops.fused_ln import ln_matmul as jln_matmul
from concepthash_tpu.ops.fused_ln import resolve_fused_ln as jresolve
from concepthash_tpu_torch.ops import fused_ln as tln


def _inputs(seed, N, D, F):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32) * 2 + 0.5,
            (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            (rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.standard_normal(F)).astype(np.float32))


def _both(x, gamma, beta, w, bias, dtype, impl):
    """The JAX call (flax (D, F) kernel) and the port's (torch (F, D))."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jln_matmul(jnp.asarray(x, jdt), jnp.asarray(gamma),
                      jnp.asarray(beta), jnp.asarray(w, jdt),
                      jnp.asarray(bias), impl=impl)
    got = tln.ln_matmul(torch.tensor(x).to(dtype), torch.tensor(gamma),
                        torch.tensor(beta), torch.tensor(w.T).to(dtype),
                        torch.tensor(bias), impl=impl)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("N,D,F", [(16, 32, 64), (70, 32, 48),
                                   (3 * 41, 64, 192), (7, 64, 256)])
def test_forward_f32_matches_jax_kernel(N, D, F):
    """f32: atol 1e-5 (the same f32 arithmetic; sums in another order).
    N = 70, 123 and 7 leave a tail of the reference's row block."""
    got, want = _both(*_inputs(N, N, D, F), torch.float32, "pallas")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("N,D,F", [(70, 32, 48), (3 * 41, 64, 192)])
def test_forward_bf16_matches_jax_kernel(N, D, F):
    """bf16: both round x_hat*gamma+beta and the output to bf16 at the same
    points, so they differ by at most one bf16 ulp of the output
    (|d| <= 2^-7 |ref| + 2^-9)."""
    got, want = _both(*_inputs(N + 1, N, D, F), torch.bfloat16, "pallas")
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -9)


def test_xla_impl_matches_jax():
    """impl='xla': the plain composition, LN cast to x's dtype then the
    product, as the reference's non-Pallas branch (f32, atol 1e-5)."""
    got, want = _both(*_inputs(3, 37, 32, 40), torch.float32, "xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_three_d_input_keeps_lead_dims():
    x, gamma, beta, w, bias = _inputs(4, 2 * 7, 32, 16)
    x3 = x.reshape(2, 7, 32)
    got = tln.ln_matmul(torch.tensor(x3), torch.tensor(gamma),
                        torch.tensor(beta), torch.tensor(w.T),
                        torch.tensor(bias), impl="pallas")
    want = jln_matmul(jnp.asarray(x3), jnp.asarray(gamma), jnp.asarray(beta),
                      jnp.asarray(w), jnp.asarray(bias), impl="pallas")
    assert tuple(got.shape) == (2, 7, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_gradients_match_jax_custom_vjp():
    """All five gradients (x, gamma, beta, w, bias) of sum(y * t) through
    ``LnMatmul.backward`` against ``jax.grad`` through the reference's
    ``_fused_bwd``, f32, atol 1e-4; then only dx when the weights need no
    gradient (a frozen backbone)."""
    x, gamma, beta, w, bias = _inputs(5, 70, 32, 24)
    t = np.random.default_rng(6).standard_normal((70, 24)).astype(np.float32)

    def jloss(*a):
        return (jln_matmul(*a, impl="pallas") * t).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, gamma, beta, w, bias)))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (x, gamma, beta, w.T.copy(), bias)]
    (tln.ln_matmul(*leaves, impl="pallas") * torch.tensor(t)).sum().backward()
    for name, leaf, ref in zip(("x", "gamma", "beta", "w", "bias"), leaves,
                               want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(leaf.grad.numpy(),
                                   ref.T if name == "w" else ref,
                                   rtol=0, atol=1e-4, err_msg=name)

    xo = torch.tensor(x, requires_grad=True)
    frozen = [torch.tensor(a) for a in (gamma, beta, w.T.copy(), bias)]
    (tln.ln_matmul(xo, *frozen, impl="pallas") * torch.tensor(t)).sum(
    ).backward()
    np.testing.assert_allclose(xo.grad.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-4)
    assert all(f.grad is None for f in frozen)


@pytest.mark.parametrize("impl", ["pallas", "pallas_mlp", "xla", "auto"])
def test_resolve_matches_reference(impl):
    assert tln.resolve_fused_ln(impl) == jresolve(impl, 128)


def test_cuda_wrapper_refuses_cpu_tensors():
    x, gamma, beta, w, bias = (torch.tensor(a) for a in _inputs(7, 8, 32, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tln.ln_matmul_cuda(x.to(torch.bfloat16), gamma, beta,
                           w.t().to(torch.bfloat16), bias)
