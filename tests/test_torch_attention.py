"""The port's attention (``ops/attention.py``) against the JAX package's:
the plain version (what the CPU runs in place of the CUDA kernel) against
the Pallas kernel in interpret mode (``fused_attention(interpret=True)``) at
L = 16 and 54, forward and the gradients of the recomputing backward; the
einsum path against the reference's 'xla' path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.ops.attention import attention as jattention
from concepthash_tpu.ops.attention import fused_attention as jfused
from concepthash_tpu_torch.ops import attention as tat


def _qkv(seed, B, L, H, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("L", [16, 54])
def test_forward_f32_matches_jax_kernel(L):
    """f32: atol 1e-5 (the same f32 arithmetic; sums in another order)."""
    q, k, v = _qkv(L, 2, L, 4, 16)
    want = jfused(*(jnp.asarray(a) for a in (q, k, v)), interpret=True)
    got = tat.attention(*(torch.tensor(a) for a in (q, k, v)), impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("L", [16, 54])
def test_forward_bf16_matches_jax_kernel(L):
    """bf16 in and out, f32 inside on both sides: one rounding at the
    output, so at most one bf16 ulp apart (|d| <= 2^-7 |ref| + 2^-9)."""
    q, k, v = _qkv(L + 1, 2, L, 4, 16)
    want = jfused(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  interpret=True)
    got = tat.attention(*(torch.tensor(a).to(torch.bfloat16)
                          for a in (q, k, v)), impl="pallas")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -9)


@pytest.mark.parametrize("L", [16, 54])
def test_gradients_match_jax_custom_vjp(L):
    """dq, dk, dv of sum(out * t) through ``FusedAttention.backward`` against
    ``jax.grad`` through the reference's ``_fused_bwd``, f32, atol 1e-5."""
    q, k, v = _qkv(L + 2, 2, L, 4, 16)
    t = np.random.default_rng(L).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda *a: (jfused(*a, interpret=True) * t).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (tat.attention(*leaves, impl="pallas") * torch.tensor(t)).sum().backward()
    for name, leaf, ref in zip("qkv", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_strided_views_of_one_qkv_tensor():
    """q, k, v as views of one (B, L, 3D) tensor (the layout the model hands
    the kernel) give the result of contiguous copies."""
    B, L, H, hd = 2, 41, 4, 16
    qkv = torch.tensor(np.random.default_rng(9).standard_normal(
        (B, L, 3 * H * hd)).astype(np.float32))
    views = [t.reshape(B, L, H, hd) for t in qkv.split(H * hd, dim=-1)]
    assert not views[0].is_contiguous()
    got = tat.attention(*views, impl="pallas")
    want = tat.attention(*(t.contiguous() for t in views), impl="pallas")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xla_path_matches_jax(dtype):
    """impl='xla' rounds q*scale and the probabilities to the compute dtype,
    as the reference's einsum path: f32 atol 1e-5, bf16 within two bf16
    ulps (the probabilities and the output both round)."""
    q, k, v = _qkv(3, 2, 21, 4, 16)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jattention(*(jnp.asarray(a, jdt) for a in (q, k, v)), impl="xla")
    got = tat.attention(*(torch.tensor(a).to(dtype) for a in (q, k, v)),
                        impl="xla")
    tol = (dict(rtol=0, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -6, atol=2 ** -8))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tat.attention_cuda(q, q, q)


def _bf16_views(B, L, H, hd):
    qkv = torch.zeros(B, L, 3 * H * hd, dtype=torch.bfloat16)
    return [t.reshape(B, L, H, hd) for t in qkv.split(H * hd, dim=-1)]


@pytest.mark.parametrize("B,L,H,hd", [(32, 54, 12, 64), (2, 197, 12, 64),
                                      (3, 41, 4, 32), (2, 16, 4, 128),
                                      (1, 512, 2, 64), (1, 256, 2, 128)])
def test_kernel_input_checks_take_kernel_shapes(B, L, H, hd):
    """The wrapper's checks, run here without a card, pass strided views of
    one q|k|v tensor at every head width the kernel takes, up to the
    longest L its shared memory holds."""
    assert tat.check_kernel_inputs(*_bf16_views(B, L, H, hd)) == (B, L, H, hd)


@pytest.mark.parametrize("case", ["hd8", "hd48", "hd256", "long64", "long128",
                                  "f32", "shape", "hd_stride", "odd_stride",
                                  "rank"])
def test_kernel_input_checks_refuse_what_the_kernel_cannot_take(case):
    """Head widths outside {16, 32, 64, 128}, rows that do not fit a block's
    shared memory (L = 513 at hd 64, 257 at hd 128), another dtype,
    mismatched shapes, a non-unit hd stride, strides that break the 16-byte
    row loads, and a tensor that is not 4-D raise before any launch."""
    err = ValueError
    if case.startswith("hd") and case != "hd_stride":
        args = _bf16_views(2, 16, 2, int(case[2:]))
    elif case == "long64":
        args = _bf16_views(1, 513, 2, 64)
    elif case == "long128":
        args = _bf16_views(1, 257, 2, 128)
    elif case == "f32":
        q, k, v = _bf16_views(2, 16, 2, 16)
        args, err = (q.float(), k, v), TypeError
    elif case == "shape":
        q, k, v = _bf16_views(2, 16, 2, 16)
        args = (q, k[:, :8], v)
    elif case == "hd_stride":
        args = [t.transpose(-1, -2) for t in _bf16_views(2, 16, 16, 16)]
    elif case == "odd_stride":
        x = torch.zeros(2, 16, 2, 20, dtype=torch.bfloat16)[..., :16]
        args = (x, x, x)
    else:
        q = torch.zeros(2, 16, 32, dtype=torch.bfloat16)
        args = (q, q, q)
    with pytest.raises(err):
        tat.check_kernel_inputs(*args)
