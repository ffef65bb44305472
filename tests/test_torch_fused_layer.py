"""The encoder-layer kernel of the PyTorch port: its plain version against the
JAX package's XLA composition and its Pallas kernel in interpret mode (f32,
atol 1e-5) and the CPU dispatch of the wrapper. The CUDA kernel against the
plain version is in test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import concepthash_tpu.ops.fused_layer as jfl
import concepthash_tpu_torch.ops.fused_layer as tfl

B, L, D, H, F, A = 2, 21, 64, 4, 128, 32   # L = 16 patches + cls + 4 concepts


def _layer_np(rng, D, F):
    """flax-layout (in, out) layer weights."""
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(
        ln1_scale=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        ln1_bias=r(D), w_qkv=r(D, 3 * D), b_qkv=r(3 * D), w_out=r(D, D),
        b_out=r(D),
        ln2_scale=(1 - 0.1 * rng.standard_normal(D)).astype(np.float32),
        ln2_bias=r(D), w_fc1=r(D, F), b_fc1=r(F), w_fc2=r(F, D), b_fc2=r(D))


def _adapter_np(rng, D, A):
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(ln_scale=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
                ln_bias=r(D), w_down=r(D, A), b_down=r(A), w_up=r(A, D),
                b_up=r(D), scale=np.array([0.7], np.float32))


def _jax(cls, d):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch(cls, d, dtype=torch.float32, device="cpu"):
    """The port's (out, in) layout: matrices transposed."""
    return cls(**{k: torch.tensor(v.T.copy() if v.ndim == 2 else v,
                                  device=device) for k, v in d.items()}
               ).cast(dtype)


def _case(rng, adapters):
    w = _layer_np(rng, D, F)
    a1 = _adapter_np(rng, D, A) if adapters in ("attn", "both") else None
    a2 = _adapter_np(rng, D, A) if adapters in ("mlp", "both") else None
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    return x, w, a1, a2


def _run_port(fn, x, w, a1, a2, act):
    return fn(torch.tensor(x), _torch(tfl.LayerWeights, w), num_heads=H,
              eps=1e-5, act=act,
              adapter_attn=a1 and _torch(tfl.AdapterWeights, a1),
              adapter_mlp=a2 and _torch(tfl.AdapterWeights, a2)).numpy()


@pytest.mark.parametrize("adapters", ["none", "attn", "mlp", "both"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_plain_matches_xla_layer(rng, adapters, act):
    x, w, a1, a2 = _case(rng, adapters)
    want = jfl._xla_layer(jnp.asarray(x), _jax(jfl.LayerWeights, w),
                          a1 and _jax(jfl.AdapterWeights, a1),
                          a2 and _jax(jfl.AdapterWeights, a2),
                          num_heads=H, eps=1e-5, act=act)
    got = _run_port(tfl.layer_reference, x, w, a1, a2, act)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("adapters", ["none", "both"])
def test_plain_matches_interpret_kernel(rng, adapters):
    """Against the Pallas kernel itself (interpret mode), whose L=21 is
    padded to 24 with masked key columns; the port masks by L."""
    x, w, a1, a2 = _case(rng, adapters)
    want = jfl.encoder_layer(jnp.asarray(x), _jax(jfl.LayerWeights, w),
                             num_heads=H, eps=1e-5, act="quick_gelu",
                             adapter_attn=a1 and _jax(jfl.AdapterWeights, a1),
                             adapter_mlp=a2 and _jax(jfl.AdapterWeights, a2),
                             impl="pallas_layer", interpret=True)
    got = _run_port(tfl.encoder_layer, x, w, a1, a2, "quick_gelu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_plain_rounds_where_the_kernel_rounds(rng):
    """In bf16 the plain version stores x2 in bf16 before the final sum: the
    output equals bf16(bf16(x2) + branch) recomputed by hand."""
    x, w, a1, a2 = _case(rng, "none")
    xb = torch.tensor(x).to(torch.bfloat16)
    lw = _torch(tfl.LayerWeights, w, torch.bfloat16)
    out = tfl.layer_reference(xb, lw, num_heads=H)
    assert out.dtype == torch.bfloat16 and out.shape == (B, L, D)
    f32 = tfl.layer_reference(xb.float(), _torch(tfl.LayerWeights, w),
                              num_heads=H)
    # bf16 rounding of every intermediate stays within a few bf16 ulps
    np.testing.assert_allclose(out.float().numpy(), f32.numpy(), rtol=0.02,
                               atol=0.05)


def test_cpu_tensor_takes_plain_version(rng):
    x, w, a1, a2 = _case(rng, "both")
    before = tfl.encoder_layer_cuda.launches
    got = _run_port(tfl.encoder_layer, x, w, a1, a2, "quick_gelu")
    want = _run_port(tfl.layer_reference, x, w, a1, a2, "quick_gelu")
    np.testing.assert_array_equal(got, want)
    assert tfl.encoder_layer_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    x, w, _, _ = _case(rng, "none")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfl.encoder_layer_cuda(torch.tensor(x).to(torch.bfloat16),
                               _torch(tfl.LayerWeights, w, torch.bfloat16),
                               num_heads=H)

