"""LayerNorm -> matmul in one pass: the CUDA kernel of ``csrc/fused_ln.cu``,
its plain PyTorch version, the autograd rule and the dispatch (counterpart of
concepthash_tpu/ops/fused_ln.py, whose Pallas kernel is
``_ln_matmul_kernel``).

``ln_matmul(..., impl="pallas")`` computes ``LN(x) @ W^T + b`` through
``LnMatmul``: its forward is the kernel for a CUDA tensor and the plain
version ``ln_matmul_reference`` for a CPU tensor; its backward recomputes the
normalization from x in plain PyTorch, as the reference's ``_fused_bwd``
does in XLA (the reference has no backward kernel either). Other ``impl``
values take the plain LayerNorm-then-Linear composition.

Weights are in torch ``nn.Linear`` layout, (F, D); the reference's flax
kernels are the transposes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from concepthash_tpu_torch import _build
from concepthash_tpu_torch.ops.fused_layer import _check, _ln_f32


def resolve_fused_ln(impl: str) -> bool:
    """Whether ``impl`` takes the fused kernel: 'pallas' (LN1 -> q|k|v and
    LN2 -> fc1) and 'pallas_mlp' (LN2 -> fc1 only) do; 'xla' and 'auto' use
    the plain composition, as in the reference. ("pallas" names the
    hand-written CUDA kernel here, so that a config means the same in both
    packages.)"""
    return impl in ("pallas", "pallas_mlp")


def ln_matmul_reference(x2: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the kernel, rounding where it rounds: row statistics
    and ``x_hat * gamma + beta`` in f32, rounded to w's dtype; the product
    accumulated in f32, plus the f32 bias, cast to x's dtype.
    x2: (N, D); w: (F, D); returns (N, F)."""
    xn = _ln_f32(x2.float(), gamma, beta, eps).to(w.dtype).float()
    return (xn @ w.float().t() + bias.float()).to(x2.dtype)


def _lib():
    lib = _build.load("fused_ln")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ln_matmul_fwd.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                      ctypes.c_float, vp, vp]
        lib.ln_matmul_fwd.restype = ci
        lib.ln_matmul_error_string.argtypes = [ci]
        lib.ln_matmul_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def ln_matmul_cuda(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on x2's stream. x2: (N, D) bf16 contiguous on a CUDA
    device, D % 8 == 0; gamma, beta: (D,) f32; w: (F, D) bf16; bias: (F,)
    f32. Raises on anything the kernel does not take, and if the build, the
    tensor-map encoding or the launch fails. ``ln_matmul_cuda.launches``
    counts the launches (one C entry: the row statistics and the GEMM)."""
    if x2.device.type != "cuda":
        raise ValueError(f"ln_matmul_cuda needs a CUDA tensor, got {x2.device}")
    if x2.dim() != 2:
        raise ValueError(f"x2 must be (N, D), got {tuple(x2.shape)}")
    N, D = x2.shape
    F_ = w.shape[0]
    if D % 8:
        raise ValueError(f"D={D} must divide by 8")
    dev = x2.device
    bf, f32 = torch.bfloat16, torch.float32
    _check(x2, "x", (N, D), bf, dev)
    _check(gamma, "gamma", (D,), f32, dev)
    _check(beta, "beta", (D,), f32, dev)
    _check(w, "w", (F_, D), bf, dev)
    _check(bias, "bias", (F_,), f32, dev)
    out = torch.empty((N, F_), dtype=bf, device=dev)
    if N == 0 or F_ == 0:
        return out
    lib = _lib()
    stats = torch.empty((N, 2), dtype=f32, device=dev)   # (mu, rstd) per row
    code = lib.ln_matmul_fwd(
        _build.ptr(x2), _build.ptr(gamma), _build.ptr(beta), _build.ptr(w),
        _build.ptr(bias), _build.ptr(out), N, D, F_, float(eps),
        _build.ptr(stats), _build.stream_ptr(dev))
    _build.check(code, lib.ln_matmul_error_string, "ln_matmul_fwd")
    ln_matmul_cuda.launches += 1
    return out


ln_matmul_cuda.launches = 0


def _forward(x2, gamma, beta, w, bias, eps):
    if x2.device.type == "cpu":
        return ln_matmul_reference(x2, gamma, beta, w, bias, eps)
    return ln_matmul_cuda(x2, gamma, beta, w, bias, eps)


class LnMatmul(torch.autograd.Function):
    """``LN(x2) @ w^T + bias`` with the kernel (or, on the CPU, its plain
    version) as forward and the reference's recomputing backward
    (``_fused_bwd``): nothing but x2 and the weights is saved, and only the
    gradients that ``ctx.needs_input_grad`` asks for are computed (with a
    frozen backbone, only dx)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w, bias, eps: float):
        ctx.save_for_backward(x2, gamma, beta, w)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return _forward(x2, gamma, beta, w, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x2, gamma, beta, w = ctx.saved_tensors
        need_x, need_g, need_b, need_w, need_bias = ctx.needs_input_grad[:5]
        xf = x2.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + ctx.eps)
        xhat = (xf - mu) * inv                       # pre-affine normalized
        gf = g.float()
        dx = dgamma = dbeta = dw = dbias = None
        if need_w:
            y = xhat * gamma.float() + beta.float()
            dw = (gf.t() @ y).to(w.dtype)
        if need_bias:
            dbias = gf.sum(dim=0).to(ctx.bias_dtype)
        if need_x or need_g or need_b:
            dy = gf @ w.float()
            if need_g:
                dgamma = (dy * xhat).sum(dim=0).to(gamma.dtype)
            if need_b:
                dbeta = dy.sum(dim=0).to(beta.dtype)
            if need_x:
                D = x2.shape[-1]
                dxhat = dy * gamma.float()
                dx = (inv / D * (D * dxhat - dxhat.sum(dim=-1, keepdim=True)
                                 - xhat * (dxhat * xhat).sum(dim=-1,
                                                             keepdim=True))
                      ).to(x2.dtype)
        return dx, dgamma, dbeta, dw, dbias, None


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-5,
              impl: str = "auto") -> torch.Tensor:
    """``LayerNorm(x; gamma, beta) @ w^T + bias`` over the last dim of x.

    x: (..., D); w: (F, D); returns (..., F) in x's dtype. impl 'pallas'
    takes ``LnMatmul`` (the kernel on the card); 'xla' and 'auto' the plain
    composition: the f32 LayerNorm cast to x's dtype, then a Linear in x's
    dtype, as the reference's non-Pallas branch."""
    lead = x.shape[:-1]
    D = x.shape[-1]
    if impl != "pallas":
        xn = _ln_f32(x.float(), gamma, beta, eps).to(x.dtype)
        return F.linear(xn, w.to(x.dtype), bias.to(x.dtype))
    out = LnMatmul.apply(x.reshape(-1, D), gamma, beta, w, bias, float(eps))
    return out.reshape(*lead, w.shape[0])
