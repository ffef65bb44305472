"""Full-row softmax attention: the CUDA kernel of ``csrc/attention.cu``, its
plain PyTorch version, the autograd rule and the dispatch (counterpart of
concepthash_tpu/ops/attention.py, whose Pallas kernel is ``_attn_kernel``).

``attention(q, k, v, impl="pallas")`` goes through ``fused_attention``: the
kernel for CUDA tensors, the plain version ``attention_reference`` for CPU
tensors, and a backward that recomputes the probabilities in plain PyTorch,
as the reference's ``_fused_bwd`` does in XLA. 'xla' and 'auto' take the
einsum composition, which rounds q·scale and the probabilities to the
compute dtype (the kernel path stays in f32 from the loaded values to the
output).

q, k, v are (B, L, H, hd), the reference's layout; the kernel reads them
through their strides, so views of one (B, L, 3D) q|k|v tensor go in as they
are.
"""

from __future__ import annotations

import ctypes

import torch

from concepthash_tpu_torch import _build

_MAX_SMEM = 232448   # a block's shared memory on the H100, in bytes


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: f32 from the loaded values (logits of
    q·scale against k, whole-row softmax, P·V), cast to q's dtype at the
    end."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _lib():
    lib = _build.load("attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.attention_fwd.argtypes = [vp, vp, vp,
                                      ctypes.POINTER(ctypes.c_longlong), vp,
                                      ci, ci, ci, ci, ctypes.c_float, vp]
        lib.attention_fwd.restype = ci
        lib.attention_smem_bytes.argtypes = [ci, ci]
        lib.attention_smem_bytes.restype = ctypes.c_size_t
        lib.attention_error_string.argtypes = [ci]
        lib.attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


_HEAD_WIDTHS = (16, 32, 64, 128)


def _smem_bytes(L: int, hd: int) -> int:
    """Shared memory of one block of the kernel (``smem_bytes`` of
    csrc/attention_sm90.cuh): q rows padded to 16, k and v rows to 64, each
    row hd + 8 bf16."""
    return (-(-L // 16) * 16 + 2 * (-(-L // 64) * 64)) * (hd + 8) * 2


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> tuple:
    """The input checks of ``attention_cuda``, on any device: q, k, v are
    (B, L, H, hd) bf16 on one device, hd in {16, 32, 64, 128}, unit stride
    along hd, batch, token and head strides multiples of 8 elements and
    16-byte aligned bases (the kernel stages rows with 16-byte loads), and
    L small enough that a block's shared memory fits the H100's 227 KB
    (L <= 512 at hd 64, 256 at hd 128). Returns (B, L, H, hd); raises
    TypeError or ValueError on anything the kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, L, H, hd), got {tuple(q.shape)}")
    B, L, H, hd = q.shape
    if hd not in _HEAD_WIDTHS:
        raise ValueError(f"the attention kernel takes head widths "
                         f"{_HEAD_WIDTHS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be torch.bfloat16, got {t.dtype}")
        if tuple(t.shape) != (B, L, H, hd):
            raise ValueError(f"{name} must have shape {(B, L, H, hd)}, got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along hd")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs batch, token and head strides "
                             f"that are multiples of 8 elements and a "
                             f"16-byte aligned start, got strides "
                             f"{t.stride()}")
    smem = _smem_bytes(L, hd)
    if smem > _MAX_SMEM:
        raise ValueError(f"sequence length {L} at head width {hd} needs {smem}"
                         f" bytes of shared memory, more than {_MAX_SMEM}")
    return B, L, H, hd


def attention_cuda(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on q's stream. q, k, v: (B, L, H, hd) bf16 on one
    CUDA device, as ``check_kernel_inputs`` takes them. Returns
    (B, L, H, hd) bf16 contiguous. Raises on anything the kernel does not
    take, and if the build or the launch fails.
    ``attention_cuda.launches`` counts the launches."""
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda needs CUDA tensors, got {q.device}")
    B, L, H, hd = check_kernel_inputs(q, k, v)
    out = torch.empty((B, L, H, hd), dtype=torch.bfloat16, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in t.stride()[:3]))
    code = lib.attention_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), strides, _build.ptr(out),
        B, L, H, hd, float(hd ** -0.5), _build.stream_ptr(q.device))
    _build.check(code, lib.attention_error_string, "attention_fwd")
    attention_cuda.launches += 1
    return out


attention_cuda.launches = 0


def _forward(q, k, v):
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    return attention_cuda(q, k, v)


class FusedAttention(torch.autograd.Function):
    """Attention with the kernel (or, on the CPU, its plain version) as
    forward and the reference's rematerializing backward: q, k, v are saved,
    the f32 probabilities recomputed."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
        p = torch.softmax(s, dim=-1)
        gf = g.float()
        dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, L, H, hd) -> (B, L, H, hd): the kernel's forward (softmax
    in f32, no probability tensor in device memory) with the recomputing
    backward."""
    return FusedAttention.apply(q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """Dispatcher: 'pallas' (the kernel) | 'xla' | 'auto' (the einsum path,
    as in the reference, whose 'auto' resolves to XLA)."""
    if impl == "pallas":
        return fused_attention(q, k, v)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
