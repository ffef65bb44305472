"""One whole pre-LN encoder layer: the forward CUDA kernel of
``csrc/fused_layer.cu``, its plain PyTorch version and the autograd rule
that trains through it.

Counterpart of concepthash_tpu/ops/fused_layer.py (the Pallas
``_layer_kernel`` and its ``custom_vjp``). Two plain versions, each rounding
where its model rounds:

- ``layer_reference`` rounds where the kernel rounds (LN statistics in f32,
  activations cast to the compute dtype before each product, products
  accumulated in f32, the attention branch and the MLP branch kept in f32,
  x2 stored in the compute dtype): the forward on a CPU tensor, and what
  the kernel is checked against. In float32 it is the reference's XLA
  composition.
- ``layer_xla`` rounds where the reference's XLA composition ``_xla_layer``
  rounds (every product and bias add in the compute dtype, LN statistics
  and the softmax in f32 and cast back): the backward's recompute.

``encoder_layer`` takes the kernel for a CUDA tensor and ``layer_reference``
for a CPU tensor. When a gradient is asked for, it goes through
``EncoderLayerFn``, whose forward is that same dispatch and whose backward
recomputes the layer as ``layer_xla`` from the saved inputs and takes its
gradient, as the reference's ``_fused_bwd`` takes ``jax.vjp`` of
``_xla_layer``: nothing but the inputs is saved.

Weight matrices are in torch ``nn.Linear`` layout, (out_features,
in_features); the reference's flax kernels are the transposes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from concepthash_tpu_torch import _build

_ACTS = {"quick_gelu": 1, "gelu": 2}
_N_PTRS = 26
_MAX_SMEM = 232448   # a block's shared memory on the H100, in bytes
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_WIDTH = 2048    # D: a LayerNorm row is held in one warp's registers


class LayerWeights(NamedTuple):
    """One encoder layer's parameters; q|k|v concatenated."""

    ln1_scale: torch.Tensor  # (D,)
    ln1_bias: torch.Tensor   # (D,)
    w_qkv: torch.Tensor      # (3D, D)
    b_qkv: torch.Tensor      # (3D,)
    w_out: torch.Tensor      # (D, D)
    b_out: torch.Tensor      # (D,)
    ln2_scale: torch.Tensor  # (D,)
    ln2_bias: torch.Tensor   # (D,)
    w_fc1: torch.Tensor      # (F, D)
    b_fc1: torch.Tensor      # (F,)
    w_fc2: torch.Tensor      # (D, F)
    b_fc2: torch.Tensor      # (D,)

    def cast(self, dtype: torch.dtype) -> "LayerWeights":
        """Matrices in ``dtype``, vectors in float32, all contiguous — the
        form the kernel takes."""
        return LayerWeights(*(_cast(t, dtype) for t in self))


class AdapterWeights(NamedTuple):
    """Parallel bottleneck adapter (LN in -> down -> GELU -> up -> scale)."""

    ln_scale: torch.Tensor  # (D,)
    ln_bias: torch.Tensor   # (D,)
    w_down: torch.Tensor    # (A, D)
    b_down: torch.Tensor    # (A,)
    w_up: torch.Tensor      # (D, A)
    b_up: torch.Tensor      # (D,)
    scale: torch.Tensor     # (1,)

    def cast(self, dtype: torch.dtype) -> "AdapterWeights":
        return AdapterWeights(*(_cast(t, dtype) for t in self))


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (t.to(dtype) if t.dim() == 2 else t.to(torch.float32)).contiguous()


def _ln_f32(x, scale, bias, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """The encoder's MLP activation: quick_gelu (CLIP) or exact GELU."""
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(name)


def _mm(a, w, dt):
    """f32 product of ``a`` (already holding dt values) with w^T rounded to dt."""
    return a @ w.to(dt).float().t()


def _adapter_reference(h, a: AdapterWeights, dt):
    """The adapter on ``h`` (f32 tensor of dt values); returns f32."""
    rnd = lambda t: t.to(dt).float()
    z = rnd(_ln_f32(h, a.ln_scale, a.ln_bias, 1e-5))
    d = rnd(F.gelu(_mm(z, a.w_down, dt) + a.b_down.float()))
    u = _mm(d, a.w_up, dt) + a.b_up.float()
    return u * a.scale.float()


def layer_reference(x: torch.Tensor, w: LayerWeights,
                    adapter_attn: Optional[AdapterWeights] = None,
                    adapter_mlp: Optional[AdapterWeights] = None, *,
                    num_heads: int, eps: float = 1e-5,
                    act: str = "quick_gelu") -> torch.Tensor:
    """Plain PyTorch version of the layer kernel, rounding where it rounds:
    the forward on a CPU tensor and the kernel's check (the backward
    recomputes ``layer_xla`` instead). x: (B, L, D) in the compute dtype;
    returns (B, L, D) in that dtype."""
    B, L, D = x.shape
    H = num_heads
    hd = D // H
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    x32 = x.float()
    xn1 = rnd(_ln_f32(x32, w.ln1_scale, w.ln1_bias, eps))
    qkv = rnd(_mm(xn1, w.w_qkv, dt) + w.b_qkv.float())
    q, k, v = (t.reshape(B, L, H, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    logits = (q * hd ** -0.5) @ k.transpose(-1, -2)
    p = rnd(torch.softmax(logits, dim=-1))
    o = rnd(p @ v).transpose(1, 2).reshape(B, L, D)
    h_att = _mm(o, w.w_out, dt) + w.b_out.float()
    if adapter_attn is not None:
        h_att = h_att + _adapter_reference(rnd(h_att), adapter_attn, dt)
    x2 = x32 + h_att
    xn2 = rnd(_ln_f32(x2, w.ln2_scale, w.ln2_bias, eps))
    x2 = rnd(x2)
    h = rnd(activation(act, _mm(xn2, w.w_fc1, dt) + w.b_fc1.float()))
    branch = _mm(h, w.w_fc2, dt) + w.b_fc2.float()
    if adapter_mlp is not None:
        branch = branch + _adapter_reference(rnd(branch), adapter_mlp, dt)
    return (x2 + branch).to(dt)


def _adapter_xla(h, a: AdapterWeights, dt):
    """The adapter on ``h`` (dt) as the reference's ``_adapter_xla``."""
    z = _ln_f32(h.float(), a.ln_scale, a.ln_bias, 1e-5).to(dt)
    d = F.gelu(z @ a.w_down.to(dt).t() + a.b_down.to(dt))
    u = d @ a.w_up.to(dt).t() + a.b_up.to(dt)
    return u * a.scale.to(dt)


def layer_xla(x: torch.Tensor, w: LayerWeights,
              adapter_attn: Optional[AdapterWeights] = None,
              adapter_mlp: Optional[AdapterWeights] = None, *,
              num_heads: int, eps: float = 1e-5,
              act: str = "quick_gelu") -> torch.Tensor:
    """Plain PyTorch twin of the reference's ``_xla_layer`` (with
    ``_adapter_xla``), rounding where it rounds: biases cast to the compute
    dtype before each add, LN statistics and the softmax in f32 and cast
    back, every product and ``x2 = x + h`` in the compute dtype. The
    backward of ``EncoderLayerFn`` differentiates it; the forward follows
    the kernel instead (``layer_reference``). x: (B, L, D) in the compute
    dtype; returns (B, L, D) in that dtype."""
    B, L, D = x.shape
    H = num_heads
    hd = D // H
    dt = x.dtype
    xn1 = _ln_f32(x.float(), w.ln1_scale, w.ln1_bias, eps).to(dt)
    qkv = xn1 @ w.w_qkv.to(dt).t() + w.b_qkv.to(dt)
    q, k, v = (t.reshape(B, L, H, hd) for t in qkv.split(D, dim=-1))
    logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
    probs = torch.softmax(logits.float(), dim=-1).to(dt)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, D)
    h = o @ w.w_out.to(dt).t() + w.b_out.to(dt)
    if adapter_attn is not None:
        h = h + _adapter_xla(h, adapter_attn, dt)
    x2 = x + h
    xn2 = _ln_f32(x2.float(), w.ln2_scale, w.ln2_bias, eps).to(dt)
    h = activation(act, xn2 @ w.w_fc1.to(dt).t() + w.b_fc1.to(dt))
    h = h @ w.w_fc2.to(dt).t() + w.b_fc2.to(dt)
    if adapter_mlp is not None:
        h = h + _adapter_xla(h, adapter_mlp, dt)
    return x2 + h


def _forward(x, weights, adapter_attn, adapter_mlp, num_heads, eps, act):
    """The layer forward: the kernel for a CUDA tensor, ``layer_reference``
    for a CPU tensor."""
    if x.device.type == "cpu":
        return layer_reference(x, weights, adapter_attn, adapter_mlp,
                               num_heads=num_heads, eps=eps, act=act)
    return encoder_layer_cuda(x, weights, num_heads=num_heads, eps=eps,
                              act=act, adapter_attn=adapter_attn,
                              adapter_mlp=adapter_mlp)


_N_LAYER = len(LayerWeights._fields)
_N_ADAPTER = len(AdapterWeights._fields)


def _unflatten(tensors, has_attn: bool, has_mlp: bool) -> tuple:
    """(LayerWeights, adapter_attn or None, adapter_mlp or None) from the
    flat tensors ``EncoderLayerFn`` takes."""
    w = LayerWeights(*tensors[:_N_LAYER])
    rest = list(tensors[_N_LAYER:])
    a1 = AdapterWeights(*rest[:_N_ADAPTER]) if has_attn else None
    a2 = (AdapterWeights(*rest[_N_ADAPTER * has_attn:][:_N_ADAPTER])
          if has_mlp else None)
    return w, a1, a2


class EncoderLayerFn(torch.autograd.Function):
    """The layer with the kernel (on the CPU its plain version) as forward
    and the reference's recomputing backward (``_fused_bwd``). The weight
    and adapter tensors come flat after x, as ``LayerWeights.cast`` and
    ``AdapterWeights.cast`` give them, so that each gets its gradient (the
    f32 master parameters take theirs through those casts). Only x and the
    weights are saved; the backward recomputes the layer as ``layer_xla``
    and takes the gradients that ``ctx.needs_input_grad`` asks for (with a
    frozen tower, x's and the adapters'). The backward waits on nothing on
    the host, so a CUDA graph captures it."""

    @staticmethod
    def forward(ctx, x, num_heads: int, eps: float, act: str,
                has_attn: bool, has_mlp: bool, *tensors):
        ctx.save_for_backward(x, *tensors)
        ctx.layer = (num_heads, eps, act, has_attn, has_mlp)
        w, a1, a2 = _unflatten(tensors, has_attn, has_mlp)
        return _forward(x, w, a1, a2, num_heads, eps, act)

    @staticmethod
    def backward(ctx, g):
        num_heads, eps, act, has_attn, has_mlp = ctx.layer
        saved = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[6:])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, needs)]
            w, a1, a2 = _unflatten(leaves[1:], has_attn, has_mlp)
            y = layer_xla(leaves[0], w, a1, a2, num_heads=num_heads,
                          eps=eps, act=act)
            grads = iter(torch.autograd.grad(
                y, [t for t, n in zip(leaves, needs) if n], g))
        dx, *dtensors = (next(grads) if n else None for n in needs)
        return (dx, None, None, None, None, None, *dtensors)


def encoder_layer(x: torch.Tensor, weights: LayerWeights, *, num_heads: int,
                  eps: float = 1e-5, act: str = "quick_gelu",
                  adapter_attn: Optional[AdapterWeights] = None,
                  adapter_mlp: Optional[AdapterWeights] = None
                  ) -> torch.Tensor:
    """One full pre-LN encoder layer, x: (B, L, D) -> (B, L, D).

    A CUDA tensor goes through the kernel (``encoder_layer_cuda``), a CPU
    tensor through ``layer_reference``. With grad mode on and an input that
    requires a gradient, through ``EncoderLayerFn``, whose backward
    recomputes the layer. ``adapter_attn`` / ``adapter_mlp`` are the
    parallel adapters on the attention / MLP branch outputs."""
    tensors = (*weights, *(adapter_attn or ()), *(adapter_mlp or ()))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *tensors)):
        return EncoderLayerFn.apply(x, num_heads, float(eps), act,
                                    adapter_attn is not None,
                                    adapter_mlp is not None, *tensors)
    return _forward(x, weights, adapter_attn, adapter_mlp, num_heads, eps,
                    act)


def _lib():
    lib = _build.load("fused_layer")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.encoder_layer_fwd.argtypes = [
            vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float,
            ctypes.POINTER(vp), ci, ci, vp, vp]
        lib.encoder_layer_fwd.restype = ci
        lib.encoder_layer_workspace_bytes.argtypes = [ci, ci, ci, ci]
        lib.encoder_layer_workspace_bytes.restype = ctypes.c_size_t
        lib.encoder_layer_attention_smem_bytes.argtypes = [ci, ci]
        lib.encoder_layer_attention_smem_bytes.restype = ctypes.c_size_t
        lib.encoder_layer_error_string.argtypes = [ci]
        lib.encoder_layer_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def encoder_layer_cuda(x: torch.Tensor, weights: LayerWeights, *,
                       num_heads: int, eps: float = 1e-5,
                       act: str = "quick_gelu",
                       adapter_attn: Optional[AdapterWeights] = None,
                       adapter_mlp: Optional[AdapterWeights] = None
                       ) -> torch.Tensor:
    """Launch the layer kernel on x's stream. x: (B, L, D) bf16 on a CUDA
    device; weights and adapters as ``LayerWeights.cast(torch.bfloat16)``
    gives them. Raises on anything the kernel does not take, and if the
    build, a tensor-map encoding or a launch fails.
    ``encoder_layer_cuda.launches`` counts the calls of the C entry."""
    if x.device.type != "cuda":
        raise ValueError(f"encoder_layer_cuda needs a CUDA tensor, got {x.device}")
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    B, L, D = x.shape
    F_ = weights.w_fc1.shape[0]
    if D % num_heads or D % 8 or F_ % 8:
        raise ValueError(f"D={D} must divide by num_heads={num_heads} and 8, "
                         f"F={F_} by 8")
    if D > _MAX_WIDTH:
        raise ValueError(f"D={D} is wider than the kernel's LayerNorm rows "
                         f"({_MAX_WIDTH}, held in registers)")
    if D // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head width {D // num_heads} must be one of "
                         f"{_HEAD_DIMS} (the attention's mma tiles)")
    dev = x.device
    bf = torch.bfloat16
    f32 = torch.float32
    _check(x, "x", (B, L, D), bf, dev)
    shapes = [(D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,),
              (F_, D), (F_,), (D, F_), (D,)]
    ptrs = []
    for name, t, s in zip(LayerWeights._fields, weights, shapes):
        _check(t, name, s, bf if len(s) == 2 else f32, dev)
        ptrs.append(t.data_ptr())
    widths = []
    for tag, a in (("adapter_attn", adapter_attn), ("adapter_mlp", adapter_mlp)):
        if a is None:
            widths.append(0)
            ptrs += [0] * 7
            continue
        A = a.w_down.shape[0]
        if A % 8:
            raise ValueError(f"{tag} width {A} must divide by 8")
        for name, t, s in zip(AdapterWeights._fields, a,
                              [(D,), (D,), (A, D), (A,), (D, A), (D,), (1,)]):
            _check(t, f"{tag}.{name}", s, bf if len(s) == 2 else f32, dev)
            ptrs.append(t.data_ptr())
        widths.append(A)
    lib = _lib()
    smem = lib.encoder_layer_attention_smem_bytes(L, D // num_heads)
    if smem > _MAX_SMEM:
        raise ValueError(f"sequence length {L} needs {smem} bytes of shared "
                         f"memory for attention, more than {_MAX_SMEM}")
    out = torch.empty_like(x)
    ws = torch.empty(lib.encoder_layer_workspace_bytes(B * L, D, F_,
                                                       max(widths)),
                     dtype=torch.uint8, device=dev)
    table = (ctypes.c_void_p * _N_PTRS)(*ptrs)
    code = lib.encoder_layer_fwd(
        _build.ptr(x), _build.ptr(out), B, L, D, num_heads, F_, _ACTS[act],
        float(eps), table, widths[0], widths[1], _build.ptr(ws),
        _build.stream_ptr(dev))
    _build.check(code, lib.encoder_layer_error_string, "encoder_layer_fwd")
    encoder_layer_cuda.launches += 1
    return out


encoder_layer_cuda.launches = 0
