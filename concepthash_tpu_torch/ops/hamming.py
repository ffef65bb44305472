"""Bit-packed Hamming distance (counterpart of concepthash_tpu/ops/hamming.py).

Words hold 32 code bits each. torch has no uint32 arithmetic on every CUDA
op, so a word is an int32 tensor element carrying the uint32 bit pattern
(bit 31 set reads as a negative int32); the arithmetic runs in int64.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def pack_bits(codes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Pack real-valued codes (..., nbit) into words (..., ceil(nbit/32)),
    int32 holding the uint32 pattern. Bit j of word w is set iff
    ``codes[..., 32*w + j] > threshold`` (0 counts as negative, the
    reference's torch.sign convention)."""
    nbit = codes.shape[-1]
    nwords = -(-nbit // 32)
    bits = (codes > threshold).to(torch.int64)
    pad = nwords * 32 - nbit
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], nwords, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=codes.device)
    words = (bits << shifts).sum(dim=-1)
    return _as_int32(words)


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (an int32 tensor), as int64."""
    v = words.to(torch.int64) & _M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def hamming_packed(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distance between packed codes: q (Q, L), db (N, L)
    words -> (Q, N) int32."""
    x = torch.bitwise_xor(q[:, None, :], db[None, :, :])
    return popcount32(x).sum(dim=-1).to(torch.int32)
