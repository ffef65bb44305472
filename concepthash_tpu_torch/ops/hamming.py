"""Bit-packed Hamming distance (counterpart of concepthash_tpu/ops/hamming.py).

Words hold 32 code bits each. torch has no uint32 arithmetic on every CUDA
op, so a word is an int32 tensor element carrying the uint32 bit pattern
(bit 31 set reads as a negative int32); the arithmetic runs in int64.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def pack_bits(codes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Pack real-valued codes (..., nbit) into words (..., ceil(nbit/32)),
    int32 holding the uint32 pattern. Bit j of word w is set iff
    ``codes[..., 32*w + j] > threshold`` (0 counts as negative, the
    reference's torch.sign convention). Packs a byte at a time in uint8 and
    int32, so its largest temporary holds one byte per code bit."""
    nbit = codes.shape[-1]
    nwords = -(-nbit // 32)
    bits = (codes > threshold).to(torch.uint8)
    pad = nwords * 32 - nbit
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=codes.device)
    b = (bits.reshape(*bits.shape[:-1], nwords, 4, 8) * weights).sum(
        dim=-1, dtype=torch.int32).unbind(-1)          # 4 x (..., nwords)
    low = b[0] | (b[1] << 8) | (b[2] << 16) | ((b[3] & 0x7F) << 24)
    # bit 31 is the int32 word's sign bit: the uint32 pattern, kept in int32
    return low | ((b[3] >> 7) * -2 ** 31)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (an int32 tensor), as int64."""
    v = words.to(torch.int64) & _M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def hamming_packed(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distance between packed codes: q (Q, L), db (N, L)
    words -> (Q, N) int32. One word at a time, so the int64 temporaries
    are (Q, N), not (Q, N, L)."""
    dist = torch.zeros((q.shape[0], db.shape[0]), dtype=torch.int32,
                       device=q.device)
    for w in range(q.shape[-1]):
        dist += popcount32(torch.bitwise_xor(q[:, None, w],
                                             db[None, :, w])).to(torch.int32)
    return dist


def ternary_sign(codes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """sign() with a dead zone, f32: +1 / -1 / 0 (|c| <= threshold -> 0).
    With threshold 0 it is torch.sign (0 -> 0)."""
    return (codes > threshold).float() - (codes < -threshold).float()


def hamming_signs(q_codes: torch.Tensor, db_codes: torch.Tensor,
                  threshold: float = 0.0) -> torch.Tensor:
    """Hamming distance via ternary sign products, (Q, N) f32: a zeroed
    component contributes 0.5, the generalization of
    0.5 * (nbit - <s_q, s_db>). Exact in f32 products of -1, 0 and +1."""
    nbit = q_codes.shape[-1]
    dot = ternary_sign(q_codes, threshold) @ ternary_sign(db_codes,
                                                          threshold).t()
    return 0.5 * (nbit - dot)


def get_hamm_dist(codes, codebook, threshold: float = 0.0,
                  normalize: bool = False) -> torch.Tensor:
    """API-parity with the reference's ``utils.hashing.get_hamm_dist``:
    ``hamming_signs``, divided by nbit when ``normalize``."""
    codes, codebook = torch.as_tensor(codes), torch.as_tensor(codebook)
    dist = hamming_signs(codes.float(), codebook.float(), threshold)
    return dist / codes.shape[-1] if normalize else dist


def pack_bits_np(codes: np.ndarray, threshold: float = 0.0) -> np.ndarray:
    """NumPy twin of :func:`pack_bits` for host-side galleries, in uint32
    words: bit j of word w is set iff ``codes[..., 32*w + j] > threshold``."""
    nbit = codes.shape[-1]
    nwords = -(-nbit // 32)
    pad = nwords * 32 - nbit
    bits = (codes > threshold).astype(np.uint32)
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.reshape(*bits.shape[:-1], nwords, 32)
    shifts = np.arange(32, dtype=np.uint32)
    return (bits << shifts).sum(axis=-1).astype(np.uint32)
