"""Serving-path exact top-k retrieval by Hamming distance (counterpart of the
serving part of concepthash_tpu/ops/retrieval.py).

A CUDA gallery big enough for the hierarchy goes through the subblock-min
kernel (``ops.topk_select.exact_topk_minspass``) with the full hierarchical
selection as its fallback, as the reference routes its TPU gallery; a CPU
gallery takes the reference's CPU branch. Ties resolve to the lower position
first (stable sorts, as ``lax.top_k``). ``exact=False`` rides
``jax.lax.approx_min_k`` in the reference, which has no torch counterpart
yet, and raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from concepthash_tpu_torch.ops.hamming import hamming_packed, pack_bits
from concepthash_tpu_torch.ops.topk_select import (exact_topk_minspass,
                                                   pack_bits_serving,
                                                   smallest, strict_signs)

_QUERY_CHUNK = 1024


def _approx_unported(what: str):
    return NotImplementedError(
        f"{what}(exact=False) rides jax.lax.approx_min_k in the reference, "
        f"which has no torch counterpart yet; pass exact=True")


def _mask_cols(dist: torch.Tensor, n_valid, offset: int = 0) -> torch.Tensor:
    if n_valid is None:
        return dist
    col = torch.arange(dist.shape[-1], device=dist.device) + offset
    return torch.where(col < int(n_valid), dist, float("inf"))


def sign_distances(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain (Q, N) Hamming distances of strict +-1 signs, f32: the
    sign-product 0.5 * (nbit - <q, db>), exact in f32 products."""
    nbit = q.shape[-1]
    sim = strict_signs(q).float() @ strict_signs(db).float().t()
    return 0.5 * (nbit - sim)


def exact_topk_blocked(dist: torch.Tensor, k: int, subblock: int = 64,
                       cap: int = 512):
    """Exact min-k over the last axis by subblock mins: select the ``cap``
    subblocks with the smallest mins, take the top-k of their entries, and
    fall back to a full selection when the k-th distance is not strictly
    below the best unselected subblock min. Returns (values (Q, k),
    int64 indices (Q, k))."""
    Q, N = dist.shape
    if N <= 2 * cap * subblock or k > cap:
        return smallest(dist, k)
    pad = (-N) % subblock
    if pad:
        dist = torch.cat([dist, dist.new_full((Q, pad), float("inf"))], dim=1)
    m = (N + pad) // subblock
    d3 = dist.reshape(Q, m, subblock)
    mins = d3.amin(dim=-1)                                     # (Q, m)
    mv, mi = smallest(mins, cap + 1)
    sel = mi[:, :cap]
    theta_next = mv[:, cap]
    g = torch.gather(d3, 1, sel[:, :, None].expand(Q, cap, subblock))
    d_fast, li = smallest(g.reshape(Q, cap * subblock), k)
    i_fast = torch.gather(sel, 1, li // subblock) * subblock + li % subblock
    if bool((d_fast[:, -1] < theta_next).all()):
        return d_fast, i_fast
    # inf padding never enters the top-k, so padded-width indices are global
    return smallest(d3.reshape(Q, m * subblock), k)


def retrieve_topk(query_codes: torch.Tensor, db: torch.Tensor, k: int = 100,
                  method: str = "mxu", exact: bool = False, n_valid=None):
    """Top-k nearest database entries by Hamming distance.

    query_codes: (Q, nbit) sign-able codes. db: method='mxu' -> (N, nbit)
    +-1 values; method='popcount' -> (N, L) words from
    ``ops.hamming.pack_bits``. ``n_valid``: the real row count when db
    carries pad rows (masked to +inf). Queries run in chunks of 1024; a
    ragged last chunk is padded by repeating the first query. Returns
    (distances (Q, k) f32, indices (Q, k) int64)."""
    if not exact:
        raise _approx_unported("retrieve_topk")
    if method not in ("mxu", "popcount"):
        raise ValueError(method)

    def dist_of(qc):
        if method == "mxu":
            return _mask_cols(sign_distances(qc, db), n_valid)
        return _mask_cols(hamming_packed(qc, db).float(), n_valid)

    if method == "popcount":
        query_codes = pack_bits(query_codes)
    Q, nbit = query_codes.shape
    N = db.shape[0]
    use_kernel = (method == "mxu" and 128 % nbit == 0 and nbit % 32 == 0
                  and N % (128 // nbit) == 0 and N > 65536 and db.is_cuda)
    if use_kernel:
        db_i8 = strict_signs(db)
        packed_db = db_i8.reshape(N * nbit // 128, 128)
        db_bits = pack_bits_serving(db_i8, nbit)

    def exact_tile(qc):
        if use_kernel:
            d, idx, ok = exact_topk_minspass(qc, packed_db, k,
                                             n_valid=n_valid, db_bits=db_bits)
            if ok:
                return d, idx
        return exact_topk_blocked(dist_of(qc), k)

    if Q <= _QUERY_CHUNK:
        return exact_tile(query_codes)
    pad = (-Q) % _QUERY_CHUNK
    # pad with the first real query: an all-zero query ties every distance
    # and would defeat the certificate for the whole last chunk
    qp = (torch.cat([query_codes, query_codes[:1].expand(pad, -1)]) if pad
          else query_codes)
    parts = [exact_tile(qc) for qc in qp.split(_QUERY_CHUNK)]
    d = torch.cat([p[0] for p in parts])[:Q]
    idx = torch.cat([p[1] for p in parts])[:Q]
    return d, idx


def retrieve_topk_streaming(query_codes: torch.Tensor, db_signs: torch.Tensor,
                            k: int = 100, db_block: int = 2_000_000,
                            exact: bool = False, n_valid=None,
                            db_bits: torch.Tensor | None = None):
    """Serving top-k over a gallery of int8 signs, (N, nbit) or the packed
    (N/P, 128) form of ``pack_serving_gallery``, without a (Q, N) distance
    matrix on the fast path: ``exact_topk_minspass`` first, and when its
    certificate fails, a walk over ``db_block``-code blocks (exact top-k per
    block, merged). N must be a multiple of db_block. Returns (distances
    (Q, k) f32, indices (Q, k) int64)."""
    if not exact:
        raise _approx_unported("retrieve_topk_streaming")
    Q, nbit = query_codes.shape
    packed = db_signs.shape[1] == 128 and nbit != 128
    P = 128 // nbit if packed else 1
    N = db_signs.shape[0] * P
    if N % db_block or db_block % P:
        raise ValueError(f"pad the gallery ({N} codes) to a multiple of "
                         f"db_block={db_block}, itself a multiple of P={P}")
    qi = strict_signs(query_codes)
    d_fast, i_fast, valid = exact_topk_minspass(qi, db_signs, k,
                                                n_valid=n_valid,
                                                db_bits=db_bits)
    if valid:
        return d_fast, i_fast
    rows = db_signs.reshape(N, nbit)
    best_d = torch.full((Q, k), float("inf"), device=qi.device)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=qi.device)
    for b0 in range(0, N, db_block):
        block = rows[b0:b0 + db_block]
        sim = qi.float() @ block.float().t()
        dist = _mask_cols(0.5 * (nbit - sim), n_valid, offset=b0)
        d, idx = exact_topk_blocked(dist, k)
        dd = torch.cat([best_d, d], dim=1)
        ii = torch.cat([best_i, idx + b0], dim=1)
        best_d, sel = smallest(dd, k)
        best_i = torch.gather(ii, 1, sel)
    return best_d, best_i
