"""Retrieval: scoring (mAP@R, P@k, R@k, PR curves) and serving top-k by
Hamming distance (counterpart of concepthash_tpu/ops/retrieval.py).

Scoring follows the reference's semantics: Hamming over signed codes
(popcount of packed bits), or cosine / euclidean on raw codes, with an
optional ternary threshold; ranking by ascending distance with ties broken
by database index (a stable sort); AP@R over the queries with a relevant
item in the top R; P@k divides by min(k, n); R@k over the queries with a
relevant item anywhere; R = -1 is the whole database, a list of R gives a
list of mAPs. It runs on the card unless the caller passes ``device="cpu"``.
Query chunks bound the (chunk, N) distance tile; unlike the reference they
are not padded to one static shape. Cosine and euclidean products are full
float32 (TF32 off), as the reference's ``Precision.HIGHEST``.

Serving: a CUDA gallery big enough for the hierarchy goes through the
subblock-min kernel (``ops.topk_select.exact_topk_minspass``) with the full
hierarchical selection as its fallback, as the reference routes its TPU
gallery; a CPU gallery takes the reference's CPU branch. ``exact=False``
rides ``jax.lax.approx_min_k`` in the reference, the exact top-k on the CPU;
there the port takes the stable selection over the same distances, which
gives the reference's distances and the reference's stable tie order. On
the card it is a measured choice (``chip_smoke.py``, ``PERF.md``): for a
+-1 gallery, sign products in bf16 on the tensor cores (exact: integer sums
of at most 256 terms) and ``torch.topk`` over the similarities, faster than
the exact path at 2^20 codes, with exact distances; the order among ties is
the library's. A word-packed gallery (``method='popcount'``) takes the stable
selection over its distances on every device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.ops.hamming import (hamming_packed, hamming_signs,
                                               pack_bits)
from concepthash_tpu_torch.ops.topk_select import (exact_topk_minspass,
                                                   pack_bits_serving,
                                                   smallest, strict_signs)

_QUERY_CHUNK = 1024
# similarity entries per query tile of exact=False on the card (512 MiB)
_APPROX_TILE = 1 << 28


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _full_f32():
    """Float32 products without TF32 on the card for one scoring call, as
    the reference's ``Precision.HIGHEST``. The flag is process-wide: it is
    set once at a scoring entry point, not around each product."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


@_full_f32()
def compute_distances(query_codes: torch.Tensor, db_codes: torch.Tensor,
                      dist_metric: str = "hamming",
                      threshold: float = 0.0) -> torch.Tensor:
    """(Q, nbit) x (N, nbit) -> (Q, N) distances (smaller = closer)."""
    if dist_metric == "hamming":
        if threshold != 0.0:
            return hamming_signs(query_codes, db_codes, threshold)
        return hamming_packed(pack_bits(query_codes), pack_bits(db_codes))
    if dist_metric == "cosine":
        return 1.0 - (_normalize_rows(query_codes)
                      @ _normalize_rows(db_codes).t())
    if dist_metric == "euclidean":
        q2 = (query_codes ** 2).sum(dim=-1, keepdim=True)
        d2 = (db_codes ** 2).sum(dim=-1, keepdim=True)
        return q2 + d2.t() - 2.0 * (query_codes @ db_codes.t())
    raise ValueError(f"unknown dist_metric {dist_metric!r}")


# ---------------------------------------------------------------------------
# chunked ranking metrics
# ---------------------------------------------------------------------------

def _chunk_stats(q_codes, q_labels, db_codes, db_labels, dist_metric: str,
                 threshold: float, Rs: tuple, ks: tuple, drop_first: bool,
                 rel_chunk=None, prep: str = "none") -> dict:
    """Per-query sums of one query chunk, each a (C,) f32 tensor.

    Rs: cutoff ranks for AP; ks: precision/recall cutoffs. ``rel_chunk``:
    explicit (C, N) relevance instead of label matching. ``prep``: the
    caller's database transform, 'hamming_packed' (db_codes is the (N, L)
    word pack) or 'cosine_pre' (rows normalized)."""
    if prep == "hamming_packed":
        dist = hamming_packed(pack_bits(q_codes), db_codes)
    elif prep == "cosine_pre":
        dist = 1.0 - _normalize_rows(q_codes) @ db_codes.t()
    else:
        dist = compute_distances(q_codes, db_codes, dist_metric, threshold)
    dist = dist.float()
    if rel_chunk is not None:
        rel = rel_chunk.bool()
    else:
        rel = (q_labels @ db_labels.t()) > 0

    order = torch.argsort(dist, dim=1, stable=True)     # ties -> db index
    rel_sorted = torch.gather(rel, 1, order)
    if drop_first:
        rel_sorted = rel_sorted[:, 1:]
    n = rel_sorted.shape[1]
    ranks1 = torch.arange(1, n + 1, dtype=torch.float32, device=dist.device)
    cum = torch.cumsum(rel_sorted.float(), dim=1)
    prec_at = cum / ranks1

    out = {}
    for R in Rs:
        r = n if (R == -1 or R > n) else int(R)
        ap_num = (prec_at[:, :r] * rel_sorted[:, :r].float()).sum(dim=1)
        rel_count = cum[:, r - 1]
        out[f"ap_sum@{R}"] = torch.where(rel_count > 0, ap_num / rel_count,
                                         0.0)
        out[f"ap_cnt@{R}"] = (rel_count > 0).float()
    total_rel = rel.float().sum(dim=1)
    if drop_first:
        total_rel = (total_rel - 1.0).clamp(min=0.0)
    for k in ks:
        kk = min(int(k), n)
        topk_rel = cum[:, kk - 1]
        out[f"p_sum@{k}"] = topk_rel / kk
        out[f"r_sum@{k}"] = torch.where(total_rel > 0, topk_rel / total_rel,
                                        0.0)
        out[f"r_cnt@{k}"] = (total_rel > 0).float()
    out["n_valid"] = torch.ones_like(dist[:, 0])
    return out


def _default_chunk(nq: int, ndb: int) -> int:
    # about 64M distance entries per chunk
    c = max(1, (1 << 26) // max(ndb, 1))
    return int(min(nq, c))


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


@_full_f32()
def calculate_mAP(db_codes, db_labels, query_codes, query_labels, R=-1,
                  dist_metric: str = "hamming", PRs=(1, 5, 10),
                  threshold: float = 0.0, remove_first_retrieved: bool = False,
                  zero_mean: bool = False, chunk_size: int | None = None,
                  multiclass: bool = False, onehot: bool = True,
                  rel_matrix=None, device=None, **_ignored):
    """Reference-parity retrieval scoring, on ``device`` (CUDA unless the
    caller asks for another).

    Returns ``(mAP, recalls, precisions)``: mAP is a float (a list when R is
    a list), recalls and precisions are lists aligned with ``PRs``.
    ``rel_matrix`` (Q, N): explicit relevance (landmark ground truth)
    instead of label matching."""
    dev = resolve_device(device)
    db_codes = _as_tensor(db_codes, dev, torch.float32)
    query_codes = _as_tensor(query_codes, dev, torch.float32)

    Rs = tuple(R) if isinstance(R, (list, tuple)) else (R,)
    ks = tuple(int(k) for k in (PRs or ()))
    if query_codes.shape[0] == 0 or db_codes.shape[0] == 0:
        mAP = [0.0] * len(Rs) if isinstance(R, (list, tuple)) else 0.0
        return mAP, [0.0] * len(ks), [0.0] * len(ks)

    # one-hot with a class count shared by both splits
    nclass = _shared_nclass(db_labels, query_labels)
    db_labels = _as_onehot(_as_tensor(db_labels, dev), nclass)
    query_labels = _as_onehot(_as_tensor(query_labels, dev), nclass)

    if zero_mean:
        mean = db_codes.mean(dim=0, keepdim=True)
        db_codes = db_codes - mean
        query_codes = query_codes - mean

    nq, ndb = query_codes.shape[0], db_codes.shape[0]
    chunk = chunk_size or _default_chunk(nq, ndb)

    # the database side of the distance, once for every chunk
    prep = "none"
    if dist_metric == "hamming" and threshold == 0.0:
        db_codes, prep = pack_bits(db_codes), "hamming_packed"
    elif dist_metric == "cosine":
        db_codes, prep = _normalize_rows(db_codes), "cosine_pre"

    acc: dict[str, float] = {}
    for s in range(0, nq, chunk):
        e = min(s + chunk, nq)
        rc = (_as_tensor(rel_matrix[s:e], dev) if rel_matrix is not None
              else None)
        stats = _chunk_stats(query_codes[s:e], query_labels[s:e], db_codes,
                             db_labels, dist_metric, float(threshold), Rs, ks,
                             bool(remove_first_retrieved), rel_chunk=rc,
                             prep=prep)
        # one device-to-host copy per chunk
        sums = torch.stack([v.sum() for v in stats.values()]).tolist()
        for key, v in zip(stats, sums):
            acc[key] = acc.get(key, 0.0) + v

    mAPs = []
    for r in Rs:
        cnt = acc.get(f"ap_cnt@{r}", 0.0)
        mAPs.append(acc[f"ap_sum@{r}"] / cnt if cnt > 0 else 0.0)
    n_valid = acc.get("n_valid", float(nq))
    precisions = [acc[f"p_sum@{k}"] / n_valid for k in ks]
    recalls = []
    for k in ks:
        cnt = acc.get(f"r_cnt@{k}", 0.0)
        recalls.append(acc[f"r_sum@{k}"] / cnt if cnt > 0 else 0.0)

    mAP = mAPs if isinstance(R, (list, tuple)) else mAPs[0]
    return mAP, recalls, precisions


def calculate_pr_curve(db_codes, db_labels, query_codes, query_labels,
                       dist_metric: str = "hamming", threshold: float = 0.0,
                       remove_first_retrieved: bool = False,
                       num_points: int = 50, chunk_size: int | None = None,
                       device=None, **_ignored):
    """PR curve over log-spaced rank cutoffs. Returns (recalls, precisions,
    Rs)."""
    ndb = db_codes.shape[0] if hasattr(db_codes, "shape") else len(db_codes)
    n = ndb - 1 if remove_first_retrieved else ndb
    Rs = np.unique(np.geomspace(1, n, num_points).astype(int)).tolist()
    _, recalls, precisions = calculate_mAP(
        db_codes, db_labels, query_codes, query_labels, R=-1,
        dist_metric=dist_metric, PRs=tuple(Rs), threshold=threshold,
        remove_first_retrieved=remove_first_retrieved, chunk_size=chunk_size,
        device=device)
    return recalls, precisions, list(Rs)


def _shared_nclass(*label_arrays) -> int:
    """Class count consistent across all given label arrays (max class id
    of the 1-d ones, width of the one-hot ones)."""
    n = 0
    for a in label_arrays:
        a = a if torch.is_tensor(a) else np.asarray(a)
        if a.ndim == 1:
            if a.shape[0]:
                n = max(n, int(a.max()) + 1)
        else:
            n = max(n, a.shape[1])
    return n


def _as_onehot(labels: torch.Tensor, nclass: int | None = None) -> torch.Tensor:
    if labels.dim() == 1:
        if nclass is None:
            nclass = int(labels.max()) + 1
        return torch.nn.functional.one_hot(labels.long(), nclass).float()
    if nclass is not None and labels.shape[1] < nclass:
        # widen a narrower one-hot/multi-hot to the shared class count
        labels = torch.nn.functional.pad(labels, (0, nclass - labels.shape[1]))
    return labels.float()


# ---------------------------------------------------------------------------
# serving-path top-k retrieval
# ---------------------------------------------------------------------------

def _mask_cols(dist: torch.Tensor, n_valid, offset: int = 0) -> torch.Tensor:
    if n_valid is None:
        return dist
    col = torch.arange(dist.shape[-1], device=dist.device) + offset
    return torch.where(col < int(n_valid), dist, float("inf"))


def _sign_topk_cuda(q: torch.Tensor, db: torch.Tensor, k: int):
    """exact=False on the card: the k nearest rows of a +-1 gallery by
    tensor-core sign products (bf16 holds every integer sum of up to 256
    terms exactly; f32 beyond, where TF32 too keeps +-1 exact and sums in
    f32) and ``torch.topk`` over the
    similarities, a query tile at a time. Returns (distances f32, int64
    indices), ascending."""
    nbit, N = q.shape[1], db.shape[0]
    if k > N:
        raise ValueError(f"k={k} exceeds the {N} valid gallery rows")
    dt = torch.bfloat16 if nbit <= 256 else torch.float32
    sdb = strict_signs(db).to(dt)
    parts = []
    for qc in q.split(max(1, _APPROX_TILE // N)):
        sim = strict_signs(qc).to(dt) @ sdb.t()
        s, i = torch.topk(sim, k, dim=1, largest=True, sorted=True)
        parts.append((0.5 * (nbit - s.float()), i))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


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
    carries pad rows (masked to +inf). ``exact=True`` queries run in chunks
    of 1024, a ragged last chunk padded by repeating the first query;
    ``exact=False`` selects over whole distance tiles (see the module
    docstring). Returns (distances (Q, k) f32, indices (Q, k) int64)."""
    if method not in ("mxu", "popcount"):
        raise ValueError(method)

    def dist_of(qc):
        if method == "mxu":
            return _mask_cols(sign_distances(qc, db), n_valid)
        return _mask_cols(hamming_packed(qc, db).float(), n_valid)

    N = db.shape[0]
    if not exact and method == "mxu" and db.is_cuda:
        nv = N if n_valid is None else min(N, int(n_valid))
        return _sign_topk_cuda(query_codes, db[:nv], k)
    if method == "popcount":
        query_codes = pack_bits(query_codes)
    Q, nbit = query_codes.shape
    if not exact:
        return smallest(dist_of(query_codes), k)
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


def _walk_blocks(qi: torch.Tensor, n_rows: int, k: int, db_block: int,
                 block_topk):
    """Top-k over ``n_rows`` gallery rows, ``db_block`` at a time:
    ``block_topk(b0)`` gives the (distances, block-local indices) of the
    block starting at row b0, merged by a stable selection over the running
    and the new candidates."""
    Q = qi.shape[0]
    best_d = torch.full((Q, k), float("inf"), device=qi.device)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=qi.device)
    for b0 in range(0, n_rows, db_block):
        d, idx = block_topk(b0)
        dd = torch.cat([best_d, d], dim=1)
        ii = torch.cat([best_i, idx + b0], dim=1)
        best_d, sel = smallest(dd, k)
        best_i = torch.gather(ii, 1, sel)
    return best_d, best_i


def retrieve_topk_streaming(query_codes: torch.Tensor, db_signs: torch.Tensor,
                            k: int = 100, db_block: int = 2_000_000,
                            exact: bool = False, n_valid=None,
                            db_bits: torch.Tensor | None = None):
    """Serving top-k over a gallery of int8 signs, (N, nbit) or the packed
    (N/P, 128) form of ``pack_serving_gallery``, walking ``db_block``-code
    blocks. ``exact=False`` selects per block as ``retrieve_topk`` does.
    ``exact=True`` runs ``exact_topk_minspass`` first (no (Q, N) distance
    matrix), and walks the blocks with an exact top-k per block only when
    its certificate fails. N must be a multiple of db_block. Returns
    (distances (Q, k) f32, indices (Q, k) int64)."""
    Q, nbit = query_codes.shape
    packed = db_signs.shape[1] == 128 and nbit != 128
    P = 128 // nbit if packed else 1
    N = db_signs.shape[0] * P
    if N % db_block or db_block % P:
        raise ValueError(f"pad the gallery ({N} codes) to a multiple of "
                         f"db_block={db_block}, itself a multiple of P={P}")
    qi = strict_signs(query_codes)
    rows = db_signs.reshape(N, nbit)

    def masked(select):
        def block_topk(b0):
            sim = qi.float() @ rows[b0:b0 + db_block].float().t()
            dist = _mask_cols(0.5 * (nbit - sim), n_valid, offset=b0)
            return select(dist, k)
        return block_topk

    if not exact and rows.is_cuda:
        nv = N if n_valid is None else min(N, int(n_valid))

        def block_topk(b0):                      # the block's valid rows
            block = rows[b0:min(b0 + db_block, nv)]
            return _sign_topk_cuda(qi, block, min(k, block.shape[0]))
        return _walk_blocks(qi, nv, k, db_block, block_topk)
    if not exact:
        return _walk_blocks(qi, N, k, db_block, masked(smallest))
    d_fast, i_fast, valid = exact_topk_minspass(qi, db_signs, k,
                                                n_valid=n_valid,
                                                db_bits=db_bits)
    if valid:
        return d_fast, i_fast
    return _walk_blocks(qi, N, k, db_block, masked(exact_topk_blocked))


# ---------------------------------------------------------------------------
# label-pair helpers (reference utils.hashing.get_sim / log_trick)
# ---------------------------------------------------------------------------

@_full_f32()
def get_sim(y1, y2, onehot: bool = True) -> torch.Tensor:
    """Pairwise label-match matrix S_ij = [y1_i ~ y2_j] (bool)."""
    y1, y2 = torch.as_tensor(y1), torch.as_tensor(y2)
    if not onehot or y1.dim() == 1:
        return y1[:, None] == y2[None, :]
    return (y1.float() @ y2.float().t()) > 0


def log_trick(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable log(1 + exp(x))."""
    return torch.relu(x) + torch.log1p(torch.exp(-x.abs()))


def normalized_mutual_info(a, b) -> float:
    """NMI between two integer label assignments, arithmetic-mean
    normalized (sklearn's normalized_mutual_info_score defaults), from the
    contingency table on the host."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"label arrays differ in size: {a.shape} vs {b.shape}")
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    na, nb = ai.max() + 1, bi.max() + 1
    if na == nb == 1:
        return 1.0          # both single-cluster partitions
    cont = np.zeros((na, nb), np.float64)
    np.add.at(cont, (ai, bi), 1.0)
    pij = cont / cont.sum()
    pa = pij.sum(1, keepdims=True)
    pb = pij.sum(0, keepdims=True)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / (pa @ pb)[nz])).sum())
    if mi <= 1e-15:
        return 0.0
    ha = -float((pa[pa > 0] * np.log(pa[pa > 0])).sum())
    hb = -float((pb[pb > 0] * np.log(pb[pb > 0])).sum())
    return mi / max((ha + hb) / 2.0, 1e-15)
