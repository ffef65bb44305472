"""Sharded-gallery retrieval: exact top-k over a gallery split across the
ranks of a mesh (counterpart of concepthash_tpu/ops/sharded.py).

Each rank holds a contiguous block of the gallery's rows (``shard_gallery``)
and keeps a local top-k over it: ``retrieve_topk``, or
``retrieve_topk_streaming`` for a streaming block or the 128-lane packed
layout; on the card a block above 65,536 codes goes through the subblock
mins kernels (``exact_topk_minspass``). Then the (Q, k) distances and
global indices of every rank are all-gathered in rank order, (Q, W k), and
re-ranked with the stable ``smallest``: among equal distances the lower
rank, then the lower local index, comes first, so the result equals the
one-process exact top-k over the whole gallery, ties included.
"""

from __future__ import annotations

import torch

from concepthash_tpu_torch.ops.retrieval import (retrieve_topk,
                                                 retrieve_topk_streaming)
from concepthash_tpu_torch.ops.topk_select import smallest
from concepthash_tpu_torch.parallel.collectives import gather_rows_


def shard_gallery(db_codes, mesh, streaming_block: int = 0):
    """(this rank's block of the gallery on its device, the real row
    count). ``db_codes`` (N, nbit) codes, or the packed (N/P, 128) rows of
    ``pack_serving_gallery``, is padded with all-zero rows to a multiple of
    the rank count (times ``streaming_block``, which
    ``make_sharded_topk(streaming_block=...)`` walks each block in), so
    every rank holds the same number of rows; pass the real count on as
    ``n_valid``."""
    db = torch.as_tensor(db_codes)
    n = db.shape[0]
    multiple = mesh.size * streaming_block if streaming_block else mesh.size
    pad = (-n) % multiple
    if pad:
        db = torch.cat([db, db.new_zeros((pad, *db.shape[1:]))])
    rows = db.shape[0] // mesh.size
    return db[mesh.rows(rows)].to(mesh.device), n


def make_sharded_topk(mesh, k: int, method: str = "mxu", exact: bool = False,
                      streaming_block: int = 0, n_valid: int | None = None):
    """fn(query_codes (Q, nbit), db_shard) -> (distances (Q, k) f32, global
    indices (Q, k) int64), the same on every rank. ``db_shard`` is this
    rank's block from ``shard_gallery``: ±1 codes for the dense route, or
    int8 signs (plain, or the 128-lane packed layout holding P = 128 //
    nbit codes a row) for the streaming one, which a ``streaming_block`` or
    the packed layout selects. ``n_valid``: the gallery's real row count;
    each rank masks the pad rows of its own block. Each block must hold at
    least k rows."""

    def fn(q: torch.Tensor, db_shard: torch.Tensor):
        nbit = q.shape[1]
        p_pack = (128 // nbit if db_shard.shape[1] == 128 and nbit != 128
                  else 1)
        shard_rows = db_shard.shape[0] * p_pack
        offset = mesh.rank * shard_rows
        local_valid = (None if n_valid is None else
                       min(max(int(n_valid) - offset, 0), shard_rows))
        if streaming_block or p_pack > 1:
            d, idx = retrieve_topk_streaming(
                q, db_shard, k=k, db_block=streaming_block or shard_rows,
                exact=exact, n_valid=local_valid)
        else:
            d, idx = retrieve_topk(q, db_shard, k=k, method=method,
                                   exact=exact, n_valid=local_valid)
        Q = q.shape[0]
        # one all-gather of both: float64 holds the distances (small
        # integers or +inf) and the global indices exactly; (W, 2, Q, k) in
        # rank order, then (Q, W k) as the reference's tiled all-gather
        # along axis 1
        both = torch.stack([d.double(), (idx + offset).double()])[None]
        g = gather_rows_(both, mesh).permute(1, 2, 0, 3).reshape(2, Q, -1)
        best, sel = smallest(g[0].float(), k)
        return best, torch.gather(g[1].long(), 1, sel)

    return fn
