"""Serving kernels of the PyTorch port against the JAX package: subblock mins
(plain version vs the Pallas kernels in interpret mode, element for element),
the packers, the selection scaffold and exact_topk_minspass (distances,
indices and certificate equal on every branch). The CUDA mins kernel against
its plain version is in test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import concepthash_tpu.ops.hamming as jh
import concepthash_tpu.ops.retrieval as jr
import concepthash_tpu.ops.topk_select as jts
import concepthash_tpu_torch.ops.hamming as th
import concepthash_tpu_torch.ops.retrieval as tr
import concepthash_tpu_torch.ops.topk_select as tts


def _signs(rng, n, nbit):
    s = np.sign(rng.standard_normal((n, nbit))).astype(np.float32)
    s[s == 0] = 1.0
    return s


def _u32(words):
    return np.asarray(words).astype(np.int32).view(np.uint32)


@pytest.mark.parametrize("nbit", [32, 64])
@pytest.mark.parametrize("layout", ["packed", "plain"])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_subblock_mins_match_pallas(rng, nbit, layout, out_dtype):
    """Mins over a ragged N equal the interpret-mode Pallas kernel's on every
    real subblock; rows past the last real subblock read nbit + 1."""
    S, Q, N = 8, 16, 1003                      # N ragged to S and to P
    q = _signs(rng, Q, nbit)
    q[0, :3] = 0.0                             # exact zeros count as -1
    db = _signs(rng, N, nbit)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    if layout == "packed":
        jp, jn = jts.pack_serving_gallery(jnp.asarray(db))
        tp, tn = tts.pack_serving_gallery(torch.tensor(db))
        assert jn == tn
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        want = jts.subblock_min_dists_packed(
            jnp.asarray(q), jp, subblock=S, block_rows2=64, interpret=True,
            out_dtype=jdt)
        got = tts.subblock_min_dists_packed(torch.tensor(q), tp, subblock=S,
                                            out_dtype=tdt)
        n_codes = tn
    else:
        db8 = db.astype(np.int8)
        want = jts.subblock_min_dists(jnp.asarray(q), jnp.asarray(db8),
                                      subblock=S, block_rows=128,
                                      interpret=True, out_dtype=jdt)
        got = tts.subblock_min_dists(torch.tensor(q), torch.tensor(db8),
                                     subblock=S, out_dtype=tdt)
        n_codes = N
    m = -(-n_codes // S)
    assert got.shape == (m, Q) and got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want[:m])
    assert (want[m:] == nbit + 1).all()


@pytest.mark.parametrize("subblock", [64, 128])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["packed", "plain"])
@pytest.mark.parametrize("nbit", [16, 32, 64, 128])
def test_serving_mins_match_pallas(rng, nbit, layout, out_dtype, subblock):
    """The plain version's (Q, m_pad) mins and (Q, m_pad / 64) superblock
    mins, the layout the kernel writes, against the Pallas kernel's (m, Q)
    mins in interpret mode, transposed, padded with nbit + 1 to a multiple
    of 64 and min-reduced here: a ragged N over m = 70 subblocks (not a
    multiple of 64), exactly."""
    S, Q, m = subblock, 12, 70
    N = (m - 1) * S + 37                       # ragged to S and to P
    P = 128 // nbit
    q = _signs(rng, Q, nbit)
    q[0, :3] = 0.0                             # exact zeros count as -1
    db = _signs(rng, N, nbit)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    if layout == "packed":
        jp, _ = jts.pack_serving_gallery(jnp.asarray(db))
        gal, n_codes = tts.pack_serving_gallery(torch.tensor(db))
        jm = jts.subblock_min_dists_packed(
            jnp.asarray(q), jp, subblock=S, block_rows2=4 * S // P,
            interpret=True, out_dtype=jdt)
    else:
        gal, n_codes = torch.tensor(db.astype(np.int8)), N
        jm = jts.subblock_min_dists(jnp.asarray(q), jnp.asarray(
            db.astype(np.int8)), subblock=S, block_rows=4 * S,
            interpret=True, out_dtype=jdt)
    assert -(-n_codes // S) == m
    jm = np.asarray(jm.astype(jnp.float32))[:m].T              # (Q, m)
    want = np.full((Q, 128), nbit + 1, np.float32)
    want[:, :m] = jm
    want_sb = want.reshape(Q, -1, 64).min(axis=-1)
    mins, msb = tts._mins(tts.strict_signs(torch.tensor(q)), gal, n_codes,
                          nbit, S, tdt, superblocks=True)
    assert mins.shape == (Q, 128) and msb.shape == (Q, 2)
    assert mins.dtype == msb.dtype == tdt
    np.testing.assert_array_equal(mins.float().numpy(), want)
    np.testing.assert_array_equal(msb.float().numpy(), want_sb)
    alone, none = tts._mins(tts.strict_signs(torch.tensor(q)), gal, n_codes,
                            nbit, S, tdt)
    assert none is None and torch.equal(alone, mins)


def test_mins_reference_tail_rows(rng):
    """The plain version's rows past N read nbit + 1, as the reference's."""
    nbit, S, Q, N = 32, 8, 4, 20
    qi = torch.tensor(_signs(rng, Q, nbit)).to(torch.int8)
    db = torch.tensor(_signs(rng, N, nbit)).to(torch.int8)
    got = tts._mins_reference(qi, db, S, 5)
    want = jts._mins_reference(jnp.asarray(qi.numpy()), jnp.asarray(db.numpy()),
                               S, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[3:] == nbit + 1).all()


@pytest.mark.parametrize("nbit", [32, 64])
def test_packers_match(rng, nbit, monkeypatch):
    db = _signs(rng, 300, nbit)
    db[0, :5] = 0.0
    np.testing.assert_array_equal(
        _u32(th.pack_bits(torch.tensor(db)).numpy()),
        np.asarray(jh.pack_bits(jnp.asarray(db))))
    jp, _ = jts.pack_serving_gallery(jnp.asarray(db))
    tp, _ = tts.pack_serving_gallery(torch.tensor(db))
    monkeypatch.setattr(tts, "_PACK_CHUNK_CODES", 64)   # several chunks
    for S in (8, 64):
        want = np.asarray(jts.pack_bits_serving(jp, nbit, subblock=S))
        got = tts.pack_bits_serving(tp, nbit, subblock=S).numpy()
        np.testing.assert_array_equal(_u32(got), want)
    q = jnp.asarray(_signs(rng, 5, nbit))
    np.testing.assert_array_equal(
        th.hamming_packed(th.pack_bits(torch.tensor(np.asarray(q))),
                          th.pack_bits(torch.tensor(db))).numpy(),
        np.asarray(jh.hamming_packed(jh.pack_bits(q), jh.pack_bits(
            jnp.asarray(db)))))


def test_approx_smallest_rows_match(rng):
    x = rng.integers(0, 20, (6, 1000)).astype(np.float32)   # heavy ties
    for cap2, theta in ((None, True), (4, True), (None, False)):
        want = jts._approx_smallest_rows(jnp.asarray(x), 30, sub2=16,
                                         cap2=cap2, return_theta=theta)
        got = tts._approx_smallest_rows(torch.tensor(x), 30, sub2=16,
                                        cap2=cap2, return_theta=theta)
        if not theta:
            want, got = (want,), (got,)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mins2 = x.reshape(6, -1, 8).min(-1)
    want = jts._approx_smallest_rows(jnp.asarray(x), 30, sub2=8,
                                     return_theta=True,
                                     mins2=jnp.asarray(mins2))
    got = tts._approx_smallest_rows(torch.tensor(x), 30, sub2=8,
                                    return_theta=True,
                                    mins2=torch.tensor(mins2))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _minspass_pair(q, db, **kw):
    jd, ji, jv = jts.exact_topk_minspass(
        jnp.asarray(q), jnp.asarray(db), interpret=True,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    td, ti, tv = tts.exact_topk_minspass(
        torch.tensor(q), torch.tensor(db),
        **{k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tv == bool(jv)
    return tv


@pytest.mark.parametrize("branch", ["dense", "small_m", "large_m"])
@pytest.mark.parametrize("layout", ["packed", "plain"])
def test_minspass_matches_jax(rng, monkeypatch, branch, layout):
    """Distances, indices and certificate equal the reference's on each
    selection branch, over random codes and over a gallery built from a few
    repeated codes (heavy ties)."""
    nbit, k, Q, N = 64, 7, 5, 2000
    if branch == "large_m":
        monkeypatch.setattr(jts, "_INNER_DIRECT_MAX", 16)
        monkeypatch.setattr(tts, "_INNER_DIRECT_MAX", 16)
    cap = 400 if branch == "dense" else 32
    q = _signs(rng, Q, nbit)
    base = _signs(rng, 30, nbit)
    for db in (_signs(rng, N, nbit), base[rng.integers(0, 30, N)]):
        db = db.astype(np.int8)
        if layout == "packed":
            db = db.reshape(-1, 128)
        _minspass_pair(q, db, k=k, subblock=8, cap=cap)


@pytest.mark.parametrize("branch", ["small_m", "large_m"])
def test_minspass_bits_and_n_valid_match(rng, monkeypatch, branch):
    """The bit-packed rescore with pad rows masked by n_valid."""
    nbit, k, Q, N = 64, 5, 4, 1999
    if branch == "large_m":
        monkeypatch.setattr(jts, "_INNER_DIRECT_MAX", 16)
        monkeypatch.setattr(tts, "_INNER_DIRECT_MAX", 16)
    q = _signs(rng, Q, nbit)
    db = _signs(rng, N, nbit)
    jp, n_pad = jts.pack_serving_gallery(jnp.asarray(db))
    bits = np.asarray(jts.pack_bits_serving(jp, nbit, subblock=8))
    valid = _minspass_pair(q, np.asarray(jp), k=k, subblock=8, cap=32,
                           n_valid=N, db_bits=bits.astype(np.int32))
    assert valid


def test_minspass_tie_flood_retries_and_fails(rng):
    """All-identical codes: the certificate fails at cap and at the retry;
    what comes back still equals the reference's."""
    nbit = 32
    q = _signs(rng, 4, nbit)
    db = np.tile(_signs(rng, 1, nbit), (2000, 1)).astype(np.int8)
    assert not _minspass_pair(q, db, k=3, subblock=8, cap=16)


def test_exact_topk_blocked_matches(rng):
    """Hierarchical branch with its certificate holding, and the fallback on
    integer-uniform ties; values and indices equal."""
    for hi in (1000, 3):
        dist = rng.integers(0, hi, (3, 5000)).astype(np.float32)
        jd, ji = jr.exact_topk_blocked(jnp.asarray(dist), 10, subblock=16,
                                       cap=32)
        td, ti = tr.exact_topk_blocked(torch.tensor(dist), 10, subblock=16,
                                       cap=32)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _tie_gallery(rng, n, nbit):
    return _signs(rng, 30, nbit)[rng.integers(0, 30, n)]     # heavy ties


def _check_approx(td, ti, jd, ji, dist, jd_exact, ji_exact):
    """The port's exact=False against the reference's, on the CPU. There
    ``approx_min_k`` is the exact top-k, but its tie order is that of an
    unstable sort on the values (lower index first only for rows of 16 or
    fewer): distances equal it; indices equal the reference's stable
    tie-break (its exact path, ``lax.top_k``), agree with approx_min_k on
    every entry strictly below the k-th distance, and score their
    distances."""
    td, ti = td.numpy(), ti.numpy()
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(td, np.asarray(jd_exact))
    np.testing.assert_array_equal(ti, np.asarray(ji_exact))
    np.testing.assert_array_equal(np.take_along_axis(dist, ti, 1), td)
    for t_row, j_row, d_row in zip(ti, ji, td):
        below = d_row < d_row[-1]
        assert set(t_row[below]) == set(j_row[below])


@pytest.mark.parametrize("n_valid", [None, 1990])
@pytest.mark.parametrize("method", ["mxu", "popcount"])
def test_approx_retrieve_topk_matches_jax(rng, method, n_valid):
    """retrieve_topk(exact=False) over a tie-heavy gallery, with pad rows
    masked (see _check_approx)."""
    q = _signs(rng, 7, 64)
    q[2, :5] = 0.0
    db = _tie_gallery(rng, 2000, 64)
    jdb, tdb = jnp.asarray(db), torch.tensor(db)
    if method == "popcount":
        jdb, tdb = jh.pack_bits(jdb), th.pack_bits(tdb)
    kw = dict(k=12, method=method, n_valid=n_valid)
    jd, ji = jr.retrieve_topk(jnp.asarray(q), jdb, exact=False, **kw)
    je = jr.retrieve_topk(jnp.asarray(q), jdb, exact=True, **kw)
    td, ti = tr.retrieve_topk(torch.tensor(q), tdb, exact=False, **kw)
    dist = np.asarray(tr.sign_distances(torch.tensor(q), torch.tensor(db)))
    if n_valid is not None:
        dist[:, n_valid:] = np.inf
        assert ti.max() < n_valid
    _check_approx(td, ti, jd, ji, dist, *je)


@pytest.mark.parametrize("n_valid", [None, 1990])
@pytest.mark.parametrize("layout", ["packed", "plain"])
def test_approx_streaming_matches_jax(rng, layout, n_valid):
    """retrieve_topk_streaming(exact=False) walks four blocks, selecting per
    block and merging, ties across blocks included (see _check_approx)."""
    nbit = 32
    q = _signs(rng, 5, nbit)
    db = _tie_gallery(rng, 2000, nbit).astype(np.int8)
    dist = np.asarray(tr.sign_distances(torch.tensor(q), torch.tensor(db)))
    if n_valid is not None:
        dist[:, n_valid:] = np.inf
    if layout == "packed":
        db = db.reshape(-1, 128)
    kw = dict(k=9, db_block=500, n_valid=n_valid)
    jd, ji = jr.retrieve_topk_streaming(jnp.asarray(q), jnp.asarray(db),
                                        exact=False, **kw)
    td, ti = tr.retrieve_topk_streaming(torch.tensor(q), torch.tensor(db),
                                        exact=False, **kw)
    je = jr.retrieve_topk_streaming(jnp.asarray(q), jnp.asarray(db),
                                    exact=True, **kw)
    _check_approx(td, ti, jd, ji, dist, *je)


@pytest.mark.parametrize("streaming", [False, True])
def test_approx_without_ties_is_index_identical(streaming):
    """Where no two codes tie (code i flips the first i bits of the query),
    exact=False is index-identical to the reference's approx_min_k."""
    nbit = 64
    q = np.ones((1, nbit), np.float32)
    db = np.ones((64, nbit), np.float32)
    for i in range(64):
        db[i, :i] = -1.0
    db = db[np.random.default_rng(4).permutation(64)]
    if streaming:
        args = (db.astype(np.int8),)
        kw = dict(k=10, db_block=16, exact=False)
        want = jr.retrieve_topk_streaming(jnp.asarray(q), jnp.asarray(*args),
                                          **kw)
        got = tr.retrieve_topk_streaming(torch.tensor(q), torch.tensor(*args),
                                         **kw)
    else:
        want = jr.retrieve_topk(jnp.asarray(q), jnp.asarray(db), k=10)
        got = tr.retrieve_topk(torch.tensor(q), torch.tensor(db), k=10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_approx_equals_exact_on_cpu(rng):
    """On the CPU, exact=False and exact=True give the same answer."""
    q = _signs(rng, 6, 64)
    db = _tie_gallery(rng, 3000, 64)
    a = tr.retrieve_topk(torch.tensor(q), torch.tensor(db), k=20)
    b = tr.retrieve_topk(torch.tensor(q), torch.tensor(db), k=20, exact=True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)



def test_retrieve_topk_chunks_queries_like_jax(rng):
    """More queries than one 1024-query chunk: the ragged last chunk is
    padded with the first query and cut off again; distances and indices
    equal the reference's, ties included."""
    q = _signs(rng, 1030, 32)
    q[5, :4] = 0.0
    db = _signs(rng, 30, 32)[rng.integers(0, 30, 2000)]      # heavy ties
    jd, ji = jr.retrieve_topk(jnp.asarray(q), jnp.asarray(db), k=5,
                              exact=True)
    td, ti = tr.retrieve_topk(torch.tensor(q), torch.tensor(db), k=5,
                              exact=True)
    assert td.shape == (1030, 5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
