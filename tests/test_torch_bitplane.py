"""Bit-plane serving of the PyTorch port against the JAX package: the packer
and its inverse (byte for byte), the subblock mins (the plain version vs the
Pallas kernel in interpret mode, in each of its three unpack forms) and
exact_topk_bitplane on every branch (distances, indices and certificate
equal). Integer outputs are compared exactly. The CUDA kernel against its
plain version is in test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import concepthash_tpu.ops.topk_select as jts
import concepthash_tpu_torch.ops.topk_select as tts


def _signs(rng, n, nbit):
    s = np.sign(rng.standard_normal((n, nbit))).astype(np.float32)
    s[s == 0] = 1.0
    return s


def _dense_dist(q, db):
    nbit = q.shape[1]
    return 0.5 * (nbit - np.where(q > 0, 1, -1) @ np.where(db > 0, 1, -1).T)


@pytest.mark.parametrize("nbit", [16, 32, 64, 128])
def test_pack_bitplane_matches_jax(rng, nbit):
    """From signs (exact zeros count as -1) and from the 128-lane form, with
    N ragged to P (pack-pad slots) and to 8 packed rows (byte-pad rows): the
    same bytes and count as the reference's, and the same unpacking."""
    P = 128 // nbit
    N = 8 * P * 5 + P + 1 if P > 1 else 8 * 5 + 3
    db = _signs(rng, N, nbit)
    db[1, :3] = 0.0
    jb, jn = jts.pack_bitplane_serving(jnp.asarray(db), nbit=nbit)
    tb, tn = tts.pack_bitplane_serving(torch.tensor(db), nbit=nbit)
    assert tb.dtype == torch.uint8 and tn == jn
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tts.unpack_bitplane(tb).numpy(),
                                  np.asarray(jts.unpack_bitplane(jb)))
    back = tts.unpack_bitplane(tb).reshape(-1, nbit).numpy()
    np.testing.assert_array_equal(back[:N], np.where(db > 0, 1, -1))
    assert (back[N:] == -1).all()                  # both pad kinds
    if P > 1:
        packed, _ = tts.pack_serving_gallery(torch.tensor(db))
        jb2, jn2 = jts.pack_bitplane_serving(jnp.asarray(packed.numpy()),
                                             nbit=nbit)
        tb2, tn2 = tts.pack_bitplane_serving(packed, nbit=nbit)
        assert tn2 == jn2 == tn
        np.testing.assert_array_equal(tb2.numpy(), np.asarray(jb2))
        np.testing.assert_array_equal(tb2.numpy(), tb.numpy())


def test_pack_bitplane_rejects_ambiguous_input():
    x = np.ones((8, 128), np.int8)
    with pytest.raises(ValueError, match="ambiguous"):
        jts.pack_bitplane_serving(jnp.asarray(x))
    with pytest.raises(ValueError, match="ambiguous"):
        tts.pack_bitplane_serving(torch.tensor(x))
    bp, n = tts.pack_bitplane_serving(torch.tensor(x), nbit=128)
    assert bp.shape == (1, 128) and n == 8


@pytest.mark.parametrize("unpack", ["i8_stack", "i32_shift", "i8_mask"])
@pytest.mark.parametrize("nbit,out_dtype", [(32, "float32"),
                                            (64, "bfloat16")])
def test_bitplane_mins_match_jax(rng, unpack, nbit, out_dtype):
    """Mins over a gallery with pack-pad slots and byte-pad rows, n_rows
    below the stored rows: equal to the Pallas kernel's on every subblock;
    the reference's grid-pad rows past them read nbit + 1."""
    P, S, Q = 128 // nbit, 32, 16
    N = 8 * P * 21 + P + 1
    q = _signs(rng, Q, nbit)
    q[0, :3] = 0.0
    bp, _ = tts.pack_bitplane_serving(torch.tensor(_signs(rng, N, nbit)))
    n_rows = -(-N // P) - 3                        # cuts into the real rows
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    want = jts.subblock_min_dists_bitplane(
        jnp.asarray(q), jnp.asarray(bp.numpy()), subblock=S, block_g=8,
        interpret=True, out_dtype=jdt, n_rows=n_rows, unpack=unpack)
    got = tts.subblock_min_dists_bitplane(torch.tensor(q), bp, subblock=S,
                                          out_dtype=tdt, n_rows=n_rows,
                                          unpack=unpack)
    m = -(-bp.shape[0] * 8 * P // S)
    assert got.shape == (m, Q) and got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want[:m])
    assert (want[m:] == nbit + 1).all()


def test_bitplane_rejects_unknown_unpack(rng):
    bp, _ = tts.pack_bitplane_serving(torch.tensor(_signs(rng, 64, 64)))
    q = torch.tensor(_signs(rng, 2, 64))
    with pytest.raises(ValueError, match="unpack"):
        tts.subblock_min_dists_bitplane(q, bp, subblock=16, unpack="mxu")
    with pytest.raises(ValueError, match="unpack"):
        tts.exact_topk_bitplane(q, bp, 3, subblock=16, unpack="i4")


def _bitplane_pair(q, bp, k, **kw):
    """Both packages' exact_topk_bitplane on one gallery: distances, indices
    and certificate equal. Returns the port's."""
    jd, ji, jv = jts.exact_topk_bitplane(
        jnp.asarray(q), jnp.asarray(bp.numpy()), k, interpret=True, **kw)
    td, ti, tv = tts.exact_topk_bitplane(torch.tensor(q), bp, k, **kw)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tv == bool(jv)
    return td, ti, tv


def _gallery(rng, kind, N, nbit):
    if kind == "ties":                             # few distinct codes
        return _signs(rng, 12, nbit)[rng.integers(0, 12, N)]
    return _signs(rng, N, nbit)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("branch", ["dense", "direct", "hierarchical"])
def test_exact_topk_bitplane_matches_jax(rng, monkeypatch, branch, kind):
    """nbit 64 at S=32 (two byte rows per subblock), 2,043 codes: one
    pack-pad slot and two byte-pad rows, masked by n_valid. Each branch
    equals the reference; where the certificate holds, the distances are
    the dense top-k's, and the indices always score their distances."""
    nbit, k, Q, N = 64, 9, 5, 2043
    if branch == "hierarchical":
        monkeypatch.setattr(jts, "_INNER_DIRECT_MAX", 8)
        monkeypatch.setattr(tts, "_INNER_DIRECT_MAX", 8)
    cap = 64 if branch == "dense" else 8
    q = _signs(rng, Q, nbit)
    db = _gallery(rng, kind, N, nbit)
    bp, n_pad = tts.pack_bitplane_serving(torch.tensor(db))
    assert bp.shape[0] % 2 == 0 and n_pad == N + 1 + 2 * 2
    td, ti, tv = _bitplane_pair(q, bp, k, subblock=32, cap=cap, n_valid=N)
    dist = _dense_dist(q, db)
    assert ti.max() < N
    np.testing.assert_array_equal(
        np.take_along_axis(dist, ti.numpy(), 1), td.numpy())
    if tv:
        np.testing.assert_array_equal(td.numpy(), np.sort(dist, 1)[:, :k])


def test_bitplane_n_valid_forms_match_jax(rng):
    """n_valid cutting into the real codes, as a Python int (masks the mins'
    rows too) and as a 0-d array (rescore mask only), and no n_valid (the
    all-negative pad codes are served as codes)."""
    nbit, N = 32, 1021                             # P = 4: 3 pad slots
    q = _signs(rng, 4, nbit)
    q[0] = -1.0                                    # nearest to pad codes
    bp, _ = tts.pack_bitplane_serving(torch.tensor(_signs(rng, N, nbit)))
    for nv in (N - 40, None):
        _bitplane_pair(q, bp, 6, subblock=64, cap=4, n_valid=nv)
    jd, ji, jv = jts.exact_topk_bitplane(
        jnp.asarray(q), jnp.asarray(bp.numpy()), 6, subblock=64, cap=4,
        interpret=True, n_valid=jnp.asarray(N - 40))
    td, ti, tv = tts.exact_topk_bitplane(torch.tensor(q), bp, 6, subblock=64,
                                         cap=4, n_valid=torch.tensor(N - 40))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tv == bool(jv) and ti.max() < N - 40


@pytest.mark.parametrize("retry_mult", [1, 2])
def test_bitplane_retry_matches_jax(rng, retry_mult):
    """A tie-heavy gallery whose certificate fails at cap=4: without the
    retry (retry_mult 1) the result stays uncertified, with it (2) the
    second selection runs; both equal the reference."""
    nbit, N = 64, 2048
    q = _signs(rng, 3, nbit)
    db = _gallery(rng, "ties", N, nbit)
    bp, _ = tts.pack_bitplane_serving(torch.tensor(db))
    _, _, first = tts.exact_topk_bitplane(torch.tensor(q), bp, 40,
                                          subblock=16, cap=4, n_valid=N,
                                          retry_mult=1)
    assert not first
    _bitplane_pair(q, bp, 40, subblock=16, cap=4, n_valid=N,
                   retry_mult=retry_mult)


def test_bitplane_rescore_order_matches_jax():
    """Codes at distinct distances from one query (code i flips its first
    i % 65 bits), so a wrong in-subblock code order shows as a wrong index,
    not a tie swap."""
    nbit, N = 64, 512
    q = np.ones((1, nbit), np.float32)
    db = np.ones((N, nbit), np.float32)
    for i in range(N):
        db[i, :min(i % 65, nbit)] = -1.0
    bp, _ = tts.pack_bitplane_serving(torch.tensor(db))
    td, ti, _ = _bitplane_pair(q, bp, 16, subblock=256, cap=1, n_valid=N)
    np.testing.assert_array_equal(
        np.take_along_axis(_dense_dist(q, db), ti.numpy(), 1), td.numpy())


def test_bitplane_ragged_last_subblock_scores_its_own_rows(rng):
    """Deliberate difference: with G % gps != 0 (15 byte rows, 8 per
    subblock) the reference clamps the last subblock's gather to rows
    [G - gps, G) but labels them as its own codes, so its indices do not
    score their distances. The port gathers the subblock's own rows (the
    missing ones are past n_valid and masked): its indices score their
    distances and, certified or not, they are the selected subblocks' best."""
    nbit, S, N = 64, 128, 15 * 16
    q = _signs(rng, 3, nbit)
    db = _signs(rng, N, nbit)
    bp, _ = tts.pack_bitplane_serving(torch.tensor(db))
    assert bp.shape[0] == 15
    dist = _dense_dist(q, db)
    td, ti, _ = tts.exact_topk_bitplane(torch.tensor(q), bp, 5, subblock=S,
                                        cap=1, n_valid=N)
    np.testing.assert_array_equal(
        np.take_along_axis(dist, ti.numpy(), 1), td.numpy())
    jd, ji, _ = jts.exact_topk_bitplane(jnp.asarray(q),
                                        jnp.asarray(bp.numpy()), 5,
                                        subblock=S, cap=1, interpret=True,
                                        n_valid=N)
    assert not (np.take_along_axis(dist, np.asarray(ji), 1)
                == np.asarray(jd)).all()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbit", [16, 32, 64, 128])
def test_bitplane_mins_serving_layout_matches_jax(rng, nbit, out_dtype):
    """The plain version's (Q, m_pad) mins and (Q, m_pad / 64) superblock
    mins, the layout the kernel writes, against the Pallas kernel's (m, Q)
    mins in interpret mode, transposed, padded with nbit + 1 to a multiple
    of 64 and min-reduced here: m = 70 (not a multiple of 64) subblocks of
    S = 8P codes, n_rows masking the tail of the stored rows."""
    P, Q = 128 // nbit, 12
    S = 8 * P
    G = 70                                         # one byte row per subblock
    q = _signs(rng, Q, nbit)
    q[0, :3] = 0.0
    bp, _ = tts.pack_bitplane_serving(torch.tensor(_signs(rng, G * 8 * P,
                                                          nbit)), nbit=nbit)
    assert bp.shape[0] == G
    n_rows = G * 8 - 21              # empties two subblocks, cuts a third
    m = G
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    jm = jts.subblock_min_dists_bitplane(
        jnp.asarray(q), jnp.asarray(bp.numpy()), subblock=S, block_g=8,
        interpret=True, out_dtype=jdt, n_rows=n_rows)
    jm = np.asarray(jm.astype(jnp.float32))[:m].T              # (Q, m)
    m_pad = -(-m // 64) * 64
    want = np.full((Q, m_pad), nbit + 1, np.float32)
    want[:, :m] = jm
    want_sb = want.reshape(Q, -1, 64).min(axis=-1)
    mins, msb = tts._bitplane_mins_reference(
        tts.strict_signs(torch.tensor(q)), bp, n_rows, S, m, tdt,
        superblocks=True)
    assert mins.shape == (Q, m_pad) and msb.shape == (Q, m_pad // 64)
    assert mins.dtype == msb.dtype == tdt
    np.testing.assert_array_equal(mins.float().numpy(), want)
    np.testing.assert_array_equal(msb.float().numpy(), want_sb)
    assert (mins[:, -2 - (m_pad - m):].float() == nbit + 1).all()
    alone, none = tts._bitplane_mins_reference(
        tts.strict_signs(torch.tensor(q)), bp, n_rows, S, m, tdt)
    assert none is None and torch.equal(alone, mins)
