"""Retrieval scoring of the PyTorch port against the JAX package on the CPU:
calculate_mAP and calculate_pr_curve over every option the reference has,
the distances they rank by, the label helpers and NMI, and the additions to
ops/hamming.py. mAP, P@k and R@k agree within 1e-5 absolute (f32 sums taken
in another order); Hamming distances, and so the rankings, are identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import concepthash_tpu.ops.hamming as jh
import concepthash_tpu.ops.retrieval as jr
import concepthash_tpu_torch.ops.hamming as th
import concepthash_tpu_torch.ops.retrieval as tr

ATOL = 1e-5


def _data(rng, nq=23, ndb=67, nbit=16, nclass=5, multilabel=False):
    q = rng.standard_normal((nq, nbit)).astype(np.float32)
    db = rng.standard_normal((ndb, nbit)).astype(np.float32)
    if multilabel:
        ql = (rng.random((nq, nclass)) < 0.3).astype(np.float32)
        dbl = (rng.random((ndb, nclass)) < 0.3).astype(np.float32)
    else:
        ql = np.eye(nclass, dtype=np.float32)[rng.integers(0, nclass, nq)]
        dbl = np.eye(nclass, dtype=np.float32)[rng.integers(0, nclass, ndb)]
    return db, dbl, q, ql


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0, atol=ATOL)


def _map_pair(args, **kw):
    want = jr.calculate_mAP(*args, **kw)
    got = tr.calculate_mAP(*args, device="cpu", **kw)
    for g, w in zip(got, want):
        _close(g, w)
    return got


@pytest.mark.parametrize("R", [-1, 10, [5, 20, -1]])
@pytest.mark.parametrize("dist_metric", ["hamming", "cosine", "euclidean"])
def test_map_matches_jax(rng, R, dist_metric):
    _map_pair(_data(rng), R=R, dist_metric=dist_metric, PRs=(1, 5, 10, 100))


@pytest.mark.parametrize("option", ["remove_first_retrieved", "zero_mean",
                                    "threshold", "chunked", "multilabel",
                                    "int_labels"])
def test_map_options_match_jax(rng, option):
    """Each scoring option alone: self-retrieval dropping rank 0, zero-mean
    codes, ternary codes, 5-query chunks, multi-hot labels, and 1-d class
    ids whose query split lacks the top class."""
    kw = dict(R=[10, -1], PRs=(1, 5, 10))
    db, dbl, q, ql = _data(rng, multilabel=option == "multilabel")
    if option == "remove_first_retrieved":
        q, ql = db[:20], dbl[:20]
        kw["remove_first_retrieved"] = True
    elif option == "zero_mean":
        db, q = db + 0.7, q + 0.7
        kw["zero_mean"] = True
    elif option == "threshold":
        kw["threshold"] = 0.4
    elif option == "chunked":
        kw["chunk_size"] = 5
    elif option == "int_labels":
        dbl = rng.integers(0, 5, db.shape[0])
        ql = rng.integers(0, 4, q.shape[0])
    _map_pair((db, dbl, q, ql), **kw)


def test_map_with_relevance_matrix_matches_jax(rng):
    db, dbl, q, ql = _data(rng)
    rel = rng.random((q.shape[0], db.shape[0])) < 0.2
    rel[3] = False                                  # a query with no match
    _map_pair((db, dbl, q, ql), R=[10, -1], PRs=(1, 5), rel_matrix=rel)


def test_map_empty_split():
    db = np.zeros((0, 16), np.float32)
    q = np.ones((3, 16), np.float32)
    labels = np.zeros((0, 4), np.float32)
    ql = np.eye(4, dtype=np.float32)[[0, 1, 2]]
    assert tr.calculate_mAP(db, labels, q, ql, R=[5, -1], PRs=(1, 5),
                            device="cpu") == ([0.0, 0.0], [0.0, 0.0],
                                              [0.0, 0.0])
    assert tr.calculate_mAP(q, ql, db, labels, device="cpu") == (
        0.0, [0.0] * 3, [0.0] * 3)


def test_map_of_sign_codes_is_perfect_when_classes_are_codes(rng):
    """Each class its own code: mAP 1 in both packages."""
    cls = rng.integers(0, 4, 40)
    centers = np.sign(rng.standard_normal((4, 32))).astype(np.float32)
    codes = centers[cls]
    labels = np.eye(4, dtype=np.float32)[cls]
    got = _map_pair((codes, labels, codes, labels), R=-1, PRs=(1,))
    assert abs(got[0] - 1.0) < ATOL


@pytest.mark.parametrize("remove_first", [False, True])
def test_pr_curve_matches_jax(rng, remove_first):
    db, dbl, q, ql = _data(rng, ndb=120)
    if remove_first:
        q, ql = db[:30], dbl[:30]
    want = jr.calculate_pr_curve(db, dbl, q, ql, num_points=20,
                                 remove_first_retrieved=remove_first)
    got = tr.calculate_pr_curve(db, dbl, q, ql, num_points=20,
                                remove_first_retrieved=remove_first,
                                device="cpu")
    assert got[2] == want[2]
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("dist_metric,threshold", [("hamming", 0.0),
                                                   ("hamming", 0.4),
                                                   ("cosine", 0.0),
                                                   ("euclidean", 0.0)])
def test_distances_and_rankings_match_jax(rng, dist_metric, threshold):
    """Hamming distances (packed and ternary) are identical, so are their
    stable rankings; cosine and euclidean agree to f32 rounding and rank
    the same on these codes."""
    _, _, q, _ = _data(rng)
    db = _data(rng)[0]
    want = np.asarray(jr.compute_distances(jnp.asarray(q), jnp.asarray(db),
                                           dist_metric, threshold))
    got = tr.compute_distances(torch.tensor(q), torch.tensor(db),
                               dist_metric, threshold).float().numpy()
    if dist_metric == "hamming":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(np.argsort(got, 1, kind="stable"),
                                  np.argsort(want, 1, kind="stable"))


def test_get_sim_log_trick_and_nmi_match_jax(rng):
    y1 = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    y2 = np.eye(3, dtype=np.float32)[[0, 0, 2]]
    np.testing.assert_array_equal(tr.get_sim(y1, y2).numpy(),
                                  np.asarray(jr.get_sim(y1, y2)))
    ids1, ids2 = np.array([0, 1, 2, 0]), np.array([0, 0, 2])
    np.testing.assert_array_equal(tr.get_sim(ids1, ids2).numpy(),
                                  np.asarray(jr.get_sim(ids1, ids2)))
    np.testing.assert_array_equal(
        tr.get_sim(y1, y2, onehot=False).numpy(),
        np.asarray(jr.get_sim(y1, y2, onehot=False)))
    x = np.array([-100.0, -1.0, 0.0, 1.0, 100.0], np.float32)
    np.testing.assert_allclose(tr.log_trick(torch.tensor(x)).numpy(),
                               np.asarray(jr.log_trick(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    a = rng.integers(0, 5, 200)
    b = (a + (rng.random(200) < 0.3) * rng.integers(0, 5, 200)) % 6
    for u, v in ((a, b), (a, a), (np.zeros(5), np.zeros(5)),
                 (a, np.zeros(200))):
        assert tr.normalized_mutual_info(u, v) == jr.normalized_mutual_info(
            u, v)


def test_hamming_additions_match_jax(rng):
    """ternary_sign, hamming_signs, get_hamm_dist (plain and normalized)
    and pack_bits_np equal the reference's."""
    q = rng.standard_normal((6, 40)).astype(np.float32)
    db = rng.standard_normal((9, 40)).astype(np.float32)
    q[0, :4] = 0.0
    for t in (0.0, 0.5):
        np.testing.assert_array_equal(
            th.ternary_sign(torch.tensor(q), t).numpy(),
            np.asarray(jh.ternary_sign(jnp.asarray(q), t)))
        np.testing.assert_array_equal(
            th.hamming_signs(torch.tensor(q), torch.tensor(db), t).numpy(),
            np.asarray(jh.hamming_signs(jnp.asarray(q), jnp.asarray(db), t)))
        for norm in (False, True):
            np.testing.assert_array_equal(
                th.get_hamm_dist(q, db, t, normalize=norm).numpy(),
                np.asarray(jh.get_hamm_dist(q, db, t, normalize=norm)))
    for shape in ((7, 40), (3, 2, 64), (5, 16)):
        x = rng.standard_normal(shape).astype(np.float32)
        got = th.pack_bits_np(x, 0.1)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, jh.pack_bits_np(x, 0.1))
        np.testing.assert_array_equal(
            got.view(np.int32), th.pack_bits(torch.tensor(x), 0.1).numpy())
