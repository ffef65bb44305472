"""The port's codebook stage against the JAX package's on the CPU: each numpy
function equal (exactly, or within 1e-6 where a float product is involved),
``get_codebook`` for every ported method at both ``quantized`` settings, the
autoencoder binarizers from the reference's initial parameters, the offline
text embedder, the cache, and the unknown methods."""

import numpy as np
import pytest
import torch

from concepthash_tpu.experiments import hashing as jexp
from concepthash_tpu.train import codebook as jcb
from concepthash_tpu.utils import io as jio
from concepthash_tpu_torch.experiments import hashing as texp
from concepthash_tpu_torch.train import codebook as tcb

NAMES = [f"class {i}" for i in range(12)]


def _emb(n=12, d=40, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_equals_reference(whiten):
    x = _emb()
    for a, b in zip(jcb.pca_fit(x, 8, whiten), tcb.pca_fit(x, 8, whiten)):
        np.testing.assert_array_equal(a, b)
    m, c, s = tcb.pca_fit(x, 8, whiten)
    np.testing.assert_array_equal(tcb.pca_transform(x, m, c, s),
                                  jcb.pca_transform(x, m, c, s))
    with pytest.raises(ValueError):
        tcb.pca_fit(x, 13)


def test_itq_equals_reference():
    x = _emb(seed=1)
    for a, b in zip(jcb.itq_fit(x, 8, iters=20, seed=3),
                    tcb.itq_fit(x, 8, iters=20, seed=3)):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("nclass,nbit", [(10, 16), (40, 16), (3, 64)])
def test_hadamard_equals_reference(nclass, nbit):
    np.testing.assert_array_equal(tcb.hadamard_matrix(nbit),
                                  jcb.hadamard_matrix(nbit))
    np.testing.assert_array_equal(tcb.hadamard_codebook(nclass, nbit, 5),
                                  jcb.hadamard_codebook(nclass, nbit, 5))
    with pytest.raises(ValueError):
        tcb.hadamard_matrix(12)


def test_maxmin_hamming_equals_reference():
    np.testing.assert_array_equal(tcb.maxmin_hamming_codebook(10, 16, 2),
                                  jcb.maxmin_hamming_codebook(10, 16, 2))


@pytest.mark.parametrize("method", ["itq", "pca", "pcaw", "rand"])
def test_binarize_embedding_equals_reference(method):
    x = _emb(seed=2)
    np.testing.assert_allclose(tcb.binarize_embedding(x, 8, method, 4),
                               jcb.binarize_embedding(x, 8, method, 4),
                               atol=1e-6)


@pytest.mark.parametrize("method", ["N", "B", "H", "O"])
def test_get_codebook_equals_reference(method):
    kw = dict(codebook_method=method, nclass=12, nbit=16, seed=9)
    np.testing.assert_array_equal(tcb.get_codebook(**kw),
                                  jcb.get_codebook(**kw))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("binary_method", ["pca", "itq"])
def test_language_codebook_equals_reference(tmp_path, quantized,
                                            binary_method):
    names_path = tmp_path / "class_names.txt"
    names_path.write_text("\n".join(n.replace(" ", "_") for n in NAMES)
                          + "\n")
    seen = []

    def embedder(names):
        seen.append(list(names))
        return _emb(len(names), 24, seed=len(names))

    kw = dict(codebook_method="L", nclass=12, nbit=8, seed=1,
              class_name_path=str(names_path), binary_method=binary_method,
              quantized=quantized, text_embedder=embedder)
    got, want = tcb.get_codebook(**kw), jcb.get_codebook(**kw)
    assert seen[0] == seen[1] == NAMES
    assert got.shape == ((12, 8) if quantized else (12, 24))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_file_codebook(tmp_path, quantized):
    cb = _emb(12, 16, seed=3)
    npy = str(tmp_path / "cb.npy")
    np.save(npy, cb)
    kw = dict(codebook_method="file", nclass=12, nbit=16, quantized=quantized)
    np.testing.assert_array_equal(tcb.get_codebook(path=npy, **kw),
                                  jcb.get_codebook(path=npy, **kw))
    pt = str(tmp_path / "cb.pt")
    torch.save({"codebook": torch.from_numpy(cb)}, pt)
    np.testing.assert_array_equal(tcb.get_codebook(path=pt, **kw),
                                  jcb.get_codebook(path=npy, **kw))
    msgpack = str(tmp_path / "cb.msgpack")       # the JAX package's format
    jio.save_checkpoint({"codebook": cb}, msgpack)
    np.testing.assert_array_equal(tcb.get_codebook(path=msgpack, **kw),
                                  jcb.get_codebook(path=msgpack, **kw))
    with pytest.raises(ValueError, match="rows"):
        tcb.get_codebook(path=npy, **dict(kw, nclass=11))


def test_offline_text_embedder_equals_reference():
    np.testing.assert_array_equal(texp.offline_text_embedder(NAMES, dim=32),
                                  jexp.offline_text_embedder(NAMES, dim=32))


def test_load_or_create_codebook_round_trips(tmp_path):
    path = str(tmp_path / "outputs" / "codebook.pt")
    kw = dict(codebook_method="N", nclass=5, nbit=16, seed=2)
    first = tcb.load_or_create_codebook(path, **kw)
    np.testing.assert_array_equal(first, jcb.get_codebook(**kw))
    again = tcb.load_or_create_codebook(path, **dict(kw, seed=3))   # cached
    np.testing.assert_array_equal(again, first)


def _jax_ae_init(method, n, d, nbit, seed, n_induced):
    """The reference ``ae_fit``'s initial parameters (its jax.random draws),
    as numpy arrays in its layout."""
    import jax

    ks = jax.random.split(jax.random.PRNGKey(seed), 8)

    def dense(k, din, dout):
        lim = 1.0 / np.sqrt(din)
        return {"w": np.asarray(jax.random.uniform(k, (din, dout),
                                                   minval=-lim, maxval=lim)),
                "b": np.zeros((dout,), np.float32)}

    if method.replace("induced_", "").startswith("non"):
        p = {"e1": dense(ks[0], d, d), "e2": dense(ks[1], d, nbit),
             "d1": dense(ks[2], nbit, d), "d2": dense(ks[3], d, d)}
    else:
        p = {"e": dense(ks[0], d, nbit), "d": dense(ks[2], nbit, d)}
    if "induced_" in method:
        p["queries"] = np.asarray(jax.random.normal(ks[4], (n_induced, d)))
    return p


@pytest.mark.parametrize("method", ["ae", "nonae", "ae_cossim",
                                    "induced_ae_norm_cossim"])
def test_autoencoder_binarizer_matches_jax(method):
    """200 full-batch Adam iterations at the reference's rate (1e-4) from
    its initial parameters: the real-valued codes within rtol 1e-4, atol
    1e-5, and their signs equal; the port's own seeded init runs through
    ``get_codebook`` to a signed codebook."""
    x, nbit, kw = _emb(), 8, dict(iters=200, seed=3, n_induced=16)
    init = _jax_ae_init(method, *x.shape, nbit, kw["seed"], kw["n_induced"])
    want = jcb.ae_fit(x, nbit, method=method, **kw)
    got = tcb.ae_fit(x, nbit, method=method, init=init, device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    cb = tcb.get_codebook("L", 12, nbit, class_names=NAMES,
                          binary_method=method, ae_iters=20, device="cpu",
                          text_embedder=lambda n: _emb(len(n)))
    assert cb.shape == (12, nbit) and set(np.unique(cb)) <= {-1.0, 1.0}


def test_unknown_methods_raise():
    with pytest.raises(ValueError):
        tcb.get_codebook("Z", 3, 8)
    with pytest.raises(ValueError):
        tcb.binarize_embedding(_emb(), 8, "lsh")
