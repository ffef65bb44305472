"""The shallow (non-gradient) hashing fits: ITQ, PCA (with its whitenings),
LSH and SH (counterpart of concepthash_tpu/losses/shallow.py).

Each fit takes the whole (N, D) train feature matrix once and returns a
state dict of plain arrays and its ``kind``; ``encode_shallow(state,
features)`` gives the real codes, which retrieval signs. These are host
fits in numpy float64 (``train/codebook.py`` ``itq_fit``, ``pca_fit``,
``pca_transform``), as the reference's are, so the same features give the
same codes; the features come off the card once, and the fit's cost is the
host's.
"""

from __future__ import annotations

import numpy as np

from concepthash_tpu_torch.train.codebook import (itq_fit, pca_fit,
                                                  pca_transform)


def fit_itq(features: np.ndarray, nbit: int, iters: int = 100,
            seed: int = 42):
    mean, comps, scale, r = itq_fit(features, nbit, iters=iters, seed=seed)
    return {"kind": "itq", "mean": mean, "comps": comps, "scale": scale,
            "r": r}


def fit_pca(features: np.ndarray, nbit: int, whiten: str | bool = False,
            **_):
    """``whiten``: False, True or 'pca' (scaled to unit variance), 'zca'
    (rotated back into the input's orientation) or 'cholesky'."""
    mean, comps, scale = pca_fit(features, nbit, whiten=bool(whiten))
    state = {"kind": "pca", "mean": mean, "comps": comps, "scale": scale}
    if whiten == "zca":
        state["post_rot"] = comps.T.astype(np.float32)
    elif whiten == "cholesky":
        cov = np.cov(pca_transform(features, mean, comps, scale).T)
        cov = np.atleast_2d(cov) + 1e-6 * np.eye(nbit)
        state["post_rot"] = np.linalg.cholesky(np.linalg.inv(cov)) \
            .astype(np.float32)
    return state


def fit_lsh(features: np.ndarray, nbit: int, seed: int = 42, **_):
    """Random gaussian hyperplanes (unit columns) over mean-centered
    features."""
    rng = np.random.default_rng(seed)
    mean = features.mean(axis=0)
    w = rng.standard_normal((features.shape[1], nbit)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0, keepdims=True)
    return {"kind": "lsh", "mean": mean.astype(np.float32), "w": w}


def fit_sh(features: np.ndarray, nbit: int, **_):
    """Spectral Hashing: the PCA box, then the ``nbit`` one-dimensional
    Laplacian eigenfunctions sin(k pi x / range) of the smallest
    eigenvalues (k / range_d)^2. The modes sort as (eigenvalue, d, k)
    tuples: ties break by the dimension, then by the frequency."""
    mean, comps, scale = pca_fit(features, nbit)
    z = pca_transform(features, mean, comps, scale)
    mn = z.min(axis=0)
    mx = z.max(axis=0)
    rng_ = np.maximum(mx - mn, 1e-6)
    eigs = [((k / rng_[d]) ** 2, d, k) for d in range(z.shape[1])
            for k in range(1, nbit + 1)]
    eigs.sort()
    modes = np.array([(d, k) for _, d, k in eigs[:nbit]], np.int64)
    return {"kind": "sh", "mean": mean.astype(np.float32), "comps": comps,
            "scale": scale, "mn": mn.astype(np.float32),
            "rng": rng_.astype(np.float32), "modes": modes}


def encode_shallow(state: dict, features: np.ndarray) -> np.ndarray:
    """The (N, nbit) float32 real codes of ``features`` under a fit."""
    kind = state["kind"]
    if kind == "itq":
        z = pca_transform(features, state["mean"], state["comps"],
                          state["scale"])
        return (z @ state["r"]).astype(np.float32)
    if kind == "pca":
        z = pca_transform(features, state["mean"], state["comps"],
                          state["scale"])
        if "post_rot" in state:
            z = z @ state["post_rot"]
        return z.astype(np.float32)
    if kind == "lsh":
        return ((features - state["mean"]) @ state["w"]).astype(np.float32)
    if kind == "sh":
        z = pca_transform(features, state["mean"], state["comps"],
                          state["scale"])
        x01 = (z - state["mn"]) / state["rng"]
        d = state["modes"][:, 0]
        k = state["modes"][:, 1]
        return np.sin(np.pi * k[None, :] * x01[:, d]).astype(np.float32)
    raise ValueError(kind)


FITTERS = {"itq": fit_itq, "pca": fit_pca, "lsh": fit_lsh, "sh": fit_sh}
