"""k-means on the run's device, for ODC's initial clustering (the
reference clusters with ``sklearn.cluster.KMeans(n_init=3,
random_state=seed)``; the port needs no sklearn).

``kmeans(x, k, seed)`` follows sklearn's dense Lloyd k-means at its
defaults: greedy k-means++ seeding (the first center uniform, then
``2 + int(log k)`` candidates a center drawn in proportion to the squared
distance to the closest center, the one that lowers the potential most
kept), Lloyd iterations up to ``max_iter`` 300 that stop when no label
changes or the centers' total squared shift falls to ``tol`` (1e-4) times
the mean of the feature variances, an empty cluster moved to the point
farthest from its center, the labels assigned once more after a stop on
the shift, and the best of ``n_init`` runs by inertia. It computes in
float64 and draws its random numbers from a CPU generator seeded by
``seed`` (so a run on the card and one on the CPU draw the same numbers);
sklearn's own draws come from numpy and differ.
"""

from __future__ import annotations

import math

import torch


def _sq_dists(x: torch.Tensor, c: torch.Tensor,
              x_sq: torch.Tensor) -> torch.Tensor:
    """(N, K) squared Euclidean distances, clamped at 0."""
    d = x_sq[:, None] - 2.0 * (x @ c.t()) + (c * c).sum(1)[None]
    return d.clamp_min_(0.0)


def _plusplus(x: torch.Tensor, k: int, x_sq: torch.Tensor,
              gen: torch.Generator) -> torch.Tensor:
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    first = int(torch.randint(n, (1,), generator=gen))
    centers = [x[first]]
    closest = _sq_dists(x, x[first:first + 1], x_sq)[:, 0]
    pot = closest.sum()
    for _ in range(1, k):
        u = torch.rand(trials, generator=gen, dtype=torch.float64).to(x.device)
        cand = torch.searchsorted(torch.cumsum(closest, 0), u * pot)
        cand = cand.clamp_max_(n - 1)
        d = torch.minimum(closest[None], _sq_dists(x, x[cand], x_sq).t())
        pots = d.sum(1)
        best = int(torch.argmin(pots))
        pot, closest = pots[best], d[best]
        centers.append(x[cand[best]])
    return torch.stack(centers)


def _lloyd(x: torch.Tensor, centers: torch.Tensor, x_sq: torch.Tensor,
           max_iter: int, tol: float) -> tuple:
    k = centers.shape[0]
    labels_old = None
    strict = False
    for _ in range(max_iter):
        d = _sq_dists(x, centers, x_sq)
        labels = d.argmin(1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = onehot.sum(0)
        sums = onehot.t() @ x
        empty = torch.nonzero(counts == 0).flatten()
        if empty.numel():
            # the points farthest from their centers become the empty
            # clusters' centers, leaving their old clusters
            far = torch.topk(d.gather(1, labels[:, None])[:, 0],
                             empty.numel()).indices
            for e, i in zip(empty.tolist(), far.tolist()):
                old = int(labels[i])
                sums[old] -= x[i]
                counts[old] -= 1
                sums[e] = x[i]
                counts[e] = 1
        new = sums / counts.clamp_min(1)[:, None]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if labels_old is not None and torch.equal(labels, labels_old):
            strict = True
            break
        if float(shift) <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _sq_dists(x, centers, x_sq).argmin(1)
    inertia = _sq_dists(x, centers, x_sq).gather(1, labels[:, None]).sum()
    return labels, centers, float(inertia)


def kmeans(x: torch.Tensor, k: int, seed: int, n_init: int = 3,
           max_iter: int = 300, tol: float = 1e-4) -> tuple:
    """(labels (N,) int64, centers (k, D) float32, inertia) of ``x`` (N, D)
    on its device; the best of ``n_init`` k-means++ starts."""
    xd = x.double()
    mean = xd.mean(0)
    xd = xd - mean              # as sklearn centres the data first
    x_sq = (xd * xd).sum(1)
    tol_abs = float(xd.var(0, unbiased=False).mean()) * tol
    gen = torch.Generator().manual_seed(int(seed))
    best = None
    for _ in range(n_init):
        centers = _plusplus(xd, k, x_sq, gen)
        labels, centers, inertia = _lloyd(xd, centers, x_sq, max_iter,
                                          tol_abs)
        if best is None or inertia < best[2]:
            best = (labels, centers, inertia)
    labels, centers, inertia = best
    return labels, (centers + mean).float(), inertia
