"""The unsupervised hashing objectives (counterpart of
concepthash_tpu/losses/unsupervised.py): CIBHash, Bi-half, SSDH and NSH.

- CIBHash: codes as logits of P(bit = 1), straight-through Bernoulli
  binarization, NT-Xent between two augmented views, plus a KL-to-uniform
  information bottleneck;
- Bi-half: per-bit median thresholding over the batch (half the rows +1 on
  every bit) with a straight-through proxy gradient, and the unsupervised
  structure-matching loss across the two views;
- SSDH: a pairwise semantic structure from the cosine histogram of the
  train codes (two half-gaussian thresholds), built once on the host, and
  a pairwise code-similarity loss against it;
- NSH: a NeuralSort-relaxed listwise loss over code similarities, NT-Xent
  on the continuous latents across views, and a quantization term.

Each loss is ``fn(outputs, onehot, **cfg) -> (total, parts)`` over the
model's output dict, in f32; the two-view losses read the batch as
``[view 1; view 2]``, and no loss reads the labels. ``ssdh_structure`` is
numpy float64 on the host, as the reference's is (population standard
deviations; an int8 matrix with a unit diagonal), so the same codes give
the same structure.
"""

from __future__ import annotations

import numpy as np
import torch

from concepthash_tpu_torch.ops.numerics import l2_normalize

# the reference masks the diagonal with this value, not with -inf
_MASKED = -1e9


def _view_pairs(n: int, device) -> torch.Tensor:
    """Each row's other view in a [v1; v2] batch of 2n rows."""
    r = torch.arange(n, device=device)
    return torch.cat([r + n, r])


def _nt_xent(z: torch.Tensor, temperature: float) -> torch.Tensor:
    """NT-Xent over the 2n rows of ``z`` (the diagonal masked), the other
    view the positive."""
    n2 = z.shape[0]
    zn = l2_normalize(z)
    sim = (zn @ zn.t()) / temperature
    eye = torch.eye(n2, dtype=torch.bool, device=z.device)
    logp = torch.log_softmax(torch.where(eye, _MASKED, sim), dim=-1)
    rows = torch.arange(n2, device=z.device)
    return -logp[rows, _view_pairs(n2 // 2, z.device)].mean()


def cibhash_loss(outputs, onehot, temperature: float = 0.3,
                 beta: float = 1e-3, **_):
    """``outputs['codes']`` are logits of P(bit = 1); the first and second
    halves of the batch are two views of the same images."""
    logits = outputs["codes"].float()
    p = torch.sigmoid(logits)
    n = logits.shape[0] // 2
    # straight-through binarization to +-1 around 0.5
    b = (p > 0.5).float() * 2 - 1
    z = b + (p - p.detach()) * 2
    contrastive = _nt_xent(z[:2 * n], temperature)
    # the information bottleneck: KL(p || Bernoulli(0.5)); the clip has a
    # lower bound only
    eps = 1e-7
    kl = (p * torch.log(torch.clamp(p / 0.5, min=eps))
          + (1 - p) * torch.log(torch.clamp((1 - p) / 0.5, min=eps))) \
        .sum(-1).mean()
    return contrastive + beta * kl, {"contrastive": contrastive, "kl": kl}


def bihalf_binarize(h: torch.Tensor, gamma: float = 6.0) -> torch.Tensor:
    """Per-bit median thresholding: +1 where a value is at least its bit's
    median over the batch, else -1; a straight-through proxy gradient
    scaled by ``gamma``. The median of an even batch is the mean of the two
    middle values, as the reference's ``jnp.median`` takes it (not
    ``torch.median``'s lower one)."""
    s = torch.sort(h, dim=0).values
    n = h.shape[0]
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    b = torch.where(h >= med[None], 1.0, -1.0)
    return b + gamma * (h - h.detach())


def _cos(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (l2_normalize(a) * l2_normalize(c)).sum(-1)


def structure_matching(x: torch.Tensor, h: torch.Tensor, b: torch.Tensor,
                       alpha: float, pow: float) -> tuple:
    """The unsupervised GreedyHash objective: the cosine between the two
    views' binary codes ``b`` matched to their (detached) features' ``x``,
    plus alpha times the codes' ``h`` mean |(|h| - 1)|^pow; an odd last
    row is left out. Features in f32, as the reference's arithmetic is."""
    n = (x.shape[0] // 2) * 2
    half = n // 2
    x = x.float()
    tb = _cos(b[:half], b[half:n])
    tx = _cos(x[:half], x[half:n]).detach()
    loss1 = ((tb - tx) ** 2).mean()
    loss2 = ((h[:n].abs() - 1.0).abs() ** pow).mean()
    return loss1 + alpha * loss2, {"mse": loss1, "quan": loss2}


def bihalf_loss(outputs, onehot, alpha: float = 0.01, gamma: float = 6.0,
                **_):
    """Two-view cosine-structure matching on the bi-half codes (the
    reference routes bihalf through the unsupervised GreedyHash loss)."""
    h = outputs["codes"]
    return structure_matching(outputs["features"], h,
                              bihalf_binarize(h, gamma), alpha, 3.0)


def ssdh_structure(features, alpha: float = 2.0) -> np.ndarray:
    """Pairwise semantic structure from the rows' cosine similarities: 1 at
    or above mean + alpha * std of the upper half, -1 at or below mean -
    alpha * std of the lower half, 0 (ignored) between; int8 with a unit
    diagonal. numpy float64, population standard deviations."""
    f = np.asarray(features, np.float64)
    f = f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-12)
    cos = f @ f.T
    vals = cos[~np.eye(cos.shape[0], dtype=bool)]
    mean = vals.mean()
    right = vals[vals >= mean]
    left = vals[vals < mean]
    t_hi = mean + alpha * right.std()
    t_lo = mean - alpha * left.std()
    S = np.zeros(cos.shape, np.int8)
    S[cos >= t_hi] = 1
    S[cos <= t_lo] = -1
    np.fill_diagonal(S, 1)
    return S


def ssdh_loss(outputs, onehot, S_batch=None, **_):
    """Squared gap between the tanh codes' cosine similarity and the
    structure's +-1, over the pairs the structure does not ignore. Eval
    batches carry no structure: zero there."""
    codes = outputs["codes"]
    if S_batch is None:
        return torch.zeros((), device=codes.device), {}
    hn = l2_normalize(torch.tanh(codes.float()))
    sim = hn @ hn.t()
    S = torch.as_tensor(S_batch, device=codes.device)
    mask = (S != 0).float()
    target = (S > 0).float() * 2 - 1
    loss = (((sim - target) ** 2) * mask).sum() / torch.clamp(mask.sum(),
                                                               min=1.0)
    return loss, {"pairwise": loss}


def nsh_loss(outputs, onehot, tau: float = 1.0, temperature: float = 0.3,
             lambda_q: float = 0.1, lambda_c: float = 1.0, **_):
    """NSH over a [v1; v2] batch: the NeuralSort top row's listwise
    cross-entropy over code similarities (each anchor's other view ranked
    first), NT-Xent on the latents, and 1 - cos(tanh codes, their signs).
    An odd last row (an eval tail; the reference pads its eval batches to
    the full size) is left out."""
    n = outputs["codes"].shape[0] // 2
    n2 = 2 * n
    b = torch.tanh(outputs["codes"][:n2].float())
    z = outputs["latents"][:n2].float()
    nbit = b.shape[1]
    pos = _view_pairs(n, b.device)
    rows = torch.arange(n2, device=b.device)

    # the NeuralSort top-row listwise loss over code similarities
    s = (b @ b.t()) / nbit                              # (2n, 2n) in [-1, 1]
    valid = ~torch.eye(n2, dtype=torch.bool, device=b.device)
    # A[i, j] = sum over valid l of |s[i, j] - s[i, l]|
    diff = (s[:, :, None] - s[:, None, :]).abs()        # (2n, j, l)
    A = torch.where(valid[:, None, :], diff, 0.0).sum(-1)
    m = n2 - 1                                          # candidates an anchor
    r = ((m - 1) * s - A) / max(tau, 1e-6)
    r = torch.where(valid, r, _MASKED)
    sort_loss = -torch.log_softmax(r, dim=-1)[rows, pos].mean()

    contrastive = _nt_xent(z, temperature)

    bn = l2_normalize(b)
    quan = (1.0 - (bn * torch.sign(b) / nbit ** 0.5).sum(-1)).mean()
    total = sort_loss + lambda_c * contrastive + lambda_q * quan
    return total, {"sort": sort_loss, "contrastive": contrastive,
                   "quan": quan}
