"""Codebook generation, an explicit and cached stage before the model is
built (counterpart of concepthash_tpu/train/codebook.py).

Methods (``get_codebook``): N gaussian; B Bernoulli +-1; H Hadamard (the CSQ
recipe); O max-min-Hamming random search; L CLIP text embeddings of
class-name prompts, binarized by itq / pca / pcaw / rand, or returned raw
with ``quantized=False`` (ConceptHash's continuous centers), or by the
autoencoder binarizers (``ae_fit``: ``ae``, ``ae_cossim``,
``ae_norm_cossim``, with the ``non`` and ``induced_`` prefixes); file, a
matrix from ``path``. The linear algebra is numpy with the reference's sign
conventions, so the same inputs and seed give the same codebook.

The text stage runs the CLIP text tower and tokenizer of ``model_id`` from
the local disk (``models.clip_loader.load_text_tower``,
``models.tokenizer.CLIPTokenizer``; a directory, or the Hugging Face cache)
on ``device``, or the tower and tokenizer the caller gives; where neither
is there, ``embed_class_names`` raises, as the reference does offline, and
the experiment takes its offline fallback. Nothing is downloaded. The same
stage gives FILIP's token-level class-text embeddings
(``embed_class_name_tokens``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.models.layers import dense
from concepthash_tpu_torch.ops.numerics import l2_normalize

# ---------------------------------------------------------------------------
# deterministic linear algebra helpers
# ---------------------------------------------------------------------------


def pca_fit(x: np.ndarray, k: int, whiten: bool = False):
    """Deterministic PCA via SVD with sign fixing (largest-|loading| positive).
    Returns (mean, components (k, D), scale (k,))."""
    x = np.asarray(x, np.float64)
    if k > min(x.shape):
        raise ValueError(f"PCA to {k} dims needs >= {k} samples and features; "
                         f"got {x.shape} (same constraint as sklearn PCA)")
    mean = x.mean(axis=0)
    xc = x - mean
    _, s, vt = np.linalg.svd(xc, full_matrices=False)
    comps = vt[:k]
    # sign convention: flip so the max-abs element of each component is >0
    signs = np.sign(comps[np.arange(comps.shape[0]),
                          np.abs(comps).argmax(axis=1)])
    signs[signs == 0] = 1.0
    comps = comps * signs[:, None]
    if whiten:
        scale = np.sqrt(x.shape[0] - 1) / np.maximum(s[:k], 1e-12)
    else:
        scale = np.ones(k)
    return mean, comps.astype(np.float32), scale.astype(np.float32)


def pca_transform(x, mean, comps, scale):
    return ((np.asarray(x) - mean) @ comps.T) * scale


def itq_fit(v: np.ndarray, nbit: int, iters: int = 100, seed: int = 42):
    """ITQ: PCA to nbit dims then alternating-minimization rotation.
    Returns (mean, comps, scale, R)."""
    mean, comps, scale = pca_fit(v, nbit)
    z = pca_transform(v, mean, comps, scale)
    rng = np.random.default_rng(seed)
    r = np.linalg.qr(rng.standard_normal((nbit, nbit)))[0]
    for _ in range(iters):
        b = np.sign(z @ r)
        u, _, vt = np.linalg.svd(b.T @ z)
        r = (u @ vt).T
    return mean, comps, scale, r.astype(np.float32)


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester Hadamard (n must be a power of 2)."""
    if not (n > 0 and (n & (n - 1)) == 0):
        raise ValueError("nbit must be a power of 2 for 'H'")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_codebook(nclass: int, nbit: int, seed: int = 42) -> np.ndarray:
    """CSQ's Hadamard centers: rows of [H; -H], Bernoulli fill if nclass >
    2*nbit."""
    h = hadamard_matrix(nbit)
    h2 = np.concatenate([h, -h], axis=0)
    if nclass <= h2.shape[0]:
        return h2[:nclass].astype(np.float32)
    rng = np.random.default_rng(seed)
    extra = np.ones((nclass - h2.shape[0], nbit), np.float32)
    for row in extra:
        flip = rng.choice(nbit, nbit // 2, replace=False)
        row[flip] = -1
    return np.concatenate([h2, extra]).astype(np.float32)


def maxmin_hamming_codebook(nclass: int, nbit: int, seed: int = 42,
                            maxtries: int = 10000, initdist: float = 0.61,
                            mindist: float = 0.2, reducedist: float = 0.05):
    """'O' method: rejection-sample +-1 rows with pairwise normalized-Hamming
    distance above a shrinking threshold."""
    rng = np.random.default_rng(seed)
    rows = []
    curr = initdist
    fails = 0
    while len(rows) < nclass:
        c = np.sign(rng.standard_normal(nbit)).astype(np.float32)
        c[c == 0] = 1
        ok = all(0.5 * (nbit - c @ r) / nbit >= curr for r in rows)
        if ok:
            rows.append(c)
            fails = 0
        else:
            fails += 1
            if fails >= maxtries:
                fails = 0
                curr -= reducedist
                if curr < mindist:
                    raise ValueError("cannot find a codebook at this bit width")
    out = np.stack(rows)
    return out[rng.permutation(nclass)]


# ---------------------------------------------------------------------------
# language-guided codebook
# ---------------------------------------------------------------------------

def _text_stage(class_names: list, model_id: str, prompt_prefix: str,
                prompt_postfix: str, text_tower, tokenizer, device):
    """The prompts' token ids (padded to the longest prompt with the
    checkpoint's pad id) and the text tower, each read from ``model_id``
    on the local disk when the caller gives none."""
    if prompt_prefix and not prompt_prefix.endswith(" "):
        prompt_prefix += " "
    prompts = [f"{prompt_prefix}{name}{prompt_postfix}" for name in class_names]
    logging.info("codebook prompts: e.g. %r", prompts[0])
    if tokenizer is None:
        from concepthash_tpu_torch.models.tokenizer import CLIPTokenizer
        from concepthash_tpu_torch.utils.hf_local import resolve_local

        tokenizer = CLIPTokenizer.from_dir(resolve_local(model_id))
    if text_tower is None:
        from concepthash_tpu_torch.models.clip_loader import load_text_tower

        text_tower = load_text_tower(model_id, device=device)
        logging.info("codebook: CLIP text tower of %s on %s", model_id,
                     next(text_tower.parameters()).device)
    ids = tokenizer(prompts, padding=True, truncation=True, max_length=77,
                    return_tensors="np")["input_ids"].astype(np.int64)
    return ids, text_tower


def embed_class_names(class_names: list,
                      model_id: str = "openai/clip-vit-base-patch32",
                      prompt_prefix: str = "a photo of a ",
                      prompt_postfix: str = "", batch_size: int = 100,
                      text_tower=None, tokenizer=None,
                      device=None) -> np.ndarray:
    """CLIP-text pooled embeddings of "<prefix><class name><postfix>"
    prompts, (nclass, width) float32: the pre-projection pooled output.

    ``text_tower`` is a ``models.clip.ClipTextTower``; ``tokenizer`` is
    called as a Hugging Face tokenizer is (``tokenizer(prompts, padding=True,
    truncation=True, max_length=77, return_tensors='np')['input_ids']``).
    Either one not given is read from ``model_id`` on the local disk (the
    tower onto ``device``, CUDA unless asked otherwise); raises ``OSError``
    when it is not there."""
    ids, tower = _text_stage(class_names, model_id, prompt_prefix,
                             prompt_postfix, text_tower, tokenizer, device)
    return _run_tower(tower, ids, batch_size, lambda out: out["pooled"])


def embed_class_name_tokens(class_names: list,
                            model_id: str = "openai/clip-vit-base-patch32",
                            prompt_prefix: str = "a photo of a ",
                            prompt_postfix: str = "", batch_size: int = 100,
                            text_tower=None, tokenizer=None,
                            device=None) -> np.ndarray:
    """Token-level text embeddings for FILIP: each prompt's
    ``last_hidden_state`` projected by the tower's ``text_projection``,
    (nclass, T, projection width) float32, T the longest prompt's length.
    The pad positions are in (FILIP's max runs over them), so the pad id is
    the checkpoint's. Arguments as ``embed_class_names``."""
    ids, tower = _text_stage(class_names, model_id, prompt_prefix,
                             prompt_postfix, text_tower, tokenizer, device)
    return _run_tower(tower, ids, batch_size, lambda out: dense(
        tower.text_projection, out["last_hidden_state"], tower.dtype))


def _run_tower(tower, ids: np.ndarray, batch_size: int, pick) -> np.ndarray:
    dev = next(tower.parameters()).device
    outs = []
    with torch.inference_mode():
        for s in range(0, len(ids), batch_size):
            batch = torch.from_numpy(ids[s:s + batch_size]).to(dev)
            outs.append(pick(tower(input_ids=batch)).float().cpu().numpy())
    return np.concatenate(outs).astype(np.float32)


def ae_init(d: int, nbit: int, method: str = "ae", n_induced: int = 1000,
            seed: int = 42) -> dict:
    """The binarizer's own initial parameters for ``method`` on
    d-dimensional embeddings, as float32 numpy arrays in the reference's
    layout, from a torch generator seeded by ``seed``: U(+-1/sqrt(fan_in))
    weights, zero biases, N(0, 1) induced queries (the reference's laws;
    its draws are jax.random's)."""
    g = torch.Generator().manual_seed(seed)

    def layer(din, dout):
        lim = 1.0 / np.sqrt(din)
        return {"w": ((torch.rand(din, dout, generator=g) * 2 - 1) * lim)
                .numpy(), "b": np.zeros(dout, np.float32)}

    nonlinear = method.replace("induced_", "").startswith("non")
    shapes = ({"e1": (d, d), "e2": (d, nbit), "d1": (nbit, d), "d2": (d, d)}
              if nonlinear else {"e": (d, nbit), "d": (nbit, d)})
    params = {k: layer(*v) for k, v in shapes.items()}
    if "induced_" in method:
        params["queries"] = torch.randn(n_induced, d, generator=g).numpy()
    return params


def _rescaled(g: torch.Tensor) -> torch.Tensor:
    return (g - g.min()) / (g.max() - g.min()) * 2.0 - 1.0


def ae_fit(embedding: np.ndarray, nbit: int, method: str = "ae",
           iters: int = 10000, t: float = 1.0, identity_scale: float = 1.0,
           seed: int = 42, lr: float = 1e-4, n_induced: int = 1000,
           init: dict | None = None, device=None) -> np.ndarray:
    """The autoencoder binarizer: an encoder and a decoder trained on the
    class embeddings by full-batch Adam (``lr``, ``iters`` steps) on

      MSE reconstruction
      + exp(-rec / t) * (1 - cos(b, sign(b)))         (quantization)
      + identity_scale * mean((G_target - G_binary)^2)

    where G_target is I (``ae``), the embeddings' cosine Gram matrix
    (``ae_cossim``) or its min-max rescaling to [-1, 1]
    (``ae_norm_cossim``); with the ``induced_`` prefix both Gram matrices
    come from ``n_induced`` learned queries attending to the embeddings and
    to the codes. A ``non`` prefix makes the encoder and the decoder
    two-layer tanh-approximated GELU MLPs. Returns the real-valued codes
    (nclass, nbit); the caller signs them.

    ``init``: initial parameters as numpy arrays in the reference's layout
    ({'e': {'w', 'b'}, 'd': ...}, or 'e1', 'e2', 'd1', 'd2', and
    'queries'), else ``ae_init``'s, seeded by ``seed``. Runs on ``device``
    (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    variant = method
    induced = "induced_" in variant
    variant = variant.replace("induced_", "")
    nonlinear = variant.startswith("non")
    variant = variant.replace("non", "")  # nonae -> ae

    x = torch.as_tensor(np.asarray(embedding, np.float32), device=dev)
    n, d = x.shape
    if init is None:
        init = ae_init(d, nbit, method, n_induced, seed)
    def leaf(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev,
                            requires_grad=True)

    params = {k: ({f: leaf(a) for f, a in v.items()}
                  if isinstance(v, dict) else leaf(v))
              for k, v in init.items()}
    leaves = [p for v in params.values()
              for p in (v.values() if isinstance(v, dict) else (v,))]

    def lin(p, z):
        return z @ p["w"] + p["b"]

    if nonlinear:
        def enc(p, z):
            return lin(p["e2"], F.gelu(lin(p["e1"], z), approximate="tanh"))

        def dec(p, b):
            return lin(p["d2"], F.gelu(lin(p["d1"], b), approximate="tanh"))
    else:
        def enc(p, z):
            return lin(p["e"], z)

        def dec(p, b):
            return lin(p["d"], b)

    gram_target = None
    if not induced:
        with torch.no_grad():
            if variant == "ae_cossim":
                gram_target = l2_normalize(x) @ l2_normalize(x).t()
            elif variant == "ae_norm_cossim":
                gram_target = _rescaled(l2_normalize(x) @ l2_normalize(x).t())
            else:                   # plain ae: the orthogonality target
                gram_target = torch.eye(n, device=dev)

    def loss_fn(p):
        b = enc(p, x)
        rec_loss = ((x - dec(p, b)) ** 2).mean(dim=-1)          # (n,)
        bl2 = l2_normalize(b)
        if induced:
            attn_t = l2_normalize(l2_normalize(p["queries"])
                                  @ l2_normalize(x).t())
            g_t = attn_t @ attn_t.t()
            if variant == "ae_norm_cossim":
                g_t = _rescaled(g_t)
            attn_b = l2_normalize(l2_normalize(enc(p, p["queries"]))
                                  @ bl2.t())
            g_b = attn_b @ attn_b.t()
        else:
            g_t, g_b = gram_target, bl2 @ bl2.t()
        identity_loss = ((g_t - g_b) ** 2).mean()
        quan = 1.0 - (bl2 * l2_normalize(torch.sign(b).detach())).sum(-1)
        return (rec_loss.mean() + (torch.exp(-rec_loss / t) * quan).mean()
                + identity_scale * identity_loss)

    # Adam as optax's: bias-corrected moments (float32 corrections from a
    # step count on the device), eps outside the square root
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = [torch.zeros_like(q) for q in leaves]
    nu = [torch.zeros_like(q) for q in leaves]
    count = torch.zeros((), device=dev)

    def iteration():
        grads = torch.autograd.grad(loss_fn(params), leaves)
        with torch.no_grad():
            count.add_(1.0)
            c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
            for q, g_, m, v in zip(leaves, grads, mu, nu):
                m.mul_(b1).add_(g_, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g_, g_, value=1.0 - b2)
                q.sub_(lr * ((m / c1) / ((v / c2).sqrt() + eps)))

    _repeat(iteration, int(iters), dev)
    with torch.no_grad():
        return enc(params, x).cpu().numpy().astype(np.float32)


def _repeat(iteration, n: int, device: torch.device) -> None:
    """``iteration()`` n times. On the card: three eager iterations on a
    side stream (real ones), then the rest as replays of one CUDA graph of
    an iteration (its shapes are static; the host would set the pace of a
    loop of ~60 small kernels)."""
    warm = 3
    if device.type != "cuda" or n <= warm:
        for _ in range(n):
            iteration()
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warm):
            iteration()
    torch.cuda.current_stream(device).wait_stream(side)
    from concepthash_tpu_torch.train.graphs import CAPTURE_ERROR_MODE

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode=CAPTURE_ERROR_MODE):
        iteration()
    for _ in range(n - warm):
        graph.replay()


def binarize_embedding(embedding: np.ndarray, nbit: int, method: str = "pca",
                       seed: int = 42, **ae_kwargs) -> np.ndarray:
    """Continuous (nclass, D) -> real-valued (nclass, nbit) targets; the
    caller signs them. ``ae_kwargs`` go to ``ae_fit`` (``iters``, ``t``,
    ``identity_scale``, ``device``)."""
    if method == "itq":
        mean, comps, scale, r = itq_fit(embedding, nbit, seed=seed)
        return (pca_transform(embedding, mean, comps, scale) @ r).astype(
            np.float32)
    if method == "pca":
        mean, comps, scale = pca_fit(embedding, nbit)
        return pca_transform(embedding, mean, comps, scale).astype(np.float32)
    if method == "pcaw":
        mean, comps, scale = pca_fit(embedding, nbit, whiten=True)
        return pca_transform(embedding, mean, comps, scale).astype(np.float32)
    if method == "rand":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(embedding.shape[1])[:nbit]
        return embedding[:, idx].astype(np.float32)
    if "ae" in method:  # ae / nonae / [induced_]ae[_cossim|_norm_cossim]
        return ae_fit(embedding, nbit, method=method, seed=seed, **ae_kwargs)
    raise ValueError(f"unknown binary_method {method!r} "
                     "(supported: itq, pca, pcaw, rand, ae*)")


def _load_codebook_file(path: str) -> np.ndarray:
    """'codebook' of a .npy matrix, a port checkpoint (.pt) or a JAX
    package checkpoint (.msgpack)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".msgpack"):
        from concepthash_tpu_torch.utils.io import load_jax_checkpoint

        return np.asarray(load_jax_checkpoint(path)["codebook"], np.float32)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return np.asarray(blob["codebook"], np.float32)


def get_codebook(codebook_method: str, nclass: int, nbit: int, seed: int = 42,
                 class_name_path: str | None = None,
                 class_names: list | None = None,
                 model_id: str = "openai/clip-vit-base-patch32",
                 binary_method: str = "pca", quantized: bool = True,
                 prompt_prefix: str = "a photo of a ",
                 prompt_postfix: str = "", text_embedder=None,
                 path: str | None = None, ae_iters: int = 10000,
                 t: float = 1.0, identity_scale: float = 1.0, device=None,
                 **_ignored) -> np.ndarray:
    """The codebook factory. 'L' with quantized=False returns the raw text
    embeddings (ConceptHash's centers); every other path returns a signed
    (nclass, nbit) +-1 matrix. ``text_embedder(class_names)`` replaces the
    CLIP text stage, which otherwise runs on ``device``, as the
    autoencoder binarizers (``ae_iters``, ``t``, ``identity_scale``) do.
    'file' loads a (nclass, D) matrix from ``path``, signed unless
    quantized=False."""
    rng = np.random.default_rng(seed)
    if codebook_method == "file":
        cb = _load_codebook_file(path)
        if cb.shape[0] != nclass:
            raise ValueError(f"codebook file {path}: {cb.shape[0]} rows for "
                             f"{nclass} classes")
        if not quantized:
            return cb
    elif codebook_method == "N":
        cb = rng.standard_normal((nclass, nbit)).astype(np.float32)
    elif codebook_method == "B":
        cb = (rng.random((nclass, nbit)) < 0.5).astype(np.float32) * 2 - 1
    elif codebook_method == "H":
        cb = hadamard_codebook(nclass, nbit, seed)
    elif codebook_method == "O":
        cb = maxmin_hamming_codebook(nclass, nbit, seed)
    elif codebook_method == "L":
        if class_names is None:
            from concepthash_tpu_torch.data.manifest import read_class_names

            class_names = read_class_names(os.path.dirname(class_name_path),
                                           os.path.basename(class_name_path))
        if text_embedder is not None:
            embedding = np.asarray(text_embedder(class_names), np.float32)
        else:
            embedding = embed_class_names(class_names, model_id,
                                          prompt_prefix, prompt_postfix,
                                          device=device)
        if not quantized:
            return embedding
        ae_kw = ({"iters": int(ae_iters), "t": float(t),
                  "identity_scale": float(identity_scale), "device": device}
                 if "ae" in binary_method else {})
        cb = binarize_embedding(embedding, nbit, binary_method, seed, **ae_kw)
    else:
        raise ValueError(f"unknown codebook_method {codebook_method!r}")

    signed = np.sign(cb).astype(np.float32)
    signed[signed == 0] = 1.0
    return signed


def load_or_create_codebook(cache_path: str, **kwargs) -> np.ndarray:
    """``get_codebook(**kwargs)``, cached at ``cache_path`` (the port's own
    file, ``torch.save`` of {'codebook': array})."""
    if os.path.exists(cache_path):
        blob = torch.load(cache_path, map_location="cpu", weights_only=True)
        return np.asarray(blob["codebook"])
    cb = get_codebook(**kwargs)
    os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
    torch.save({"codebook": torch.from_numpy(cb)}, cache_path)
    return cb
