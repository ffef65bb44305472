"""Codebook generation, an explicit and cached stage before the model is
built (counterpart of concepthash_tpu/train/codebook.py).

Methods (``get_codebook``): N gaussian; B Bernoulli +-1; H Hadamard (the CSQ
recipe); O max-min-Hamming random search; L CLIP text embeddings of
class-name prompts, binarized by itq / pca / pcaw / rand, or returned raw
with ``quantized=False`` (ConceptHash's continuous centers); file, a matrix
from ``path``. The linear algebra is numpy with the reference's sign
conventions, so the same inputs and seed give the same codebook.

The text stage runs the CLIP text tower and tokenizer of ``model_id`` from
the local disk (``models.clip_loader.load_text_tower``,
``models.tokenizer.CLIPTokenizer``; a directory, or the Hugging Face cache)
on ``device``, or the tower and tokenizer the caller gives; where neither
is there, ``embed_class_names`` raises, as the reference does offline, and
the experiment takes its offline fallback. Nothing is downloaded. The same
stage gives FILIP's token-level class-text embeddings
(``embed_class_name_tokens``). Not ported: the autoencoder binarizers
(``ae*``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from concepthash_tpu_torch.models.layers import dense

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


def ae_fit(embedding: np.ndarray, nbit: int, method: str = "ae",
           **_kwargs) -> np.ndarray:
    """The autoencoder binarizer: not ported (a JAX fit in the reference)."""
    raise NotImplementedError(
        f"binary_method {method!r}: the autoencoder binarizers (ae_fit) are "
        "not ported yet (ROADMAP Queue 1 item 10)")


def binarize_embedding(embedding: np.ndarray, nbit: int, method: str = "pca",
                       seed: int = 42) -> np.ndarray:
    """Continuous (nclass, D) -> real-valued (nclass, nbit) targets; the
    caller signs them."""
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
        return ae_fit(embedding, nbit, method=method, seed=seed)
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
                 path: str | None = None, device=None,
                 **_ignored) -> np.ndarray:
    """The codebook factory. 'L' with quantized=False returns the raw text
    embeddings (ConceptHash's centers); every other path returns a signed
    (nclass, nbit) +-1 matrix. ``text_embedder(class_names)`` replaces the
    CLIP text stage, which otherwise runs on ``device``. 'file' loads a
    (nclass, D) matrix from ``path``, signed unless quantized=False."""
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
        cb = binarize_embedding(embedding, nbit, binary_method, seed)
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
