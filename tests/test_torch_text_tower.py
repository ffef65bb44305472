"""The port's CLIP text tower against the JAX package's on the CPU, at a tiny
geometry with random flax parameters carried across by
``weights.text_from_flax``: the ``input_ids`` path (eos pooling, rows with
the eos at different positions and a row with none), the ``inputs_embeds``
path (through ``embeds_adapter``), and ``embed_class_names`` with both towers
and one toy tokenizer. Tolerance: 1e-5 at float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.models.clip import ClipTextConfig as JTextConfig
from concepthash_tpu.models.clip import ClipTextTower as JTextTower
from concepthash_tpu.train import codebook as jcb
from concepthash_tpu_torch.models.clip import ClipTextConfig, ClipTextTower
from concepthash_tpu_torch.train import codebook as tcb
from concepthash_tpu_torch.weights import text_from_flax

CFG = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
           max_position_embeddings=16, vocab_size=100, projection_dim=32,
           eos_token_id=99)
ATOL = 1e-5
EMBEDS_DIM = 24


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def towers():
    jt = JTextTower(JTextConfig(**CFG))
    ids = jnp.zeros((1, 8), jnp.int32)
    params = _numpy(jt.init(jax.random.PRNGKey(0), ids)["params"])
    embeds_params = _numpy(jt.init(
        jax.random.PRNGKey(1), inputs_embeds=jnp.zeros((1, 8, EMBEDS_DIM)))[
        "params"])
    # the embeds-path init makes no token table; a checkpoint carries one
    embeds_params["token_embedding"] = params["token_embedding"]
    tt = ClipTextTower(ClipTextConfig(**CFG), device="cpu")
    tt.load_state_dict(text_from_flax(params), strict=True)
    te = ClipTextTower(ClipTextConfig(**CFG), embeds_dim=EMBEDS_DIM,
                       device="cpu")
    te.load_state_dict(text_from_flax(embeds_params), strict=True)
    return jt, params, tt, embeds_params, te


def _close(got: dict, want: dict):
    for key in ("last_hidden_state", "pooled", "text_embeds"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=ATOL, rtol=0,
                                   err_msg=key)


def test_input_ids_path_matches_reference(towers):
    jt, params, tt, _, _ = towers
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 99, (5, 16)).astype(np.int32)
    for row, pos in enumerate((3, 15, 0, 9)):   # row 4: no eos at all
        ids[row, pos] = 99
    ids[1, 12] = 99                              # two eos: the first pools
    want = jt.apply({"params": params}, jnp.asarray(ids))
    got = tt(input_ids=torch.from_numpy(ids).long())
    _close(got, want)
    # a shorter sequence uses the first positions
    want = jt.apply({"params": params}, jnp.asarray(ids[:, :7]))
    _close(tt(input_ids=torch.from_numpy(ids[:, :7]).long()), want)


def test_inputs_embeds_path_matches_reference(towers):
    jt, _, _, params, te = towers
    x = np.random.default_rng(1).standard_normal((3, 10, EMBEDS_DIM)).astype(
        np.float32)
    want = jt.apply({"params": params}, inputs_embeds=jnp.asarray(x))
    _close(te(inputs_embeds=torch.from_numpy(x)), want)


def test_inputs_embeds_at_the_tower_width(towers):
    """Embeddings of the tower's own width enter without an adapter."""
    jt, params, tt, _, _ = towers
    x = np.random.default_rng(2).standard_normal((2, 6, 64)).astype(np.float32)
    want = jt.apply({"params": params}, inputs_embeds=jnp.asarray(x))
    _close(tt(inputs_embeds=torch.from_numpy(x)), want)


def _toy_tokenizer(prompts, padding=True, truncation=True, max_length=77,
                   return_tensors="np"):
    n = min(max_length, CFG["max_position_embeddings"])
    rows = [[1 + ord(ch) % 97 for ch in p][:n - 1] + [99] for p in prompts]
    width = max(len(r) for r in rows)
    return {"input_ids": np.array([r + [0] * (width - len(r)) for r in rows],
                                  np.int64)}


def test_embed_class_names_matches_reference(towers):
    jt, params, tt, _, _ = towers
    names = ["cat", "a long bird name", "x"]     # the middle one truncates
    kw = dict(prompt_prefix="a ", prompt_postfix=".", batch_size=2)
    want = jcb.embed_class_names(names, text_tower=jt, text_params=params,
                                 tokenizer=_toy_tokenizer, **kw)
    got = tcb.embed_class_names(names, text_tower=tt,
                                tokenizer=_toy_tokenizer, **kw)
    assert got.shape == want.shape == (3, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_embed_class_names_raises_without_a_tower(monkeypatch, tmp_path):
    """No tower given and none on the local disk: OSError, and nothing is
    fetched."""
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(OSError, match="nothing is downloaded"):
        tcb.embed_class_names(["cat"])


def test_tower_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClipTextTower(ClipTextConfig(**CFG))
