"""ConceptHash's options in the PyTorch port against the JAX package, on the
CPU at the ``tiny_test`` backbone (hidden 64, 2 layers, 4 heads, 48^2
images in patches of 8: a square 6 x 6 grid for the Gaussian mask; adapters
of 16, 16 bits, 10 classes), from the same weights carried across by
``from_flax``:

- SelfAttentionAtLast as configs/model/concepthash_sa.yaml has it, with
  the decorrelated code BatchNorm (``add_bn: dbn``); with every other SA
  option on (strong, cross_attention, differentiable, add_pe); without
  parameters, cross-attending at the argmax;
- per-layer prompts on the concept tokens (``vpt_pe``) with
  ``backbone.remat`` and sub-codes from the projected tokens
  (``use_before_projection: false``); q/k/v/out adapters
  (``attention_adapter``) with FILIP's token-level logits; and lars.

Options that touch different parts of the model share one, which saves
JAX compiles.

Held: each eval forward (with and without attention maps) within 1e-5, and
the train-mode forward (batch statistics) at rtol 1e-4, the train slice's
tolerance: the train-mode BatchNorm's f32 variance, E[x^2] - E[x]^2 on
both sides, scales its input's rounding differences by mean^2 / var; three
train steps of the reference's ``make_train_step`` against the port's (the
port at ``attention_impl="pallas"``, ``fused_ln="pallas"``, the kernels'
plain versions) at rtol 1e-4, with the running statistics after them; an
eval step after them; each variant's JAX ``.msgpack`` loaded strictly through
the experiment's checkpoint reader. Also: remat gradients equal non-remat
ones exactly, ``embed_class_name_tokens`` against the reference's on a tiny
random Hugging Face CLIP in a temporary directory, and the FILIP
pseudo-token fallback equal to the reference's."""

import copy
import functools
import json
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu import methods as jmethods
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu.train.state import make_eval_step as jmake_eval_step
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.experiments.hashing import RetrievalExperiment
from concepthash_tpu_torch.train.state import make_eval_step
from concepthash_tpu_torch.weights import from_flax

NCLASS, BATCH, IMAGE, STEPS, SPE, TOKENS = 10, 6, 48, 3, 2, 5
FWD_ATOL = 1e-5
TRAIN_RTOL = 1e-4

SA_YAML = {"params": True, "mask_sigma": 0.5, "cross_attention": False,
           "differentiable": False, "add_pe": False}
SA_FULL = {"params": True, "strong": True, "mask_sigma": 0.5,
           "cross_attention": True, "differentiable": True, "add_pe": True}
OPTIONS = {
    "sa_dbn": {"model": {"self_attn_at_last": SA_YAML, "add_bn": "dbn"}},
    # the code BatchNorm off: on noise images the cross-attended concept
    # tokens barely vary over a batch (mean^2 / var ~ 5e3 here), past what
    # any f32 tolerance of the train-mode BatchNorm can hold; "sa_dbn"
    # holds SA under a BatchNorm
    "sa_full": {"model": {"self_attn_at_last": SA_FULL, "add_bn": False}},
    "sa_identity_cross": {"model": {"self_attn_at_last": {
        "params": False, "cross_attention": True, "mask_sigma": 1.0}}},
    "vpt_remat_projected": {"model": {"vpt_pe": True,
                                      "use_before_projection": False},
                            "backbone": {"remat": True}},
    "qkvo_filip": {"model": {"attention_adapter": True, "filip": True},
                   "criterion": {"loss_scales": {"filip_logits": 1}}},
    "lars": {"optim": {"name": "lars", "lr": 0.1, "momentum": 0.9,
                       "weight_decay": 1e-4}},
}
# lars changes no forward
FORWARD = [o for o in OPTIONS if o != "lars"]
TRAINED = ["sa_dbn", "sa_full", "vpt_remat_projected", "qkvo_filip", "lars"]


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def config(option: str) -> dict:
    """main.py's config groups for ConceptHash at the tiny size, with the
    option's keys laid over them (dropout 0: JAX and torch random streams
    cannot be matched). The optimizer is sgd with momentum at a constant
    rate: its update is proportional to the gradient, where adam's turns a
    gradient of rounding size (hash_pe under the BatchNorm, the key biases
    under the softmax, a q/k/v adapter's key bias) into a step of the full
    rate whose sign no two frameworks share; adam is held in
    test_torch_train_slice.py, each optimizer's arithmetic in
    test_torch_optim.py."""
    base = {
        "model": {"name": "concepthash", "nbit": 16, "nclass": NCLASS,
                  "ncontext": 4, "has_adapter": True,
                  "adapter_bottleneck_dim": 16,
                  "upt_config": {"multi": True, "num_heads": 8,
                                 "dropout": 0.0, "ensemble_method": "concat",
                                 "single_hash_fc": True, "hash_pe": True},
                  "add_bn": True, "use_before_projection": True,
                  "concept_reg": True, "text_projection_dims": [32]},
        "backbone": {"name": "tiny", "hidden_size": 64,
                     "intermediate_size": 128, "num_layers": 2,
                     "num_heads": 4, "patch_size": 8, "image_size": IMAGE,
                     "projection_dim": 32},
        "criterion": {"name": "lgh", "margin": 0.2, "scale": 8,
                      "loss_scales": {"bin_logits": 1, "cont_logits": 1,
                                      "concept_logits": 1},
                      "lmbd": 0.5, "ncontext": 4},
        "optim": {"name": "sgd", "lr": 0.01, "momentum": 0.9,
                  "weight_decay": 0.0005},
        "scheduler": {"name": "no_decay"},
        "epochs": 100, "backbone_lr_scale": 0, "batch_size": BATCH,
        "compute_dtype": "float32", "seed": 0, "dataset": {"nclass": NCLASS},
    }
    cfg = _merge(base, OPTIONS[option])
    if cfg["model"].get("filip"):
        cfg["model"]["token_embeds_array"] = np.random.default_rng(4) \
            .standard_normal((NCLASS, TOKENS, 32)).astype(np.float32)
    return cfg


def images(seed, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n, IMAGE, IMAGE, 3)).astype(np.float32)


def batches(seed):
    rng = np.random.default_rng(seed)
    return [{"image": images(int(rng.integers(1 << 30))),
             "label": np.eye(NCLASS, dtype=np.float32)[
                 rng.integers(0, NCLASS, BATCH)]} for _ in range(STEPS)]


def _seed_adapters(tree, rng, keep_zero=()):
    """Seeded values in every adapter's zero-init up-projection (so each
    adapter changes the output and its down-projection gets a gradient),
    except those named in ``keep_zero`` (a zero-norm leaf for lars)."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if k.startswith("adapter") and "up" in v and k not in keep_zero:
            v["up"]["kernel"] = (0.1 * rng.standard_normal(
                v["up"]["kernel"].shape)).astype(np.float32)
        else:
            _seed_adapters(v, rng, keep_zero)


@functools.lru_cache(maxsize=None)
def reference(option: str):
    """The JAX model of ``option`` with seeded variables (numpy leaves),
    its loss, and the same weights in the port's model (vision at the
    kernel settings)."""
    cfg = config(option)
    centers = np.random.default_rng(1).standard_normal(
        (NCLASS, 32)).astype(np.float32)
    jm = jmethods._build_concepthash(cfg, centers)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        jnp.zeros((BATCH, IMAGE, IMAGE, 3)))
    variables = jax.tree_util.tree_map(np.array, variables)
    _seed_adapters(variables["params"]["backbone"],
                   np.random.default_rng(2),
                   keep_zero=("adapter_mlp",) if option == "lars" else ())
    tr = tmethods.build_training(cfg, centers, SPE, device="cpu",
                                 vision=dict(attention_impl="pallas",
                                             fused_ln="pallas"))
    tr.model.load_state_dict(from_flax(variables), strict=True)
    return cfg, centers, jm, variables, tr


def _assert_outputs_close(got: dict, want: dict, rtol=FWD_ATOL,
                          atol=FWD_ATOL):
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        if k == "attn_cache":
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                np.testing.assert_allclose(g.detach().float().numpy(),
                                           np.asarray(w, np.float32),
                                           rtol=rtol, atol=atol, err_msg=k)
            continue
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("option", FORWARD)
@pytest.mark.parametrize("mode", ["eval", "eval_maps", "train"])
def test_forward_matches_jax(option, mode):
    """The forward at f32: eval (the port through the encoder layer's
    whole-layer function, kernel 1's plain version, except for q/k/v/out
    adapters) and eval with the attention maps (attn_cache, SA's map last)
    within 1e-5; train mode (batch statistics, and the running statistics
    after it, the DBN's among them) at rtol 1e-4."""
    cfg, _, jm, variables, tr = reference(option)
    x = images(11)
    pm = copy.deepcopy(tr.model)
    if mode == "train":
        fn = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                           mutable=["batch_stats"]))
        want, stats = fn(variables, jnp.asarray(x))
        got = pm(torch.tensor(x), train=True)
        new = from_flax({**variables, "batch_stats": jax.tree_util.tree_map(
            np.asarray, stats.get("batch_stats", {}))})
        for k, v in pm.state_dict().items():
            if k.startswith("hash_bn."):
                np.testing.assert_allclose(v.numpy(), new[k].numpy(),
                                           rtol=TRAIN_RTOL, atol=1e-6,
                                           err_msg=k)
        _assert_outputs_close(got, want, rtol=TRAIN_RTOL)
    else:
        maps = mode == "eval_maps"
        fn = jax.jit(lambda v, x: jm.apply(v, x, train=False,
                                           output_attentions=maps))
        want = fn(variables, jnp.asarray(x))
        with torch.no_grad():
            got = pm(torch.tensor(x), output_attentions=maps)
        if maps:
            n_maps = cfg["backbone"]["num_layers"] + bool(
                cfg["model"].get("self_attn_at_last"))
            assert len(got["attn_cache"]) == n_maps
        _assert_outputs_close(got, want)
    if cfg["model"].get("filip"):
        assert {"logits_filip", "logits_filip_i2t",
                "logits_filip_t2i"} <= set(got)
        assert got["logits_filip"].dtype == torch.float32


@functools.lru_cache(maxsize=None)
def trained(option: str):
    """Three steps on each side from the same start, then one eval step on
    the reference's trained variables."""
    cfg, centers, jm, variables, tr = reference(option)
    jloss = jmethods._lgh_build_loss(cfg, centers)
    key = jax.random.PRNGKey(0)
    sample = jnp.zeros((BATCH, IMAGE, IMAGE, 3))
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], SPE,
                          variables["params"], backbone_lr_scale=0.0)
    state = create_train_state(jm, tx, sample, key, variables=variables)
    jstep = jmake_train_step(jm, jloss, tx, donate=False)
    jmetrics = []
    for b in batches(2):
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
    eval_batch = batches(3)[0]
    jeval = jmake_eval_step(jm, jloss)(
        state, {k: jnp.asarray(v) for k, v in eval_batch.items()})
    jafter = jax.tree_util.tree_map(np.asarray, state.variables())

    tr2 = tmethods.training_for(cfg, copy.deepcopy(tr.model), tr.loss_fn,
                                SPE)
    pm = tr2.model
    before = copy.deepcopy(pm.state_dict())
    tmetrics = []
    for b in batches(2):
        m = tr2.step({k: torch.tensor(v) for k, v in b.items()})
        tmetrics.append({k: float(v) for k, v in m.items()})
    after = copy.deepcopy(pm)
    after.load_state_dict(from_flax(jafter), strict=True)
    teval = make_eval_step(after, tr2.loss_fn)(
        {k: torch.tensor(v) for k, v in eval_batch.items()})
    return jmetrics, tmetrics, pm, before, jafter, (jeval, teval)


@pytest.mark.parametrize("option", TRAINED)
def test_three_train_steps_match_jax(option):
    """Each step's loss, parts and accuracies (FILIP's included) at rtol
    1e-4; every parameter and running statistic after the three steps at
    rtol 1e-4 (atol 1e-6); the frozen backbone (vpt_pe's prompts among it)
    bit-unchanged."""
    jm, tm, pm, before, jafter, _ = trained(option)
    for step, (j, t) in enumerate(zip(jm, tm)):
        assert set(j) == set(t), (set(j), set(t))
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step}: {k}")
    if option == "qkvo_filip":
        assert "filip" in tm[0] and "acc_filip" in tm[0]
    want = from_flax(jafter)
    got = pm.state_dict()
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    moved = [n for n, p in pm.named_parameters()
             if p.requires_grad and not torch.equal(got[n], before[n])]
    assert len(moved) > 10
    frozen = [n for n, p in pm.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith("backbone.") and "adapter" not in n
                          for n in frozen)
    for n in frozen:
        assert torch.equal(got[n], before[n]), n
    if option == "vpt_remat_projected":
        assert "backbone.vpt_pe.0" in frozen
    if option == "sa_dbn":
        assert not torch.equal(got["hash_bn.whiten"], before["hash_bn.whiten"])
    if option == "lars":
        zero = "backbone.layers.0.adapter_mlp.up.weight"
        assert not before[zero].any() and got[zero].any()


@pytest.mark.parametrize("option", TRAINED)
def test_eval_step_after_training_matches_jax(option):
    """The eval step on the reference's trained variables (running
    statistics in the BatchNorm): codes within 1e-4, as the train slice's
    eval step, and the loss and accuracies at rtol 1e-4."""
    (jcodes, jmetrics), (tcodes, tmetrics) = trained(option)[5]
    assert set(tcodes) == set(jcodes) == {"codes"}
    np.testing.assert_allclose(tcodes["codes"].numpy(),
                               np.asarray(jcodes["codes"]), rtol=0, atol=1e-4)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("option", TRAINED)
def test_jax_msgpack_loads_through_the_experiment(option, tmp_path):
    """A JAX run's ``models/*.msgpack`` of the variant (params, batch
    statistics, constants: the DBN's statistics and FILIP's token
    embeddings among them) loads strictly through the experiment's
    checkpoint reader, the one ``finetune_path`` and ``exp=validation``
    use, and encodes as the reference's variables do."""
    from concepthash_tpu.utils import io as jio

    _, _, _, _, jafter, _ = trained(option)
    path = str(tmp_path / "last.msgpack")
    jio.save_checkpoint({**jafter, "epoch": 4}, path)
    pm = copy.deepcopy(reference(option)[4].model)
    holder = types.SimpleNamespace(model=pm, _state_dict_from=functools
                                   .partial(RetrievalExperiment
                                            ._state_dict_from, None))
    assert RetrievalExperiment.load_model_state(holder, path) == 4
    want = from_flax(jafter)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, want[k]), k
    RetrievalExperiment.finetune_init(holder, path)


def test_remat_grads_equal_exactly():
    """backbone.remat recomputes each layer in the backward: every gradient
    equal, bit for bit, to the stored-activation run's (kernel settings,
    vpt_pe on), and the forward's outputs too."""
    _, _, _, _, tr = reference("vpt_remat_projected")
    b = batches(5)[0]
    grads = []
    for remat in (True, False):
        pm = copy.deepcopy(tr.model)
        pm.vision_cfg = pm.backbone.cfg = type(pm.backbone.cfg)(
            **{**pm.backbone.cfg.__dict__, "remat": remat})
        out = pm(torch.tensor(b["image"]), train=True)
        total, _ = tr.loss_fn(out, {"label": torch.tensor(b["label"])})
        total.backward()
        grads.append(({n: p.grad for n, p in pm.named_parameters()
                       if p.grad is not None}, out["codes"].detach()))
    (g1, c1), (g0, c0) = grads
    assert torch.equal(c1, c0)
    assert set(g1) == set(g0) and len(g1) > 10
    for n in g0:
        assert torch.equal(g1[n], g0[n]), n


# ---------------------------------------------------------------------------
# FILIP's class-text token embeddings
# ---------------------------------------------------------------------------

EOS = 99


@pytest.fixture(scope="module")
def hf_clip_dirs(tmp_path_factory):
    """A tiny random Hugging Face CLIP (text projection 32) saved with a
    100-id vocabulary and its fast tokenizer, once padding with
    ``<|endoftext|>`` and once with ``!`` (as some checkpoints do)."""
    transformers = pytest.importorskip("transformers")
    from transformers import (CLIPConfig, CLIPModel, CLIPTextConfig,
                              CLIPVisionConfig)

    from concepthash_tpu_torch.models.tokenizer import bytes_to_unicode

    torch.manual_seed(0)
    cfg = CLIPConfig(
        vision_config=CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=4, image_size=16, patch_size=8,
            projection_dim=32).to_dict(),
        text_config=CLIPTextConfig(
            hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16,
            vocab_size=100, projection_dim=32, eos_token_id=EOS).to_dict(),
        projection_dim=32)
    model = CLIPModel(cfg).eval()
    chars = [bytes_to_unicode()[b] for b in range(ord("a"), ord("z") + 1)]
    vocab = {c: i for i, c in enumerate(chars + [c + "</w>" for c in chars])}
    vocab.update({"ro": 60, "!": 61, "<|startoftext|>": 98,
                  "<|endoftext|>": EOS})
    src = tmp_path_factory.mktemp("vocab")
    (src / "vocab.json").write_text(json.dumps(vocab))
    (src / "merges.txt").write_text("#version: 0.2\nr o\n")
    dirs = {}
    for pad in ("<|endoftext|>", "!"):
        d = tmp_path_factory.mktemp("clip_pad")
        model.save_pretrained(str(d))
        transformers.CLIPTokenizerFast(
            str(src / "vocab.json"), str(src / "merges.txt"),
            pad_token=pad).save_pretrained(str(d))
        dirs[pad] = str(d)
    return dirs


@pytest.mark.parametrize("pad", ["<|endoftext|>", "!"])
def test_embed_class_name_tokens_matches_jax(hf_clip_dirs, pad):
    """(nclass, T, proj): the text tower's last hidden state projected, for
    prompts of different lengths padded with the checkpoint's pad id, equal
    to the reference's (transformers' tokenizer, the JAX tower) within
    1e-5."""
    from concepthash_tpu.train.codebook import \
        embed_class_name_tokens as jembed
    from concepthash_tpu_torch.models.tokenizer import CLIPTokenizer
    from concepthash_tpu_torch.train.codebook import embed_class_name_tokens

    d = hf_clip_dirs[pad]
    names = ["crow", "jay bird", "tit", "rook"]
    want = jembed(names, d, prompt_prefix="a ")
    got = embed_class_name_tokens(names, d, prompt_prefix="a ", device="cpu")
    assert got.shape == want.shape and got.shape[::2] == (4, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    tok = CLIPTokenizer.from_dir(d)
    assert tok.pad_id == (61 if pad == "!" else EOS)
    ids = tok([f"a {n}" for n in names], padding=True)["input_ids"]
    assert (ids == tok.pad_id).any()


def test_filip_pseudo_token_fallback_equals_the_references(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """Without a local CLIP checkpoint both experiments fall back to 8
    deterministic pseudo-tokens a class at the backbone's projection width,
    equal exactly, and say so in the log."""
    import concepthash_tpu.train.codebook as jcodebook
    from concepthash_tpu.experiments.hashing import \
        RetrievalExperiment as JExperiment

    def unreachable(*a, **kw):     # the reference's hub probe stays unrun
        raise OSError("no CLIP checkpoint on this disk")

    monkeypatch.setattr(jcodebook, "embed_class_name_tokens", unreachable)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    data = tmp_path / "data" / "birds"
    data.mkdir(parents=True)
    (data / "class_names.txt").write_text("Black_footed_Albatross\nLaysan "
                                          "Albatross\nrook\n")
    cfg = {"data_dir": str(tmp_path / "data"),
           "dataset": {"data_folder": "birds"},
           "backbone": {"name": "openai/clip-vit-base-patch32"},
           "model": {"filip": True}}
    jcfg, tcfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    JExperiment._prepare_filip_tokens(types.SimpleNamespace(config=jcfg))
    with caplog.at_level(logging.WARNING):
        RetrievalExperiment._prepare_filip_tokens(types.SimpleNamespace(
            config=tcfg, device=torch.device("cpu")))
    want = jcfg["model"]["token_embeds_array"]
    got = tcfg["model"]["token_embeds_array"]
    assert got.shape == want.shape == (3, 8, 512)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert "pseudo-tokens" in caplog.text


def test_self_attn_at_last_needs_tokens_before_projection():
    """SA with ``use_before_projection=False`` raises, as the reference
    does; a bare ``self_attn_at_last: true`` is not a mapping."""
    cfg = config("sa_dbn")
    cfg["model"]["use_before_projection"] = False
    with pytest.raises(ValueError, match="use_before_projection"):
        tmethods._build_concepthash(cfg, None, device="cpu")
    cfg = config("sa_dbn")
    cfg["model"]["self_attn_at_last"] = True
    with pytest.raises(ValueError, match="mapping"):
        tmethods._build_concepthash(cfg, None, device="cpu")
