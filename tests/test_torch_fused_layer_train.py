"""Kernel 1 in training, on the CPU: ``ops.fused_layer.EncoderLayerFn`` (the
layer's plain version as forward, a recompute of ``layer_xla`` as backward)
against the JAX package's ``encoder_layer(impl="pallas_layer",
interpret=True)``, whose ``custom_vjp`` recomputes ``_xla_layer``. Inputs
are numpy-seeded, flax-layout weights carried across transposed (as
``weights.py`` carries them). Held:

- the gradient of a squared loss for x and for every weight and adapter
  tensor against ``jax.grad``, without and with both adapters, quick_gelu
  and gelu, float32 (|d| <= 1e-5 max|ref| per tensor) and bfloat16 (the
  two frameworks round bf16 sums apart: |d| <= 0.05 max|ref| and cosine
  >= 0.999 per tensor), every pair of these in four cases;
- ``layer_xla`` against ``_xla_layer``, forward: float32 within 1e-5,
  bfloat16 within 0.05 + 0.02 |ref|;
- the function saves its inputs and nothing else;
- a tower with ``remat`` trains to the same gradients bit for bit, and a
  frozen tower asks the recompute for no weight gradient;
- three ConceptHash train steps at ``fused_ln="pallas_layer"`` (the
  flagship's geometry at tiny_test's width: both adapters, 4 concept
  tokens) against the reference's ``make_train_step`` with the same vision
  setting: losses and every trained tensor within 1e-6 + 1e-4 |ref|.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import concepthash_tpu.ops.fused_layer as jfl
import concepthash_tpu_torch.ops.fused_layer as tfl
from concepthash_tpu import methods as jmethods
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.models.clip import (AdapterConfig,
                                               ClipVisionConfig,
                                               ClipVisionTower)
from concepthash_tpu_torch.weights import from_flax

B, L, D, H, F, A = 2, 21, 64, 4, 128, 32   # L = 16 patches + cls + 4 concepts
F32_GRAD_RTOL = 1e-5                      # of the tensor's max |ref|
BF16_GRAD_RTOL, BF16_MIN_COSINE = 0.05, 0.999
BF16_ATOL, BF16_RTOL = 0.05, 0.02


def _layer_np(rng):
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(
        ln1_scale=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        ln1_bias=r(D), w_qkv=r(D, 3 * D), b_qkv=r(3 * D), w_out=r(D, D),
        b_out=r(D),
        ln2_scale=(1 - 0.1 * rng.standard_normal(D)).astype(np.float32),
        ln2_bias=r(D), w_fc1=r(D, F), b_fc1=r(F), w_fc2=r(F, D), b_fc2=r(D))


def _adapter_np(rng):
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(ln_scale=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
                ln_bias=r(D), w_down=r(D, A), b_down=r(A), w_up=r(A, D),
                b_up=r(D), scale=np.array([0.7], np.float32))


def _case(seed, adapters):
    rng = np.random.default_rng(seed)
    w = _layer_np(rng)
    ads = (_adapter_np(rng), _adapter_np(rng)) if adapters else (None, None)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    tgt = rng.standard_normal((B, L, D)).astype(np.float32)
    return x, w, ads, tgt


def _jax(cls, d, dt):
    """The reference model's form: matrices in the compute dtype, vectors
    float32 (``models/clip.EncoderLayer._fused_layer``)."""
    return cls(**{k: jnp.asarray(v).astype(dt) if v.ndim == 2
                  else jnp.asarray(v) for k, v in d.items()})


def _torch(cls, d, dt):
    """The port's (out, in) layout, as ``.cast(dt)`` gives it."""
    return cls(**{k: torch.tensor(v.T.copy() if v.ndim == 2 else v)
                  for k, v in d.items()}).cast(dt)


def _names(adapters):
    names = ["x", *(f"w.{f}" for f in tfl.LayerWeights._fields)]
    for tag in (("a1", "a2") if adapters else ()):
        names += [f"{tag}.{f}" for f in tfl.AdapterWeights._fields]
    return names


# every pair of (adapters, activation, dtype) values in four cases
@pytest.mark.parametrize("adapters,act,dtype", [
    (False, "quick_gelu", "float32"), (False, "gelu", "bfloat16"),
    (True, "quick_gelu", "bfloat16"), (True, "gelu", "float32")],
    ids=["plain-quick_gelu-float32", "plain-gelu-bfloat16",
         "adapters-quick_gelu-bfloat16", "adapters-gelu-float32"])
def test_gradients_match_jax_pallas_layer(adapters, act, dtype):
    x, w, (a1, a2), tgt = _case(3, adapters)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jw = _jax(jfl.LayerWeights, w, jdt)
    jads = tuple(_jax(jfl.AdapterWeights, a, jdt) for a in (a1, a2) if a)

    def loss(x_, w_, *ads):
        y = jfl.encoder_layer(x_, w_, num_heads=H, act=act,
                              adapter_attn=ads[0] if ads else None,
                              adapter_mlp=ads[1] if ads else None,
                              impl="pallas_layer", interpret=True)
        return ((y.astype(jnp.float32) - tgt) ** 2).sum()

    want = jax.tree_util.tree_leaves(jax.grad(loss, argnums=tuple(
        range(2 + len(jads))))(jnp.asarray(x).astype(jdt), jw, *jads))

    tw = _torch(tfl.LayerWeights, w, tdt)
    tads = [_torch(tfl.AdapterWeights, a, tdt) for a in (a1, a2) if a]
    tx = torch.tensor(x).to(tdt)
    leaves = [tx, *tw, *(t for a in tads for t in a)]
    for t in leaves:
        t.requires_grad_(True)
    y = tfl.encoder_layer(tx, tw, num_heads=H, act=act,
                          adapter_attn=tads[0] if tads else None,
                          adapter_mlp=tads[1] if tads else None)
    assert isinstance(y.grad_fn, tfl.EncoderLayerFn._backward_cls)
    ((y.float() - torch.tensor(tgt)) ** 2).sum().backward()

    names = _names(adapters)
    assert len(want) == len(leaves) == len(names)
    for name, j, t in zip(names, want, leaves):
        ref = np.asarray(j.astype(jnp.float32))
        got = t.grad.float().numpy()
        if got.ndim == 2 and name != "x":
            got = got.T
        assert t.grad.dtype == t.dtype, name
        err, top = np.abs(got - ref).max(), np.abs(ref).max()
        if dtype == "float32":
            assert err <= F32_GRAD_RTOL * top, (name, err, top)
        else:
            cos = (got * ref).sum() / np.sqrt((got ** 2).sum()
                                               * (ref ** 2).sum())
            assert err <= BF16_GRAD_RTOL * top, (name, err, top)
            assert cos >= BF16_MIN_COSINE, (name, cos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_xla_matches_xla_layer(dtype):
    x, w, (a1, a2), _ = _case(4, True)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for act in ("quick_gelu", "gelu"):
        want = jfl._xla_layer(jnp.asarray(x).astype(jdt),
                              _jax(jfl.LayerWeights, w, jdt),
                              _jax(jfl.AdapterWeights, a1, jdt),
                              _jax(jfl.AdapterWeights, a2, jdt),
                              num_heads=H, eps=1e-5, act=act)
        got = tfl.layer_xla(torch.tensor(x).to(tdt),
                            _torch(tfl.LayerWeights, w, tdt),
                            _torch(tfl.AdapterWeights, a1, tdt),
                            _torch(tfl.AdapterWeights, a2, tdt),
                            num_heads=H, eps=1e-5, act=act)
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=BF16_RTOL, atol=BF16_ATOL)


def test_saves_only_its_inputs():
    x, w, (a1, a2), _ = _case(5, True)
    tw = _torch(tfl.LayerWeights, w, torch.float32)
    tads = [_torch(tfl.AdapterWeights, a, torch.float32) for a in (a1, a2)]
    tx = torch.tensor(x, requires_grad=True)
    inputs = [tx, *tw, *tads[0], *tads[1]]
    y = tfl.encoder_layer(tx, tw, num_heads=H, adapter_attn=tads[0],
                          adapter_mlp=tads[1])
    saved = y.grad_fn.saved_tensors
    assert len(saved) == len(inputs)
    for s, t in zip(saved, inputs):
        assert s.data_ptr() == t.data_ptr() and s.shape == t.shape


def test_no_gradient_asked_takes_the_plain_forward():
    """Under no_grad, or with no input asking for a gradient, the forward
    is today's path: no autograd node, the plain version's values."""
    x, w, _, _ = _case(6, False)
    tw = _torch(tfl.LayerWeights, w, torch.float32)
    y = tfl.encoder_layer(torch.tensor(x), tw, num_heads=H)
    assert y.grad_fn is None
    torch.testing.assert_close(y, tfl.layer_reference(torch.tensor(x), tw,
                                                      num_heads=H),
                               rtol=0, atol=0)


VISION = dict(hidden_size=D, intermediate_size=F, num_layers=2, num_heads=H,
              image_size=32, patch_size=8, projection_dim=32,
              fused_ln="pallas_layer")


def _tower(remat=False, frozen=False):
    gen = torch.Generator().manual_seed(0)
    tower = ClipVisionTower(ClipVisionConfig(**VISION, remat=remat),
                            AdapterConfig(bottleneck_dim=A), generator=gen)
    with torch.no_grad():
        for layer in tower.layers:
            for ad in (layer.adapter_attn, layer.adapter_mlp):
                ad.up.weight.normal_(0, 0.1, generator=gen)
    if frozen:
        for n, p in tower.named_parameters():
            p.requires_grad_("adapter" in n)
    return tower


def _tower_grads(tower):
    img = torch.tensor(np.random.default_rng(7).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    extra = torch.tensor(np.random.default_rng(8).standard_normal(
        (2, 4, D)).astype(np.float32))
    out = tower(img, extra_tokens=extra, train=True)
    (out["pooled"] ** 2).sum().backward()
    return {n: p.grad for n, p in tower.named_parameters()}


def test_remat_gives_the_same_gradients():
    plain, remat = _tower(), _tower(remat=True)
    remat.load_state_dict(plain.state_dict())
    g_plain, g_remat = _tower_grads(plain), _tower_grads(remat)
    assert all(g is not None for g in g_plain.values())
    for n in g_plain:
        assert torch.equal(g_plain[n], g_remat[n]), n


def test_frozen_tower_asks_no_weight_gradient(monkeypatch):
    asked = []
    orig = tfl.layer_xla

    def spy(x, w, a1=None, a2=None, **kw):
        asked.append((x.requires_grad, [t.requires_grad for t in w],
                      [t.requires_grad for a in (a1, a2) for t in a]))
        return orig(x, w, a1, a2, **kw)

    monkeypatch.setattr(tfl, "layer_xla", spy)
    tower = _tower(frozen=True)
    grads = _tower_grads(tower)
    assert len(asked) == VISION["num_layers"]
    for gx, gw, ga in asked:
        assert not any(gw) and all(ga)
    # the backward runs the last layer first; layer 0's input comes from
    # frozen tensors only
    assert [gx for gx, _, _ in asked] == [True, False]
    for n, g in grads.items():
        assert (g is not None) == ("adapter" in n), n


# ---------------------------------------------------------------------------
# three ConceptHash train steps at fused_ln="pallas_layer"
# ---------------------------------------------------------------------------

NCLASS, BATCH, IMAGE, STEPS, SPE = 10, 4, 48, 3, 2
# the hash-query softmax is invariant to the key bias, the train-mode code
# BatchNorm to hash_pe: gradients zero in exact arithmetic, whose rounding
# noise adam turns into updates (test_torch_train_slice.py); held within
# 2 x the summed rates
NULL_GRADIENT = ("hash_attention.sa.key.bias", "hash_pe")


def _config():
    """configs/model/concepthash.yaml on configs/backbone/tiny_test.yaml
    (dropout 0), 16 bits, adapters of width 16, adam, csw, frozen tower."""
    return {
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
                      "loss_scales": {"logits": 0, "hash_logits": 0,
                                      "bin_logits": 1, "cont_logits": 1,
                                      "attn_div_loss": 0,
                                      "concept_logits": 1},
                      "avg_before_softmax": False, "lmbd": 0.5,
                      "div_method": 1, "ncontext": 4},
        "optim": {"name": "adam", "lr": 0.001, "weight_decay": 0.00001},
        "scheduler": {"name": "csw", "warmup_epochs": 10},
        "epochs": 100, "backbone_lr_scale": 0, "batch_size": BATCH,
        "compute_dtype": "float32", "seed": 0, "dataset": {"nclass": NCLASS},
    }


def test_concepthash_steps_match_jax_at_pallas_layer():
    cfg = _config()
    vision = {"fused_ln": "pallas_layer"}
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((NCLASS, 32)).astype(np.float32)
    jm = jmethods._build_concepthash(cfg, centers)
    jm = jm.clone(vision_cfg=jm.vision_cfg.__class__(
        **{**jm.vision_cfg.__dict__, **vision}))
    jloss = jmethods._lgh_build_loss(cfg, centers)
    sample = jnp.zeros((BATCH, IMAGE, IMAGE, 3))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)}, sample)
    variables = jax.tree_util.tree_map(np.array, variables)
    for i in range(cfg["backbone"]["num_layers"]):
        layer = variables["params"]["backbone"][f"layers_{i}"]
        for name in ("adapter_attn", "adapter_mlp"):
            up = layer[name]["up"]
            up["kernel"] = (0.1 * rng.standard_normal(up["kernel"].shape)
                            ).astype(np.float32)
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"], SPE,
                          variables["params"], backbone_lr_scale=0.0)
    state = create_train_state(jm, tx, sample, key, variables=variables)
    jstep = jmake_train_step(jm, jloss, tx, donate=False)

    tr = tmethods.build_training(cfg, centers, SPE, device="cpu",
                                 vision=vision)
    tr.model.load_state_dict(from_flax(variables), strict=True)
    before = copy.deepcopy(tr.model.state_dict())
    calls = []
    orig = tfl.EncoderLayerFn.backward

    def counted(ctx, g):
        calls.append(1)
        return orig(ctx, g)

    data = np.random.default_rng(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfl.EncoderLayerFn, "backward", staticmethod(counted))
        for i in range(STEPS):
            b = {"image": data.standard_normal(
                     (BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
                 "label": np.eye(NCLASS, dtype=np.float32)[
                     data.integers(0, NCLASS, BATCH)]}
            state, jmet = jstep(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            tmet = tr.step({k: torch.tensor(v) for k, v in b.items()})
            for k in jmet:
                np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {i}: {k}")
    assert len(calls) == STEPS * cfg["backbone"]["num_layers"]
    want = from_flax(jax.tree_util.tree_map(np.asarray, state.variables()))
    for n, p in tr.model.named_parameters():
        got = p.detach()
        if n in NULL_GRADIENT:
            assert (got - want[n]).abs().max() <= 2 * 4e-4, n
            continue
        np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)
        assert p.requires_grad != torch.equal(got, before[n]) or \
            n == "backbone.layers.0.adapter_attn.scale", n
