"""The serving slice of the PyTorch port end to end on the CPU, against the
JAX package: the whole ConceptHash forward from weights carried by
``from_flax`` (codes and all logits, f32, atol 1e-4), then exact top-k over
a 20k-entry gallery with indices equal. Also: the port imports nothing of
JAX or the JAX package, and its CUDA entry points raise without CUDA."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.models.clip import AdapterConfig as JAdapterConfig
from concepthash_tpu.models.clip import ClipVisionConfig as JVisionConfig
from concepthash_tpu.models.concepthash import ConceptHash as JConceptHash
from concepthash_tpu.models.concepthash import (ConceptHashConfig as
                                                JConceptHashConfig)
from concepthash_tpu.ops import retrieval as jr
from concepthash_tpu_torch import resolve_device
from concepthash_tpu_torch.models.clip import AdapterConfig, ClipVisionConfig
from concepthash_tpu_torch.models.concepthash import (ConceptHash,
                                                      ConceptHashConfig)
from concepthash_tpu_torch.ops import retrieval as tr
from concepthash_tpu_torch.ops import topk_select as tts
from concepthash_tpu_torch.weights import from_flax

ROOT = Path(__file__).resolve().parent.parent
VISION = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
              image_size=32, patch_size=8, projection_dim=32)
HEAD = dict(nbit=64, nclass=10, ncontext=4, center_dim=32,
            text_projection_dims=(32,))
BOTTLENECK = 32


@pytest.fixture(scope="module")
def models():
    """The JAX model with its variables (adapter up-projections and BN stats
    made non-trivial, so every path carries signal) and the port's model
    loaded from them."""
    rng = np.random.default_rng(3)
    center = rng.standard_normal((HEAD["nclass"], HEAD["center_dim"])).astype(
        np.float32)
    jm = JConceptHash(JVisionConfig(**VISION), JConceptHashConfig(**HEAD),
                      adapters=JAdapterConfig(bottleneck_dim=BOTTLENECK),
                      fixed_center=jnp.asarray(center))
    imgs = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    variables = jm.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)},
                        jnp.asarray(imgs[:1]), train=False)
    variables = jax.tree_util.tree_map(lambda a: np.array(a), variables)
    for i in range(VISION["num_layers"]):
        layer = variables["params"]["backbone"][f"layers_{i}"]
        for name in ("adapter_attn", "adapter_mlp"):
            up = layer[name]["up"]
            up["kernel"] = (0.1 * rng.standard_normal(up["kernel"].shape)
                            ).astype(np.float32)
    stats = variables["batch_stats"]["hash_bn"]["bn"]
    stats["mean"] = (0.1 * rng.standard_normal(stats["mean"].shape)).astype(
        np.float32)
    stats["var"] = (1 + 0.5 * rng.random(stats["var"].shape)).astype(np.float32)
    pm = ConceptHash(ClipVisionConfig(**VISION), ConceptHashConfig(**HEAD),
                     AdapterConfig(bottleneck_dim=BOTTLENECK),
                     fixed_center=torch.tensor(center), device="cpu")
    pm.load_state_dict(from_flax(variables), strict=True)
    return jm, variables, pm, imgs


def test_forward_matches_jax(models):
    jm, variables, pm, imgs = models
    want = jm.apply(variables, jnp.asarray(imgs), train=False)
    with torch.no_grad():
        got = pm(torch.tensor(imgs))
    for key in ("codes", "logits_cont", "logits_bin", "logits_concept",
                "hash_features"):
        assert got[key].shape == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-4, err_msg=key)


def test_discrete_path_matches_fused_path(models):
    """Asking for attention maps takes the discrete modules; the outputs
    agree with the fused-layer path and the maps match the reference's."""
    jm, variables, pm, imgs = models
    with torch.no_grad():
        fused = pm(torch.tensor(imgs))
        discrete = pm(torch.tensor(imgs), output_attentions=True)
    want = jm.apply(variables, jnp.asarray(imgs), train=False,
                    output_attentions=True)
    for key in ("codes", "logits_cont", "logits_concept"):
        np.testing.assert_allclose(discrete[key].numpy(),
                                   fused[key].numpy(), rtol=0, atol=1e-4)
    for got, ref in zip(discrete["attn_cache"], want["attn_cache"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


def test_retrieval_on_slice_codes_matches_jax(models):
    """Codes from the port's encode, planted in a 20k-entry gallery, served
    exactly: distances and indices equal the reference's, and each query
    finds its planted row at distance 0."""
    _, _, pm, imgs = models
    with torch.no_grad():
        codes = pm(torch.tensor(imgs))["codes"]
    rng = np.random.default_rng(5)
    N = 20_000
    gallery = np.where(rng.random((N, HEAD["nbit"])) < 0.5, -1.0, 1.0
                       ).astype(np.float32)
    planted = rng.choice(N, codes.shape[0], replace=False)
    gallery[planted] = np.where(codes.numpy() > 0, 1.0, -1.0)
    jd, ji = jr.retrieve_topk(jnp.asarray(codes.numpy()), jnp.asarray(gallery),
                              k=50, exact=True)
    td, ti = tr.retrieve_topk(codes, torch.tensor(gallery), k=50, exact=True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (td[:, 0] == 0).all()
    assert all(p in row for p, row in zip(planted, ti.numpy()))

    packed, n_pad = tts.pack_serving_gallery(torch.tensor(gallery))
    bits = tts.pack_bits_serving(packed, HEAD["nbit"])
    sd, si = tr.retrieve_topk_streaming(codes, packed, k=50, db_block=n_pad,
                                        exact=True, n_valid=N, db_bits=bits)
    np.testing.assert_array_equal(sd.numpy(), np.asarray(jd))
    jsd, jsi = jr.retrieve_topk_streaming(
        jnp.asarray(codes.numpy()), jnp.asarray(packed.numpy()), k=50,
        db_block=n_pad, exact=True, n_valid=N,
        db_bits=jnp.asarray(bits.numpy().view(np.uint32)))
    np.testing.assert_array_equal(si.numpy(), np.asarray(jsi))


def test_port_imports_nothing_of_jax():
    """A fresh interpreter that imports every port module has loaded no
    jax, flax, transformers, sklearn or concepthash_tpu module."""
    mods = [f"concepthash_tpu_torch.{m}" for m in (
        "_build", "weights", "data.preprocess", "ops.numerics",
        "ops.fused_layer", "ops.hamming", "ops.topk_select", "ops.retrieval",
        "ops.fused_ln", "ops.attention", "models.layers", "models.clip",
        "models.concepthash", "models.backbone_factory", "losses.common",
        "losses.concepthash", "train.optim", "train.state", "methods",
        "config.loader", "data.manifest", "data.synthetic", "data.augment",
        "data.pipeline", "train.codebook", "utils.meters", "utils.logger",
        "utils.machine_stats", "utils.io", "utils.diagnostics",
        "experiments.hashing", "train.graphs", "utils.hf_local",
        "models.clip_loader", "models.tokenizer", "models.trunk",
        "models.baselines", "losses.baselines", "train.custom_steps",
        "models.finegrained", "native", "losses.unsupervised",
        "losses.shallow", "models.pretrain", "models.mae", "models.tbh",
        "train.pretrain_steps", "train.kmeans", "models.resnet",
        "models.convnets", "models.swin", "models.cnn_loader",
        "utils.torch_import", "train.optax_state", "parallel",
        "parallel.mesh", "parallel.collectives", "ops.sharded")] + \
        ["main_gpu"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'transformers', 'safetensors', "
            "'sklearn', 'concepthash_tpu'))\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        ConceptHash(ClipVisionConfig(**VISION), ConceptHashConfig(**HEAD))
    codes, labels = np.ones((3, 16), np.float32), np.arange(3)
    with pytest.raises(RuntimeError, match="CUDA"):     # scoring's default
        tr.calculate_mAP(codes, labels, codes, labels)
    assert resolve_device("cpu").type == "cpu"


def _option_pair(rng, token_embeds=None, **head):
    """A JAX ConceptHash with ``head`` options (seeded centers) and its
    variables (seeded adapter up-projections), and 6 seeded images."""
    cfg = dict(HEAD, **head)
    center = rng.standard_normal((HEAD["nclass"], HEAD["center_dim"])).astype(
        np.float32)
    jm = JConceptHash(JVisionConfig(**VISION), JConceptHashConfig(**cfg),
                      adapters=JAdapterConfig(bottleneck_dim=BOTTLENECK),
                      fixed_center=jnp.asarray(center),
                      token_embeds=(None if token_embeds is None
                                    else jnp.asarray(token_embeds)))
    imgs = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.array, jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(imgs[:1]), train=False))
    for i in range(VISION["num_layers"]):
        for name in ("adapter_attn", "adapter_mlp"):
            up = variables["params"]["backbone"][f"layers_{i}"][name]["up"]
            up["kernel"] = (0.1 * rng.standard_normal(up["kernel"].shape)
                            ).astype(np.float32)
    return jm, variables, imgs, cfg


def test_dbn_forward_matches_jax():
    """add_bn='dbn': the eval forward with seeded running statistics (a
    mean and a whitening matrix a group) and the train forward with the
    batch's, and the running statistics it leaves, within 1e-5."""
    rng = np.random.default_rng(7)
    jm, variables, imgs, cfg = _option_pair(rng, add_bn="dbn", dropout=0.0)
    stats = variables["batch_stats"]["hash_bn"]
    stats["mean"] = (0.1 * rng.standard_normal(stats["mean"].shape)).astype(
        np.float32)
    stats["whiten"] = (stats["whiten"] + 0.05 * rng.standard_normal(
        stats["whiten"].shape)).astype(np.float32)
    pm = ConceptHash(ClipVisionConfig(**VISION), ConceptHashConfig(**cfg),
                     AdapterConfig(bottleneck_dim=BOTTLENECK), device="cpu")
    pm.load_state_dict(from_flax(variables), strict=True)
    want = jm.apply(variables, jnp.asarray(imgs), train=False)
    with torch.no_grad():
        got = pm(torch.tensor(imgs))
    np.testing.assert_allclose(got["codes"].numpy(), np.asarray(want["codes"]),
                               rtol=1e-5, atol=1e-5)
    want, new = jm.apply(variables, jnp.asarray(imgs), train=True,
                         mutable=["batch_stats"])
    got = pm(torch.tensor(imgs), train=True)
    np.testing.assert_allclose(got["codes"].detach().numpy(),
                               np.asarray(want["codes"]), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "whiten"):
        np.testing.assert_allclose(
            getattr(pm.hash_bn, k).numpy(),
            np.asarray(new["batch_stats"]["hash_bn"][k]), rtol=1e-5,
            atol=1e-6, err_msg=k)


def test_token_embeds_forward_matches_jax():
    """FILIP's token embeddings: the i2t, t2i and mean logits (float32,
    from the projected concept tokens) and every other output within
    1e-5; the embeddings ride in the state dict as ``token_embeds``."""
    rng = np.random.default_rng(8)
    te = rng.standard_normal((HEAD["nclass"], 3, 32)).astype(np.float32)
    jm, variables, imgs, cfg = _option_pair(rng, token_embeds=te)
    pm = ConceptHash(ClipVisionConfig(**VISION), ConceptHashConfig(**cfg),
                     AdapterConfig(bottleneck_dim=BOTTLENECK),
                     token_embeds=torch.zeros(10, 3, 32), device="cpu")
    pm.load_state_dict(from_flax(variables), strict=True)
    assert torch.equal(pm.token_embeds, torch.tensor(te))
    want = jm.apply(variables, jnp.asarray(imgs), train=False)
    with torch.no_grad():
        got = pm(torch.tensor(imgs))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32 or key == "hash_features"
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_unported_options_raise():
    """fused_ln='pallas_layer' trains: its train forward goes through the
    whole-layer function (``EncoderLayerFn``, no NotImplementedError), and
    its outputs and the gradient of every parameter equal the discrete
    path's ('xla', the same weights) at f32: outputs within
    1e-5 + 1e-4 |ref|, each gradient within 1e-4 of its largest entry."""
    from concepthash_tpu_torch.ops import fused_layer as tfl

    seen = []
    orig = tfl.EncoderLayerFn.forward

    def counted(ctx, *args):
        seen.append(1)
        return orig(ctx, *args)

    models = {}
    for fused_ln in ("pallas_layer", "xla"):
        models[fused_ln] = ConceptHash(
            ClipVisionConfig(**VISION, fused_ln=fused_ln),
            ConceptHashConfig(**HEAD),
            AdapterConfig(bottleneck_dim=BOTTLENECK), device="cpu",
            generator=torch.Generator().manual_seed(0))
    models["xla"].load_state_dict(models["pallas_layer"].state_dict())
    imgs = torch.tensor(np.random.default_rng(9).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    outs, grads = {}, {}
    for name, pm in models.items():
        with torch.no_grad():
            for n, p in pm.named_parameters():
                if "adapter" in n and "up" in n:
                    p.copy_(0.1 * torch.randn(p.shape, generator=torch
                                              .Generator().manual_seed(4)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfl.EncoderLayerFn, "forward", staticmethod(counted))
            out = pm(imgs, train=True,
                     generator=torch.Generator().manual_seed(1))
        outs[name] = out
        # not the codes: the train-mode BatchNorm makes their sum of
        # squares a constant, whose gradient is rounding noise
        sum(out[k].float().square().sum() for k in (
            "logits_cont", "logits_bin", "hash_features",
            "logits_concept")).backward()
        grads[name] = {n: p.grad for n, p in pm.named_parameters()}
    assert len(seen) == VISION["num_layers"]     # pallas_layer's only
    for k, v in outs["xla"].items():
        if torch.is_tensor(v):
            np.testing.assert_allclose(
                outs["pallas_layer"][k].detach().numpy(),
                v.detach().numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    # hash_pe and the hash query's key bias have a gradient of zero in
    # exact arithmetic (test_torch_train_slice.py): rounding noise, held
    # against the largest gradient entry of the model instead
    top = max(g.abs().max().item() for g in grads["xla"].values()
              if g is not None)
    for n, g in grads["xla"].items():
        got = grads["pallas_layer"][n]
        assert (got is None) == (g is None), n
        if g is not None:
            err = (got - g).abs().max().item()
            null = n in ("hash_pe", "hash_attention.sa.key.bias")
            assert err <= 1e-4 * (top if null else g.abs().max().item()), \
                (n, err)


def test_chip_smoke_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's phases, serving and training, at a tiny size on the
    CPU, with each kernel wrapper replaced by its plain version (counting
    its calls) and the CUDA timers by host ones: every check passes, the
    serving path reaches the mins through both gallery layouts, the train
    path launches 2 LN -> matmul and 1 attention per layer and step, phase
    15 (several steps per call, the eval-only modes, resume, a local CLIP
    checkpoint) passes its checks, phase 17 (the supervised baselines'
    encodes, train steps, graphed chunks and runs), phase 18 and phase 19
    (the unsupervised methods' encodes, steps, two-view and ``aux``
    chunks and runs, and the shallow regime) and phase 20 (the
    pretraining methods', TBH's and ODC's encodes, steps and runs, kernel
    1 at the MAE's shape, k-means) and phase 21 (the non-CLIP trunks'
    encodes, steps and graphed chunks with their BatchNorm buffers, their
    CLI runs, profile, disable_jit and the reference-layout import) and
    phase 22 (kernel 1 in training: counted steps against plain ones, a
    graphed chunk against eager steps, a trainable backbone's graphed
    chunk, the recompute's cost) and phase 23 (on a gloo group of one rank
    in this process: the sharded top-k through both mins layouts, the
    data-parallel steps and chunk against plain ones, and the flagship
    run again as one rank, in-process) pass their checks, and the kernels'
    JSON line has every key the card run prints, for all six TPU
    kernels."""
    import importlib.util
    import json
    import time

    from concepthash_tpu_torch import _build
    from concepthash_tpu_torch.ops import attention as tat
    from concepthash_tpu_torch.ops import fused_layer as fl
    from concepthash_tpu_torch.ops import fused_ln as tln

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    spec.loader.exec_module(cs)

    def layer(x, w, **kw):
        layer.launches += 1
        return fl.layer_reference(x, w, **kw)

    def mins(qi, db, n_codes, subblock, m, out_dtype=torch.float32,
             superblocks=False):
        mins.launches += 1
        mins.plain_launches += db.shape[-1] == qi.shape[1]
        return tts._mins_reference_serving(qi, db.reshape(n_codes, -1),
                                           subblock, m, out_dtype,
                                           superblocks)

    def ln_matmul(x2, gamma, beta, w, bias, eps=1e-5):
        ln_matmul.launches += 1
        return tln.ln_matmul_reference(x2, gamma, beta, w, bias, eps)

    def attention(q, k, v):
        attention.launches += 1
        return tat.attention_reference(q, k, v)

    def bp_mins(qi, bp, n_rows, subblock, m, out_dtype=torch.float32,
                superblocks=False):
        bp_mins.launches += 1
        return tts._bitplane_mins_reference(qi, bp, n_rows, subblock, m,
                                            out_dtype, superblocks)

    layer.launches = mins.launches = mins.plain_launches = 0
    bp_mins.launches = 0
    ln_matmul.launches = attention.launches = 0

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    monkeypatch.setattr(_build, "build", lambda *a: {})
    monkeypatch.setattr(fl, "encoder_layer_cuda", layer)
    # the layer's dispatch calls the (swapped) wrapper whatever the device,
    # under autograd too (EncoderLayerFn)
    monkeypatch.setattr(fl, "_forward", lambda x, w, a1, a2, h, eps, act:
                        fl.encoder_layer_cuda(x, w, num_heads=h, eps=eps,
                                              act=act, adapter_attn=a1,
                                              adapter_mlp=a2))
    monkeypatch.setattr(tts, "subblock_mins_cuda", mins)
    monkeypatch.setattr(tts, "_mins", lambda qi, db, n, nbit, s, dt,
                        superblocks=False: mins(qi, db, n, s, -(-n // s), dt,
                                                superblocks))
    # the autograd forwards call the (swapped) wrappers whatever the device
    monkeypatch.setattr(tln, "ln_matmul_cuda", ln_matmul)
    monkeypatch.setattr(tln, "_forward", lambda *a: tln.ln_matmul_cuda(*a))
    monkeypatch.setattr(tat, "attention_cuda", attention)
    monkeypatch.setattr(tat, "_forward", lambda *a: tat.attention_cuda(*a))
    monkeypatch.setattr(tts, "subblock_mins_bitplane_cuda", bp_mins)
    monkeypatch.setattr(tts, "_mins_bitplane", bp_mins)
    # the 10^8-code phase's hierarchical selection, at a tiny size
    monkeypatch.setattr(tts, "_INNER_DIRECT_MAX", 64)
    # phase 21's trunks at a tiny size: Swin's test variant at 32^2, a
    # 2-layer ViT at 48^2, AlexNet at 64^2 (the rest full width at 32^2)
    SWIN_TEST = ("backbone.variant=test", "backbone.window_size=4",
                 "dataset.crop=32")
    TINY_VIT = ("backbone.hidden_size=64", "backbone.intermediate_size=128",
                f"backbone.num_layers={VISION['num_layers']}",
                "backbone.num_heads=4", "backbone.patch_size=8",
                "backbone.image_size=48", "backbone.projection_dim=64",
                "dataset.crop=48")
    sizes = cs.Sizes(vision=VISION, head=dict(HEAD, text_projection_dims=(32,)),
                     bottleneck=BOTTLENECK, layer_batch=2,
                     layer_batch_big=3, layer_batches_eval=(4, 1),
                     ln_rows_big=3 * 21, mins_queries=16,
                     mins_codes=70_001, images=6, image_side=40,
                     gallery=70_016, k=10, reps=1, ln_rows=(4 * 21, 50),
                     attn_batch=2, attn_lengths=(21, 40), train_batch=4,
                     train_batch_big=8, bitplane_codes=1 << 17,
                     walk_codes=1 << 15, scoring_db=300,
                     scoring_split=(40, 300),
                     text=dict(hidden_size=32, intermediate_size=64,
                               num_layers=2, num_heads=4,
                               max_position_embeddings=12, vocab_size=50,
                               projection_dim=16, eos_token_id=49),
                     prompts=6, flagship_classes=3,
                     flagship_per_class=(4, 2), flagship_image=64,
                     flagship_args=("backbone=tiny_test", "model.nbit=16",
                                    "model.text_projection_dims=[32]",
                                    "batch_size=4", "dataset.nclass=3",
                                    "dataset.resize=64", "dataset.crop=48"),
                     graph_chunk=2, check_chunk=2, layer_chunk=2,
                     graph_per_class=(4, 1),
                     hf_text=dict(hidden_size=32, intermediate_size=64,
                                  num_layers=2, num_heads=4,
                                  max_position_embeddings=16,
                                  vocab_size=600, projection_dim=32,
                                  eos_token_id=599),
                     pretrained_images=6, variant_images=6, filip_tokens=3,
                     adsh_db=12, dcc_split=(60, 24), ae_embedding=(6, 16),
                     ae_iters=(20, 10, 40), unsup_fit=(80, 64, 96),
                     shallow_args=("model.nbit=8",),
                     trunk_groups=("resnet18", "resnet50", "swin_base",
                                   "alexnet", "vgg16", "vit_b16"),
                     trunk_images=8, trunk_side=64, trunk_cpu_images=8,
                     trunk_batch=4,
                     trunk_args=("dataset.crop=32",),
                     trunk_over=(("swin_base", SWIN_TEST),
                                 ("vit_b16", TINY_VIT),
                                 ("alexnet", ("dataset.crop=64",))))
    result = cs.run(sizes, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "\nplanted rows found at distance 0: 6/6" in out
    assert f"encoder_layer {VISION['num_layers']} " in out
    assert out.count("layer kernel vs plain") == 5
    assert "layer kernel vs plain, B=1 " in out
    assert "layer kernel vs plain, B=3 " in out
    assert "kernel 1 split (per layer" in out
    assert out.count("ln_matmul kernel vs plain") == 6
    n = VISION["num_layers"]
    assert f"{[(0, 0, 0, 2 * n, n, 0)] * 5}" in out
    assert out.count("\nmins kernel vs plain, Q=16 ") == 6
    assert "f32 encode (6 images" in out
    assert "serving, gallery packed once" in out
    assert "train (xla, B=8)" in out and "train step (B=4, kernels)" in out
    assert out.count("bitplane mins kernel vs plain") == 4
    assert "bit-plane serving: planted rows found at distance 0: 6/6" in out
    assert ("distances equal the plain walk's: True; indices score their "
            "distances: True") in out
    assert out.count("distance-level recall@10 1.000000") == 4
    assert ("mins at the main path's arguments (n_rows=65536) vs the plain "
            "walk's subblock mins: max |d| 0.0") in out
    assert out.count("scoring ") == 5
    assert out.count("scoring at the CUB-200 split size") == 2
    assert "text tower (2 layers, width 32, 4 heads, 6 prompts x 12 ids" in out
    assert "flagship run: 12 train, 6 test, 12 database images" in out
    assert "3 steps of 4 an epoch; codebook (3, 32)" in out
    # 2 layers x (2 test + 3 database batches) x 2 evaluations
    assert "flagship launches (encoder_layer, subblock_mins packed, plain, " \
        "ln_matmul, attention, bitplane_mins): (20, 0, 0, 0, 0, 0)" in out
    assert "the same codes, bit for bit: True" in out
    assert ("plain version: sign agreement test 1.000000, database "
            "1.000000 (batches of 4 and the tails of 2 and 0)") in out
    assert "flagship train epoch: device busy" in out
    # phase 15: K=2 steps a chunk, a warm-up chunk and a replayed one
    assert "graph vs eager train (auto, K=2, B=4" in out
    assert "graph vs eager train (auto, sgd, K=2, B=4" in out
    # phase 15's three, then phase 16's sa+dbn, filip and lars
    assert out.count("(replayed chunk); max rel |d| 0, parameters max |d| "
                     "0: bit for bit True (required)") == 6
    assert "graph vs eager train (pallas, lars, K=2" in out
    assert out.count("per-step lr equals current_lr: True") == 6
    assert f"counted (0, 0, 0, {2 * 2 * 2 * n}, {2 * 2 * n}, 0)" in out
    assert "the dropout generator advanced every chunk: True" in out
    assert "codes equal bit for bit: True, losses: True" in out
    assert ("chunked flagship run (train_chunk 2): 12 train images, 3 steps "
            "of 4 an epoch (1 chunks of 2 and 1 single steps)") in out
    assert out.count("(|d| 0, tolerance 1e-06)") == 3
    assert out.count("best test codes (3, 16) bit for bit: True") == 3
    assert out.count("(rel 0), last parameters max |d| 0: bit for bit True "
                     "(required); records 2") == 3 + 1     # 21 (c): resnet50
    assert "at train_chunk 1 on the same 3 steps" in out
    assert ("vision tower equal to the written one bit for bit: True; 6 "
            "images encode to the source model's codes bit for bit: True; "
            "the codebook (3, 32) from the real text stage on cpu: True, "
            "max |d| against the CPU's 0") in out
    # phase 16: each option's encode (kernel 1 once a layer, none with
    # q/k/v/out adapters), train steps, remat, and the two models' runs
    assert out.count(f"expected ({n}, 0, 0, 0, 0, 0)") == 6
    assert "variant qkvo: 6 images" in out
    assert "launches (0, 0, 0, 0, 0, 0), expected (0, 0, 0, 0, 0, 0)" in out
    assert out.count(", all steps alike: True") == 4
    # phase 17: every baseline's encode, train steps and graphed chunks
    # (hashnet: one step a dispatch, its bank), and three main_gpu runs
    # (phase 18 (a) and (b) print 4 encodes, 3 step runs and 2 graphed
    # chunks, (c) 2 validations, and phase 19 (a) and (b) 6 encodes, 5
    # step runs and 2 graphed chunks, (c) 2 validations, in the same words)
    assert out.count(f"against ({n}, 0, 0, 0, 0, 0)") == 11 + 4 + 6 + 1
    assert out.count("sign agreement 1.000000 (limit 0.99)") == 9 + 4
    assert out.count("feature cosine 1.000000 (limit 0.99)") == 2 + 1
    assert out.count(f"against (0, 0, 0, {2 * n}, {n}, 0), the same every "
                     "step: True; frozen backbone unchanged: True") == \
        11 + 3 + 5
    assert "adapters unchanged: True; " in out
    assert ("the bank's rows equal each batch's detached tanh(beta * "
            "codes) and labels: True") in out
    assert out.count("bit for bit True (required); replays") == 10 + 2 + 2
    for model in ("orthohash_adapter", "hashnet_adapter", "clip_finetune"):
        assert f"{model} run (train_chunk 2)" in out
        assert (f"{model} exp=validation use_last=true" in out)
    # phases 17 (c), 18 (c), 19 (c), 20 (c)'s tbh and odc runs and 21 (c)'s
    # resnet50 and swin runs
    assert out.count("|d| 0 (tolerance 1e-06)") == 3 + 2 + 2 + 2 + 2
    # phase 18: the fine-grained heads, the adsh regime, DCC, ae_fit, and
    # the loader (this machine has the headers: the native route)
    for name in ("a2net_ce", "semicon_ce", "semicon", "adsh"):
        assert f"fine-grained {name} encode (6 images" in out
    assert out.count("; logits max |d| / max |ref| ") == 4 + 2
    assert ("fine-grained a2net_ce train forward and backward, kernels vs "
            "plain: loss") in out
    assert "V agrees on 1.000000 of entries" in out
    assert out.count("signs agree on 1.000000 (limit 0.99)") == 2
    assert "ae_fit ae, the full 40 iterations on the card" in out
    for model in ("a2net_ce_adapter", "semicon_ce_adapter"):
        assert f"{model} run (train_chunk 2)" in out
        assert f"{model} exp=validation use_last=true" in out
    # semicon at max_iters 1: 3 steps an epoch; 2 layers x (2 x 3 subset + 1
    # test) batches
    assert ("semicon run (train_chunk 2): 3 steps of 4 an epoch") in out
    assert ("graph replays 0 train (expected 0); launches (14, 0, 0, 0, 0, "
            "0) against (14, 0, 0, 0, 0, 0)") in out
    assert "semicon: outputs/db_codes.pt (12, 16), values [-1.0, 1.0]" in out
    assert ("images by the C++ decoder 12, sent to PIL 0; the fallback "
            "logged: False") in out
    assert ("models/last.pt equal: bit for bit True (required)") in out
    assert "phase 18 (d) epoch-2 train img/s" in out
    assert "native_decode=true flagship train epoch" in out
    assert "clip_finetune: class-text centers (3, 32)" in out
    assert (f"launches per step (0, 0, 0, {4 * n}, {2 * n}, 0), expected "
            f"(0, 0, 0, {4 * n}, {2 * n}, 0)") in out      # remat
    assert (f"launches per step (0, 0, 0, 0, {n}, 0), expected (0, 0, 0, 0, "
            f"{n}, 0)") in out                              # qkvo
    assert "parameters max |d| 0: bit for bit True (required)" in out
    assert "remat step vs stored-activation step" in out
    for model in ("concepthash_sa", "concepthash_filip"):
        assert (f"{model} run (train_chunk 2): 3 steps of 4 an epoch") in out
    # 2 layers x (1 test + 3 database batches) x 2 evaluations, each run
    assert out.count("launches (16, 0, 0, 0, 0, 0), expected (16, 0, 0, 0, "
                     "0, 0)") == 3
    assert ("from the local checkpoint's text stage on cpu, max |d| against "
            "the CPU's 0 (tolerance 0.0001); the model's buffer equal: "
            "True") in out
    assert "phase 16 (c) img/s" in out
    # phase 19: the unsupervised heads' and itq's encodes, the steps (two
    # views: 8 image rows), graphed chunks with two views and staged aux,
    # the host fits, and the cibhash, ssdh and itq runs
    for name in ("cibhash", "bihalf", "nsh", "ssdh", "unsup_greedyhash"):
        assert f"unsupervised {name} encode (6 images" in out
        for opt in ("adam", "sgd"):
            assert (f"unsupervised {name} train step under {opt}, kernels "
                    "vs plain") in out
    for name in ("cibhash", "bihalf"):
        assert (f"unsupervised {name} train backward from one loss gradient, "
                "kernels vs plain") in out
    assert "latent cosine 1.000000" in out or "latent cosine 0.99" in out
    assert "no adapters): codes (6, 64), feature cosine 1.000000" in out
    for name in ("cibhash", "bihalf", "nsh"):
        assert f"unsupervised {name} train steps (B=4, 8 image rows" in out
    assert "unsupervised ssdh train steps (B=4, 4 image rows" in out
    assert "'image': (2, 8, 32, 32, 3), 'label': (2, 4, 10)}" in out
    assert "'aux': (2, 4, 4)}" in out
    assert "ssdh_structure (80 x 64 codes" in out
    assert "shallow fits (80 x 96 features to 64 bits" in out
    for model in ("cibhash", "ssdh"):
        assert f"{model} run (train_chunk 2): 3 steps of 4 an epoch" in out
        assert f"{model} exp=validation use_last=true" in out
    # ssdh: 2 layers x (2 x (1 test + 3 database) + 3 structure) batches
    assert ("graph replays 0 train (expected 0); launches (22, 0, 0, 0, 0, "
            "0) against (22, 0, 0, 0, 0, 0)") in out
    assert "ssdh structure over the 12 train images (int8)" in out
    # itq: 2 layers x (3 fit + 1 test + 3 database) batches
    assert ("itq run (the shallow regime, batch 4, adapters False): 3 "
            "fit-extraction batches") in out
    assert ("launches (14, 0, 0, 0, 0, 0) against (14, 0, 0, 0, 0, 0); "
            "test records 1 at ep 0") in out
    assert "exp=validation raises ValueError: True" in out
    # phase 20: the pretraining heads' and the MAE's encodes (kernel 1 once
    # a layer), kernel 1 at the MAE's shape, the steps (moco and dino: 4
    # trunk forwards a step over two views of 4), the teacher, center,
    # discriminator and memory checks, k-means, and the CLI runs
    for name in ("moco", "dino", "tbh", "odc", "mae", "autoencoder"):
        assert (f"pretrain {name} encode (6 images, bf16 on the card "
                "against f32 on the CPU)") in out
        assert f"pretrain {name} train steps (B=" in out
    assert out.count(f"kernel launches ({n}, 0, 0, 0, 0, 0) (want ({n}, 0, "
                     "0, 0, 0, 0))\n") == 6
    assert "mae's and autoencoder's seeded weights equal: True" in out
    assert ("kernel 1 at the MAE encoder's shape against its plain version, "
            "B=6 L=16 D=64 F=256 H=4 gelu, no adapters: max |d| 0") in out
    for name in ("moco", "dino", "tbh", "odc"):
        assert f"pretrain {name} train step under sgd, kernels vs plain" in out
    for name in ("moco", "dino"):
        assert (f"pretrain {name} train steps (B=8 image rows): loss") in out
    assert out.count(f"kernel launches a step (0, 0, 0, {8 * n}, {4 * n}, 0) "
                     f"(want (0, 0, 0, {8 * n}, {4 * n}, 0)), alike every "
                     "step: True; frozen backbone unchanged: True") == 2
    assert out.count("the teacher equals teacher * m + student * (1 - m) at "
                     "each step's momentum within 0;") == 2
    assert out.count(f"kernel launches a step (0, 0, 0, {2 * n}, {n}, 0) "
                     f"(want (0, 0, 0, {2 * n}, {n}, 0)), alike every step: "
                     "True; frozen backbone unchanged: True") == 2
    assert "its Adam at step {5}" in out
    assert ("memory rows outside the batch bit-unchanged: True; refresh "
            "fired [True, False, False, False, False], due [True, False, "
            "False, False, False]") in out
    assert out.count("kernel launches a step (0, 0, 0, 0, 0, 0) (want (0, "
                     "0, 0, 0, 0, 0)), alike every step: True") == 2
    assert ("mae graph vs eager train (K=2, B=64, a warm-up chunk and a "
            "replay, the mask drawn in the step)") in out
    assert ("parameters max |d| 0, the generator advanced to the eager "
            "twin's state: True: bit for bit True (required)") in out
    assert ("k-means (5994 x 64 unit rows, 200 clusters, 3 inits, float64) "
            "on cpu") in out
    assert "equal labels on 1.000000 of rows" in out
    for model in ("moco", "mae"):
        assert f"{model} run (exp general, train_chunk 2, 3 steps of 4" in out
    assert ("moco resumed after epoch 1: epoch-2 train loss") in out
    assert ("teacher max |d| 0: bit for bit True (required); records 2") in out
    for model in ("tbh", "odc"):
        assert f"{model} run (train_chunk 2): 3 steps of 4 an epoch" in out
        assert f"{model} exp=validation use_last=true" in out
    # odc: 2 layers x (2 x (1 test + 3 database) + 3 k-means) batches
    assert ("graph replays 0 train (expected 0); launches (22, 0, 0, 0, 0, "
            "0) against (22, 0, 0, 0, 0, 0)") in out
    assert "odc: the k-means logged: True; NMI (test, db)" in out
    assert "phase 20 (c) img/s, epoch-2 train and eval encode" in out
    # phase 21: each trunk's encode, kernel 1 at the vit trunk's shape, the
    # steps (BatchNorm statistics, frozen BatchNorm, dropout, kernels 5 and
    # 6), graphed chunks with buffers, the CLI runs, profile, disable_jit,
    # and the reference-layout import
    for name in ("resnet18", "resnet50", "swin_base", "alexnet", "vgg16",
                 "vit_b16", "a2net_ce"):
        assert (f"trunk {name} encode (8 images at") in out
    assert out.count("(limit 0.99), features (8, ") == 7
    assert (f"launches ({n}, 0, 0, 0, 0, 0) against ({n}, 0, 0, 0, 0, 0); "
            in out)
    assert ("layer kernel at the vit_b16 trunk's shape, B=8 L=37 D=64 "
            "F=128 H=4 gelu, both adapters (32): max |d| 0,") in out
    assert ("over 53 BatchNorms; num_batches_tracked [5]") in out
    assert ("frozen BatchNorm buffers (num_batches_tracked included) "
            "bit-unchanged after 5 steps: True") in out
    assert ("dropout from the run's generator: it advanced every step "
            "True, a step replayed from one state alike and from another "
            "not: True") in out
    assert "trunk vit_b16 train step under sgd, kernels vs plain" in out
    assert (f"launches per step (0, 0, 0, {2 * n}, {n}, 0) against (0, 0, "
            f"0, {2 * n}, {n}, 0), the same every step: True; frozen "
            "parameters unchanged: True") in out
    assert out.count("graphed steps alike bit for bit: True (required)") \
        == 3
    assert "swin_base train steps (B=4): loss" in out
    for run in ("orthohash_adapter", "csq_adapter"):
        assert f"{run} run (train_chunk 2)" in out
    assert "orthohash_adapter_resnet50 resumed after epoch 1" in out
    for run in ("orthohash_adapter_resnet50", "csq_adapter_swin_base",
                "dpsh_adapter on vit_b16"):
        for mode in ("default", "cudnn deterministic"):
            assert f"{run} batch shapes ({mode}): 1 test rows inside" in out
    assert out.count("the half batch twice bit for bit: True (required); "
                     "the first call that differs a library's: True "
                     "(required)") == 3
    assert out.count("dpsh_adapter on vit_b16 run (") == 2
    assert "profile: the trace steps_2-3.json of dispatches 2-3" in out
    assert ("debug.disable_jit run against the train_chunk=1 run's first "
            "epoch: its loss and models/ep1.pt max |d| 0: bit for bit "
            "True") in out
    assert ("dpsh_adapter on vit_b16 exp=validation use_last=true at "
            "val.yaml's batch of 64: mAP") in out
    assert "|d| 0 (limit 1e-06); the half batch twice" in out
    assert ("unused [], missing []; the imported state equal to the "
            "seeded one: True") in out
    assert ("equal to the seeded model's bit for bit: True (required)") in out
    # phase 22: kernel 1 in training (a 2-layer tower), graphed, and F4
    assert (f"layer train forward (pallas_layer, B=4, L=21): {n} layer "
            f"calls through kernel 1 under autograd ({n} expected)") in out
    assert (f"launches per step ({n}, 0, 0, 0, 0, 0) (kernel 1 once a layer, "
            f"kernels 5 and 6 never: ({n}, 0, 0, 0, 0, 0)), alike in every "
            "step: True") in out
    assert out.count("update cosine 1.000000") >= 3
    assert "layer train step 1 on the discrete path (the default" in out
    assert ("kernel 1's recomputing backward (B=4, L=21, D=64, both "
            "adapters, 27 gradients) against autograd through "
            "layer_reference at f32 on the CPU: least cosine") in out
    assert ("the dropout generator at the eager twin's state: True: bit for "
            "bit True (required), with 0 replays; launches per replay "
            f"{{'encoder_layer_cuda': {2 * n}}}, counted over both chunks "
            f"({4 * n}, 0, 0, 0, 0, 0)") in out
    assert ("trainable backbone (orthohash, backbone_lr_scale 0.1, 2 groups) "
            "graph vs eager train (K=2") in out
    assert "(required > 0), on the eager twin too: True; 0 replays" in out
    assert ("layer train cost (B=8, adam, frozen tower, eager; no card): "
            "pallas_layer ") in out
    assert "layer recompute backward (B=8, L=21, D=64, both adapters" in out
    # phase 23: one rank of a gloo group in (d), then in (a)-(c), left after
    # each
    assert out.count("process group: gloo, world size 1, rank 0 on cpu") == 2
    assert out.count("distances retrieve_topk's, bit for bit: True") == 4
    assert ("sharded top-k launches (encoder_layer, subblock_mins packed, "
            "plain, ln_matmul, attention, bitplane_mins): (0, ") in out
    assert "sharded top-k, one rank: dense " in out
    assert ("data-parallel steps on one rank (flagship, B=4, adam, dropout "
            "0.1): metrics equal step by step [True, True, True], parameters "
            "and buffers max |d| 0, the dropout generator equal: True: bit "
            "for bit True (required)") in out
    assert ("collectives captured; a warm-up chunk and a replay): losses"
            ) in out and "generator equal True: bit for bit True" in out
    assert "eager flagship step at B=8: " in out
    assert "eager collectives on one rank: all_reduce_grads " in out
    assert ("flagship run as one rank of a process group (in-process, gloo"
            ) in out
    assert ("train records True, test records True (mAP") in out
    assert ("models/last.pt True equal to phase 14's bit for bit; the log "
            "names the mesh: True") in out
    import os

    import torch.distributed as dist
    assert not dist.is_initialized()
    assert "WORLD_SIZE" not in os.environ
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    kernels = json.loads(json.dumps(result))["kernels"]
    assert [k["name"] for k in kernels] == [
        "encoder_layer", "subblock_mins", "subblock_mins_plain_layout",
        "ln_matmul", "attention", "bitplane_mins"]
    assert [k["launches"] for k in kernels[3:5]] == [5 * 2 * n, 5 * n]
    assert [k["replaces"] for k in kernels[1:3]] == [
        "concepthash_tpu/ops/topk_select.py:86",
        "concepthash_tpu/ops/topk_select.py:210"]
    assert kernels[5]["replaces"] == "concepthash_tpu/ops/topk_select.py:765"
    assert kernels[1]["max_abs_err"] == kernels[2]["max_abs_err"] == 0
    assert kernels[5]["max_abs_err"] == 0
    for k in kernels:
        assert set(k) == keys and k["launches"] > 0
        assert (ROOT / k["source"]).exists()
