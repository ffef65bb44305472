"""Reference-checkpoint import into the port (``utils/torch_import.py``)
against the JAX package's importer (``concepthash_tpu/utils/torch_import.py``)
on the CPU, float32: one reference-layout state dict goes through both,
and the two imported models must give the same outputs (codes, and logits
where the head has them, at rtol 1e-4, atol 1e-5: the same weights, f32
sums in another order) and report the same unused keys.

The state dicts, each with the reference's prefixes and head keys and one
key no rule reads (``extra.unknown``):

- ResNet-50 from the torchvision shim in ``parity/shims`` (BatchNorm
  statistics trained by three forwards, its 1000-way ``fc`` kept) under
  ``backbone.model.`` with orthohash's ``hash_fc`` Sequential, CosSim
  centroids and codebook buffer;
- AlexNet (torchvision's ``classifier`` layout) and VGG16 (the reference
  wrapper's ``fc`` slice) from the shims, under ``backbone.``, with csq's
  ``hash_fc``;
- a tiny Hugging Face ``CLIPModel`` with the MLP adapters'
  ``adapter_params`` entries, under dpsh's ``hash_fc``, and the same tower
  under the ConceptHash head;
- a tiny Hugging Face ``ViTModel`` (its pooler unused), and timm-layout ViT
  and Swin keys (fused qkv, timm's buffers), as the reference re-attaches
  timm modules on its wrapper, under csq's ``hash_fc``;
- adsh's biased ``hash_fc.0`` (``model.hash_bias=true``).

Then the import script's run directory goes through ``main_gpu.py --device
cpu exp=validation`` and encodes as the imported model does.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu import methods as jmethods
from concepthash_tpu.config import load_config as jload_config
from concepthash_tpu.utils import torch_import as jimport
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.config.loader import load_config as tload_config
from concepthash_tpu_torch.utils import torch_import as timport

ROOT = Path(__file__).resolve().parent.parent
SHIMS = str(ROOT / "parity" / "shims")
sys.path.insert(0, str(ROOT))
import main_gpu  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
NCLASS, NBIT = 3, 16
TINY = ["backbone.hidden_size=64", "backbone.intermediate_size=128",
        "backbone.num_layers=2", "backbone.num_heads=4",
        "backbone.patch_size=8", "backbone.image_size=48",
        "backbone.projection_dim=64"]


@pytest.fixture(scope="module")
def tvm():
    """The torchvision.models shim, imported without leaving parity/shims
    on sys.path."""
    sys.path.insert(0, SHIMS)
    try:
        import torchvision.models as m
        return m
    finally:
        sys.path.remove(SHIMS)


def _rand(rng, *shape, scale=0.1):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _np(sd) -> dict:
    return {k: v.detach().numpy() for k, v in sd.items()}


def _signed_codebook():
    rng = np.random.default_rng(5)
    return np.where(rng.standard_normal((NCLASS, NBIT)) > 0, 1.0,
                    -1.0).astype(np.float32)


def _configs(model: str, *extra):
    over = ["dataset=synthetic", f"model={model}", f"model.nbit={NBIT}",
            f"dataset.nclass={NCLASS}", "model.adapter_bottleneck_dim=8",
            *extra]
    return (jload_config(str(ROOT / "configs"), "train", over),
            tload_config(str(ROOT / "configs"), "train", over))


def _import_both(sd, model, *extra, codebook=None):
    """(JAX outputs, port outputs, JAX report, port report, port model)
    of ``sd`` imported into ``model``'s config in both packages."""
    jcfg, tcfg = _configs(model, *extra)
    name = jcfg["model"]["name"]
    crop = int(jcfg["dataset"]["crop"])
    jm = jmethods.get_method(name).build_model(jcfg, codebook)
    key = jax.random.PRNGKey(0)
    # the tree the importer fills: its shapes from the init, nothing compiled
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
            lambda: jm.init({"params": key, "dropout": key},
                            jnp.zeros((2, crop, crop, 3)), train=False)))
    jvars, jrep = jimport.import_reference_state_dict(sd, name, jcfg,
                                                      template)
    tm, _ = tmethods.build_model(tcfg, codebook, device="cpu")
    _, trep = timport.import_reference_state_dict(sd, name, tcfg, tm)
    x = np.random.default_rng(3).standard_normal(
        (4, crop, crop, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        jvars, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.tensor(x))
    return want, got, jrep, trep, tm


def _check(want, got, jrep, trep, keys=("codes",)):
    for k in keys:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert trep.unused == jrep.unused
    assert "extra.unknown" in trep.unused
    # the reference lists a ViT's projection, which a ViT has none of, as
    # missing; the port's vit tower keeps its own
    assert not trep.missing
    assert set(jrep.missing) <= {"backbone/tower/visual_projection"}


def _warm_bn(m, size):
    m.train()
    with torch.no_grad():
        for i in range(3):
            m(torch.randn(2, 3, size, size,
                          generator=torch.Generator().manual_seed(7 + i)))
    m.eval()


def test_resnet50_orthohash(tvm):
    torch.manual_seed(0)
    m = tvm.resnet50()
    _warm_bn(m, 48)
    rng = np.random.default_rng(1)
    sd = {f"backbone.model.{k}": v for k, v in _np(m.state_dict()).items()}
    sd.update({"hash_fc.0.weight": _rand(rng, NBIT, 2048),
               "hash_fc.1.weight": 1 + _rand(rng, NBIT),
               "hash_fc.1.bias": _rand(rng, NBIT),
               "hash_fc.1.running_mean": _rand(rng, NBIT),
               "hash_fc.1.running_var": 1 + np.abs(_rand(rng, NBIT)),
               "hash_fc.1.num_batches_tracked": np.array(3),
               "ce_fc.centroids": _signed_codebook(),
               "codebook": _signed_codebook(),
               "extra.unknown": _rand(rng, 2)})
    want, got, jrep, trep, tm = _import_both(
        sd, "orthohash_adapter", "backbone=resnet50",
        codebook=_signed_codebook())
    _check(want, got, jrep, trep, ("codes", "logits"))
    assert "backbone.model.fc.weight" not in trep.unused
    assert int(tm.backbone.tower.bn1.num_batches_tracked) == \
        int(m.bn1.num_batches_tracked) == 3


@pytest.mark.parametrize("family, layout", [("alexnet", "classifier"),
                                            ("vgg16", "fc")])
def test_convnets_csq(tvm, family, layout):
    torch.manual_seed(0)
    m = getattr(tvm, family)()
    raw = _np(m.state_dict())
    if layout == "fc":          # the reference wrapper's classifier[0:6]
        raw = {k.replace("classifier.", "fc."): v for k, v in raw.items()
               if not k.startswith("classifier.6.")}
    rng = np.random.default_rng(2)
    sd = {f"backbone.{k}": v for k, v in raw.items()}
    sd.update({"hash_fc.weight": _rand(rng, NBIT, 4096),
               "extra.unknown": _rand(rng, 2)})
    crop = "dataset.crop=64" if family == "alexnet" else "dataset.crop=32"
    _check(*_import_both(sd, "csq_adapter", f"backbone={family}", crop,
                         codebook=_signed_codebook())[:4])


@functools.lru_cache(maxsize=None)
def _hf_clip():
    """A tiny Hugging Face CLIPModel's state dict (one for every case)."""
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, \
        CLIPVisionConfig

    torch.manual_seed(0)
    cfg = CLIPConfig(
        vision_config=CLIPVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=48, patch_size=8,
            projection_dim=32).to_dict(),
        text_config=CLIPTextConfig(
            hidden_size=48, intermediate_size=96, num_hidden_layers=1,
            num_attention_heads=4, max_position_embeddings=16,
            vocab_size=100, projection_dim=32).to_dict(),
        projection_dim=32)
    return _np(CLIPModel(cfg).state_dict())


def _adapters(rng, layers=2, D=64, bottleneck=8) -> dict:
    out = {}
    for i in range(layers):
        for slot in ("adapt_mlp_1", "adapt_mlp_2"):
            b = f"adapter_params.adapter_{i}_{slot}"
            out.update({f"{b}_down_proj_weight": _rand(rng, bottleneck, D),
                        f"{b}_down_proj_bias": _rand(rng, bottleneck),
                        f"{b}_up_proj_weight": _rand(rng, D, bottleneck),
                        f"{b}_up_proj_bias": _rand(rng, D),
                        f"{b}_scale": 1 + _rand(rng, 1),
                        f"{b}_adapter_layer_norm_weight": 1 + _rand(rng, D),
                        f"{b}_adapter_layer_norm_bias": _rand(rng, D)})
    return out


def test_clip_adapters_dpsh():
    rng = np.random.default_rng(3)
    sd = {f"backbone.model.{k}": v for k, v in _hf_clip().items()}
    sd.update(_adapters(rng))
    sd.update({"hash_fc.weight": _rand(rng, NBIT, 64),
               "hash_fc.bias": _rand(rng, NBIT),
               "extra.unknown": _rand(rng, 2)})
    _check(*_import_both(sd, "dpsh_adapter", "backbone=tiny_test")[:4])


def test_clip_concepthash_head():
    """The ConceptHash head (hash queries, the nn.MultiheadAttention block,
    hash_fc, its BatchNorm, the concept centroids, text_projection and the
    center) on the CLIP tower with adapters; the reference's keys are laid
    out from the port model's tensors' shapes, with seeded values."""
    rng = np.random.default_rng(4)
    cb = _rand(rng, NCLASS, 32, scale=1.0)
    extra = ("backbone=tiny_test", "model.text_projection_dims=[32]")
    _, tcfg = _configs("concepthash", *extra)
    shapes = {k: tuple(v.shape) for k, v in tmethods.build_model(
        tcfg, cb, device="cpu")[0].state_dict().items()}
    sd = {f"backbone.{k}": v for k, v in _hf_clip().items()}
    sd.update(_adapters(rng))
    E = shapes["hash_attention.sa.query.weight"][0]
    sd["hash_attention.sa.in_proj_weight"] = _rand(rng, 3 * E, E)
    sd["hash_attention.sa.in_proj_bias"] = _rand(rng, 3 * E)
    sd["hash_attention.sa.out_proj.weight"] = _rand(rng, E, E)
    sd["hash_attention.sa.out_proj.bias"] = _rand(rng, E)
    for dst, src in (("ffn_fc1", "ffn.0"), ("ffn_fc2", "ffn.3"),
                     ("ffn2", "ffn2"), ("norm1", "norm1"),
                     ("norm2", "norm2")):
        for leaf in ("weight", "bias"):
            sd[f"hash_attention.{src}.{leaf}"] = _rand(
                rng, *shapes[f"hash_attention.{dst}.{leaf}"]) + (
                    1.0 if "norm" in dst and leaf == "weight" else 0.0)
    for k in ("hash_queries", "hash_fc.weight", "concept_ce.centroids",
              "hash_bn.weight", "hash_bn.bias", "hash_bn.running_mean",
              "center", *(k for k in shapes
                          if k.startswith("text_projection."))):
        src = k.replace("text_projection.layers.", "text_projection.")
        if k == "hash_queries":
            src = "trainable_params.hash_queries"
        sd[src] = _rand(rng, *shapes[k], scale=0.5)
    for k in ("hash_pe", "concept_pe"):
        if k in shapes:
            sd[f"trainable_params.{k}"] = _rand(rng, *shapes[k])
    sd["hash_bn.running_var"] = 1 + np.abs(_rand(rng, *shapes[
        "hash_bn.running_var"]))
    sd["hash_bn.num_batches_tracked"] = np.array(5)
    sd["extra.unknown"] = _rand(rng, 2)
    want, got, jrep, trep, _ = _import_both(sd, "concepthash", *extra,
                                            codebook=cb)
    _check(want, got, jrep, trep, ("codes", "logits_cont"))


def test_hf_vit_csq():
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(0)
    hf = ViTModel(ViTConfig(hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=48, patch_size=8))
    rng = np.random.default_rng(5)
    sd = {f"backbone.model.{k}": v for k, v in _np(hf.state_dict()).items()}
    sd.update({"hash_fc.weight": _rand(rng, NBIT, 64),
               "extra.unknown": _rand(rng, 2)})
    want, got, jrep, trep, _ = _import_both(
        sd, "csq_adapter", "backbone=vit_s16", "backbone.layer_norm_eps=1e-12",
        *TINY, codebook=_signed_codebook())
    _check(want, got, jrep, trep)
    assert any(k.startswith("backbone.model.pooler.") for k in trep.unused)


def _timm_vit(rng, D=64, L=2, F=128, p=8, grid=6) -> dict:
    sd = {"cls_token": _rand(rng, 1, 1, D), "pos_embed":
          _rand(rng, 1, grid * grid + 1, D),
          "patch_embed.proj.weight": _rand(rng, D, 3, p, p),
          "patch_embed.proj.bias": _rand(rng, D),
          "norm.weight": 1 + _rand(rng, D), "norm.bias": _rand(rng, D)}
    for i in range(L):
        t = f"blocks.{i}"
        sd.update({f"{t}.norm1.weight": 1 + _rand(rng, D),
                   f"{t}.norm1.bias": _rand(rng, D),
                   f"{t}.norm2.weight": 1 + _rand(rng, D),
                   f"{t}.norm2.bias": _rand(rng, D),
                   f"{t}.attn.qkv.weight": _rand(rng, 3 * D, D),
                   f"{t}.attn.qkv.bias": _rand(rng, 3 * D),
                   f"{t}.attn.proj.weight": _rand(rng, D, D),
                   f"{t}.attn.proj.bias": _rand(rng, D),
                   f"{t}.mlp.fc1.weight": _rand(rng, F, D),
                   f"{t}.mlp.fc1.bias": _rand(rng, F),
                   f"{t}.mlp.fc2.weight": _rand(rng, D, F),
                   f"{t}.mlp.fc2.bias": _rand(rng, D)})
    return sd


def _timm_swin(rng, E=16, depths=(2, 2, 1, 1), grids=(8, 4, 2, 1),
               window=4) -> dict:
    sd = {"patch_embed.proj.weight": _rand(rng, E, 3, 4, 4),
          "patch_embed.proj.bias": _rand(rng, E),
          "patch_embed.norm.weight": 1 + _rand(rng, E),
          "patch_embed.norm.bias": _rand(rng, E),
          "norm.weight": 1 + _rand(rng, 8 * E), "norm.bias": _rand(rng, 8 * E)}
    for si, (depth, grid) in enumerate(zip(depths, grids)):
        C, ws = E * 2 ** si, min(window, grid)
        for bi in range(depth):
            t = f"layers.{si}.blocks.{bi}"
            sd.update({f"{t}.norm1.weight": 1 + _rand(rng, C),
                       f"{t}.norm1.bias": _rand(rng, C),
                       f"{t}.norm2.weight": 1 + _rand(rng, C),
                       f"{t}.norm2.bias": _rand(rng, C),
                       f"{t}.attn.qkv.weight": _rand(rng, 3 * C, C),
                       f"{t}.attn.qkv.bias": _rand(rng, 3 * C),
                       f"{t}.attn.proj.weight": _rand(rng, C, C),
                       f"{t}.attn.proj.bias": _rand(rng, C),
                       f"{t}.attn.relative_position_bias_table":
                           _rand(rng, (2 * ws - 1) ** 2, 2),
                       f"{t}.attn.relative_position_index":
                           np.zeros((ws * ws, ws * ws), np.int64),
                       f"{t}.mlp.fc1.weight": _rand(rng, 4 * C, C),
                       f"{t}.mlp.fc1.bias": _rand(rng, 4 * C),
                       f"{t}.mlp.fc2.weight": _rand(rng, C, 4 * C),
                       f"{t}.mlp.fc2.bias": _rand(rng, C)})
            if bi % 2 and ws < grid:
                sd[f"{t}.attn_mask"] = np.zeros((4, ws * ws, ws * ws),
                                                np.float32)
        if si < 3:
            sd.update({f"layers.{si}.downsample.norm.weight":
                       1 + _rand(rng, 4 * C),
                       f"layers.{si}.downsample.norm.bias": _rand(rng, 4 * C),
                       f"layers.{si}.downsample.reduction.weight":
                       _rand(rng, 2 * C, 4 * C)})
    return sd


@pytest.mark.parametrize("family", ["vit", "swin"])
def test_timm_backbones_csq(family):
    rng = np.random.default_rng(6)
    tower, width, extra = (
        (_timm_vit(rng), 64, ("backbone=vit_s16", *TINY)) if family == "vit"
        else (_timm_swin(rng), 128, ("backbone=swin_tiny",
                                     "backbone.variant=test",
                                     "backbone.window_size=4",
                                     "dataset.crop=32")))
    sd = {f"backbone.{k}": v for k, v in tower.items()}
    sd.update({"hash_fc.weight": _rand(rng, NBIT, width),
               "extra.unknown": _rand(rng, 2)})
    _check(*_import_both(sd, "csq_adapter", *extra,
                         codebook=_signed_codebook())[:4])


def test_adsh_biased_hash_layer_and_shape_mismatch():
    """adsh's Sequential(Linear, Tanh) with ``model.hash_bias=true``
    imports alike; a hash layer of another width raises ``ValueError`` in
    both packages."""
    rng = np.random.default_rng(7)
    sd = {f"backbone.{k}": v for k, v in _timm_vit(rng).items()}
    sd.update({"hash_fc.0.weight": _rand(rng, NBIT, 64),
               "hash_fc.0.bias": _rand(rng, NBIT),
               "extra.unknown": _rand(rng, 2)})
    extra = ("backbone=vit_s16", *TINY, "model.hash_bias=true")
    _check(*_import_both(sd, "adsh", *extra)[:4])
    sd["hash_fc.0.weight"] = _rand(rng, NBIT + 1, 64)
    sd["hash_fc.0.bias"] = _rand(rng, NBIT + 1)
    with pytest.raises(ValueError, match="shape"):
        _import_both(sd, "adsh", *extra)


def test_import_script_run_directory_validates(tvm, tmp_path):
    """``scripts/import_reference_checkpoint_torch.py`` writes
    ``config.yaml`` and ``models/best.pt``; ``main_gpu.py --device cpu
    exp=validation`` on it encodes the test split with the imported
    weights (the script's model's codes, bit for bit)."""
    from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import import_reference_checkpoint_torch as script
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    make_synthetic_dataset(str(tmp_path / "data" / "synthetic"),
                           nclass=NCLASS, per_class_train=2,
                           per_class_test=2, image_size=64)
    torch.manual_seed(0)
    m = tvm.resnet18()
    _warm_bn(m, 48)
    rng = np.random.default_rng(8)
    sd = {f"backbone.model.{k}": v for k, v in m.state_dict().items()}
    sd.update({"hash_fc.weight": torch.tensor(_rand(rng, NBIT, 512)),
               "hash_fc.bias": torch.tensor(_rand(rng, NBIT))})
    pth = tmp_path / "best.pth"
    torch.save(sd, pth)
    run = tmp_path / "imported"
    out = script.main(["--pth", str(pth), "--outdir", str(run),
                       "dataset=synthetic", "model=dpsh_adapter",
                       "backbone=resnet18", f"model.nbit={NBIT}",
                       f"data_dir={tmp_path}"])
    assert out["report"].unused == []
    assert (run / "config.yaml").exists() and \
        (run / "models" / "best.pt").exists()
    ev = main_gpu.build_experiment(["--device", "cpu", "exp=validation",
                                    f"logdir={run}", f"data_dir={tmp_path}"])
    res = ev.main()
    assert 0.0 <= res["mAP"] <= 1.0
    codes = ev.exp.encode_split("test")[0]["codes"]
    from concepthash_tpu_torch.data.preprocess import preprocess_batch

    want = []
    model = out["model"].eval()
    for batch in ev.exp.loaders["test"]:
        n = batch.pop("n_valid")
        x = preprocess_batch(torch.from_numpy(batch["image"][:n]),
                             crop=ev.exp.crop, norm=ev.exp.norm,
                             train=False)
        with torch.no_grad():
            want.append(model(x)["codes"])
    assert torch.equal(codes, torch.cat(want))
