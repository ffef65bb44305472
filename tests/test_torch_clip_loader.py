"""The port's CLIP loader (``models.clip_loader``, ``utils.hf_local``)
against Hugging Face transformers and the JAX package, on the CPU: a tiny
random ``CLIPModel`` (as tests/test_clip_port.py builds it) saved with
``save_pretrained``, once as safetensors and once as ``pytorch_model.bin``;
the port's towers loaded from the directory match HF's vision and text
outputs at atol 1e-5, and the JAX package's towers built from
``vision_params_from_torch`` / ``text_params_from_torch`` of the same
weights. Also: the ``$HF_HOME`` cache layout, ``maybe_load_pretrained_vision``
(loads; and warns and keeps the init when the checkpoint is missing), and
the codebook's text stage run from the directory."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from concepthash_tpu.models.clip import ClipTextTower as JTextTower  # noqa: E402
from concepthash_tpu.models.clip import ClipVisionTower as JVisionTower  # noqa: E402
from concepthash_tpu.models.clip_loader import (  # noqa: E402
    merge_ported, text_config_from_hf, text_params_from_torch,
    vision_config_from_hf, vision_params_from_torch)
from concepthash_tpu_torch.models import backbone_factory as tfactory  # noqa: E402
from concepthash_tpu_torch.models import clip_loader as tcl  # noqa: E402
from concepthash_tpu_torch.models.clip import ClipVisionTower  # noqa: E402
from concepthash_tpu_torch.utils import hf_local  # noqa: E402

ATOL = 1e-5
EOS = 99


@pytest.fixture(scope="module")
def hf_model():
    from transformers import (CLIPConfig, CLIPModel, CLIPTextConfig,
                              CLIPVisionConfig)

    torch.manual_seed(0)
    cfg = CLIPConfig(
        vision_config=CLIPVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, image_size=32, patch_size=8,
            projection_dim=32).to_dict(),
        text_config=CLIPTextConfig(
            hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16,
            vocab_size=100, projection_dim=32, eos_token_id=EOS).to_dict(),
        projection_dim=32,
    )
    cfg._attn_implementation = "eager"
    return CLIPModel(cfg).eval()


@pytest.fixture(scope="module", params=["safetensors", "bin"])
def saved(request, hf_model, tmp_path_factory):
    path = tmp_path_factory.mktemp(f"clip_{request.param}")
    hf_model.save_pretrained(str(path), safe_serialization=(
        request.param == "safetensors"))
    files = set(os.listdir(path))
    assert ("model.safetensors" in files) == (request.param == "safetensors")
    return str(path)


def _images(n=2, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _ids(seed=3):
    ids = np.random.default_rng(seed).integers(1, EOS - 1, (3, 12))
    ids[0, -1] = ids[1, 5] = ids[2, 8] = EOS
    return ids


def test_state_dict_reader_equals_torch(hf_model, saved):
    sd = hf_local.load_state_dict(saved)
    want = hf_model.state_dict()
    assert set(k for k in want if not k.endswith("position_ids")) <= set(sd)
    for k, v in sd.items():
        assert torch.equal(v, want[k]), k


def test_vision_tower_matches_hf_and_jax(hf_model, saved):
    cfg = hf_local.load_config(saved)
    vcfg = tcl.vision_config_from_hf(cfg)
    tower = ClipVisionTower(vcfg, None)
    n = tcl.load_vision_weights(tower, saved)
    assert n == len(tcl.vision_state_from_hf(hf_model.state_dict(),
                                             vcfg.num_layers))
    img = _images()
    with torch.no_grad():
        got = tower(torch.from_numpy(img))
        hf = hf_model.vision_model(torch.from_numpy(img).permute(0, 3, 1, 2))
        hf_pooled = hf_model.visual_projection(hf.pooler_output)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               hf.last_hidden_state.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["pooled"].numpy(), hf_pooled.numpy(),
                               atol=ATOL, rtol=0)
    # the JAX package's tower from the same weights
    jcfg = vision_config_from_hf(hf_model.config.vision_config)
    jt = JVisionTower(jcfg)
    init = jt.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    params = merge_ported(init, vision_params_from_torch(
        hf_model.state_dict(), jcfg.num_layers))
    want = jt.apply({"params": params}, jnp.asarray(img))
    for key in ("last_hidden_state", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


def test_text_tower_matches_hf_and_jax(hf_model, saved):
    tower = tcl.load_text_tower(saved, device="cpu")
    assert tower.cfg.eos_token_id == EOS
    ids = _ids()
    with torch.no_grad():
        got = tower(input_ids=torch.from_numpy(ids))
        hf = hf_model.text_model(input_ids=torch.from_numpy(ids))
        hf_embeds = hf_model.text_projection(hf.pooler_output)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               hf.last_hidden_state.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["pooled"].numpy(),
                               hf.pooler_output.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["text_embeds"].numpy(),
                               hf_embeds.numpy(), atol=ATOL, rtol=0)
    jcfg = text_config_from_hf(hf_model.config.text_config)
    jt = JTextTower(jcfg)
    init = jt.init(jax.random.PRNGKey(0),
                   jnp.zeros((1, 12), jnp.int32))["params"]
    params = merge_ported(init, text_params_from_torch(
        hf_model.state_dict(), jcfg.num_layers))
    want = jt.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), atol=ATOL, rtol=0)


def test_legacy_eos_pools_at_the_highest_id():
    """A config with the old eos_token_id 2 pools at each row's highest id,
    as transformers does for it."""
    tcfg = tcl.text_config_from_hf({"text_config": {"eos_token_id": 2,
                                                    "vocab_size": 300}})
    assert tcfg.eos_token_id == 299
    assert tcl.text_config_from_hf({}).eos_token_id == 49407


def test_shape_mismatch_raises(saved):
    cfg = hf_local.load_config(saved)
    vcfg = tcl.vision_config_from_hf(cfg)
    import dataclasses

    wrong = ClipVisionTower(dataclasses.replace(vcfg, intermediate_size=64),
                            None)
    with pytest.raises(ValueError, match="shape mismatch"):
        tcl.load_vision_weights(wrong, saved)


def test_hf_home_cache_layout(saved, tmp_path, monkeypatch):
    repo = tmp_path / "hub" / "models--org--tiny-clip"
    snap = repo / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    for f in os.listdir(saved):
        os.symlink(os.path.join(saved, f), snap / f)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert hf_local.resolve_local("org/tiny-clip") == str(snap)
    # refs/main names the revision when there are several
    (repo / "snapshots" / "old").mkdir()
    with pytest.raises(OSError):
        hf_local.resolve_local("org/tiny-clip")
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abc123")
    assert hf_local.resolve_local("org/tiny-clip") == str(snap)
    assert hf_local.resolve_local(saved) == saved
    with pytest.raises(OSError, match="nothing is downloaded"):
        hf_local.resolve_local("org/absent")


def _backbone_cfg(name, pretrained=True):
    return {"name": name, "pretrained": pretrained, "hidden_size": 64,
            "intermediate_size": 128, "num_layers": 3, "num_heads": 4,
            "patch_size": 8, "image_size": 32, "projection_dim": 32}


def test_maybe_load_pretrained_vision(saved, hf_model):
    from concepthash_tpu_torch.models.clip import AdapterConfig
    from concepthash_tpu_torch.models.concepthash import (ConceptHash,
                                                          ConceptHashConfig)

    bcfg = _backbone_cfg(saved)
    vcfg = tfactory.vision_config_from_backbone_cfg(bcfg)
    model = ConceptHash(vcfg, ConceptHashConfig(nbit=16, nclass=5,
                                                center_dim=32,
                                                text_projection_dims=(32,)),
                        AdapterConfig(bottleneck_dim=16), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    adapter = model.backbone.layers[0].adapter_attn.down.weight.clone()
    assert tfactory.maybe_load_pretrained_vision(bcfg, model)
    want = tcl.vision_state_from_hf(hf_model.state_dict(), vcfg.num_layers)
    own = model.backbone.state_dict()
    for k, v in want.items():
        assert torch.equal(own[k], v), k
    assert torch.equal(model.backbone.layers[0].adapter_attn.down.weight,
                       adapter)
    assert not tfactory.maybe_load_pretrained_vision(
        _backbone_cfg(saved, pretrained=False), model)


def test_missing_checkpoint_warns_and_keeps_init(tmp_path, monkeypatch,
                                                 caplog):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    bcfg = _backbone_cfg("org/absent")
    tower = ClipVisionTower(tfactory.vision_config_from_backbone_cfg(bcfg),
                            None)
    before = {k: v.clone() for k, v in tower.state_dict().items()}

    class Holder:
        backbone = tower

    with caplog.at_level(logging.WARNING):
        assert not tfactory.maybe_load_pretrained_vision(bcfg, Holder())
    assert "pretrained weights unavailable" in caplog.text
    for k, v in tower.state_dict().items():
        assert torch.equal(v, before[k])


def test_codebook_text_stage_from_the_directory(saved, hf_model, tmp_path):
    """``embed_class_names`` reads the tower and tokenizer from the
    directory: the pooled output HF's text model gives for the same ids."""
    from concepthash_tpu_torch.models.tokenizer import bytes_to_unicode
    from concepthash_tpu_torch.train import codebook as tcb

    d = tmp_path / "clip"
    d.mkdir()
    for f in os.listdir(saved):
        os.symlink(os.path.join(saved, f), d / f)
    # a 100-id vocabulary: a-z with and without word ends, one merge,
    # bos 98, eos 99
    chars = [bytes_to_unicode()[b] for b in range(ord("a"), ord("z") + 1)]
    vocab = {c: i for i, c in enumerate(chars + [c + "</w>" for c in chars])}
    vocab.update({"ro": 60, "<|startoftext|>": 98, "<|endoftext|>": 99})
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\nr o\n")
    names = ["crow", "jay bird", "tit"]
    got = tcb.embed_class_names(names, str(d), prompt_prefix="a ",
                                device="cpu")
    from concepthash_tpu_torch.models.tokenizer import CLIPTokenizer

    ids = CLIPTokenizer.from_dir(str(d))([f"a {n}" for n in names],
                                         padding=True, truncation=True,
                                         return_tensors="np")["input_ids"]
    with torch.no_grad():
        want = hf_model.text_model(
            input_ids=torch.from_numpy(ids)).pooler_output.numpy()
    assert got.shape == (3, 48)
    assert 60 in ids and (ids[:, 1:4] < 99).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
