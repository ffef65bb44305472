"""The encoder layer's route at each compute dtype and device: the decision
function ``whole_layer_route`` of the PyTorch port at every (setting, dtype,
device type), and the build-time error for the settings that ask for the
CUDA kernels (which take bfloat16 only) at float32 on the card. No card is
needed: a device type is a string here, and the model's build raises before
it touches a device."""

import pytest
import torch

import concepthash_tpu_torch.models.concepthash as tch
from concepthash_tpu_torch.models.clip import (ClipVisionConfig,
                                               check_kernel_dtype,
                                               whole_layer_route)

SETTINGS = ("auto", "xla", "pallas", "pallas_mlp", "pallas_layer")
VISION = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
              image_size=32, patch_size=8, projection_dim=32)
HEAD = dict(nbit=64, nclass=10, ncontext=4, center_dim=32,
            text_projection_dims=(32,))


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused_ln", SETTINGS)
def test_whole_layer_route(fused_ln, dtype, device_type):
    """'pallas_layer' always takes the whole layer; 'auto' takes it for
    inference forwards on the CPU at any dtype and on the card at bfloat16
    only; no other setting, no training forward under 'auto', and no layer
    whose adapters take no LayerNorm on their input ever takes it."""
    for train in (False, True):
        want = fused_ln == "pallas_layer" or (
            fused_ln == "auto" and not train
            and (device_type == "cpu" or dtype == torch.bfloat16))
        assert whole_layer_route(fused_ln, train, True, dtype,
                                 device_type) == want
        assert not whole_layer_route(fused_ln, train, False, dtype,
                                     device_type)


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attention_impl", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("fused_ln", SETTINGS)
def test_kernel_settings_need_bf16_on_the_card(fused_ln, attention_impl,
                                               dtype, device_type):
    """A setting that names the kernels raises at float32 on the card, with
    a message naming it and the dtype; everything else builds."""
    cfg = ClipVisionConfig(**VISION, fused_ln=fused_ln,
                           attention_impl=attention_impl)
    kernel = fused_ln.startswith("pallas") or attention_impl == "pallas"
    if kernel and device_type == "cuda" and dtype != torch.bfloat16:
        names = ([f"fused_ln='{fused_ln}'"] if fused_ln.startswith("pallas")
                 else []) + (["attention_impl='pallas'"]
                             if attention_impl == "pallas" else [])
        with pytest.raises(ValueError) as err:
            check_kernel_dtype(cfg, dtype, device_type)
        for name in names:
            assert name in str(err.value)
        assert "torch.float32" in str(err.value)
    else:
        check_kernel_dtype(cfg, dtype, device_type)


@pytest.mark.parametrize("vision", [dict(fused_ln="pallas"),
                                    dict(fused_ln="pallas_mlp"),
                                    dict(fused_ln="pallas_layer"),
                                    dict(attention_impl="pallas")])
def test_concepthash_build_raises_for_kernel_settings_at_f32_on_cuda(
        monkeypatch, vision):
    """ConceptHash checks its settings against its dtype and device when it
    is built: on 'cuda' at float32 an explicit kernel setting raises before
    any device is touched; at the default 'auto' the model builds (here on
    the CPU, standing in for the card's device after the check)."""
    monkeypatch.setattr(tch, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="bfloat16 only"):
        tch.ConceptHash(ClipVisionConfig(**VISION, **vision),
                        tch.ConceptHashConfig(**HEAD), dtype=torch.float32)
    monkeypatch.setattr(tch, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    model = tch.ConceptHash(ClipVisionConfig(**VISION, **vision),
                            tch.ConceptHashConfig(**HEAD),
                            dtype=torch.float32)
    assert model.dtype == torch.float32


def test_f32_auto_forward_on_cpu_takes_the_whole_layer(monkeypatch):
    """At float32 on the CPU the default model's inference forward runs the
    whole-layer function once per layer (its plain version), and a training
    forward none."""
    from concepthash_tpu_torch.models import clip

    calls = []
    real = clip.encoder_layer

    def layer(x, w, **kw):
        calls.append(x.dtype)
        return real(x, w, **kw)

    monkeypatch.setattr(clip, "encoder_layer", layer)
    model = tch.ConceptHash(ClipVisionConfig(**VISION),
                            tch.ConceptHashConfig(**HEAD), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    images = torch.randn(2, 32, 32, 3, generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        codes = model(images)["codes"]
    assert calls == [torch.float32] * VISION["num_layers"]
    assert codes.shape == (2, HEAD["nbit"]) and torch.isfinite(codes).all()
    calls.clear()
    model(images, train=True, generator=torch.Generator().manual_seed(2))
    assert calls == []
