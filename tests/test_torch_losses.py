"""The port's LGH objective (``losses/``) against the JAX package's: the
total and every part, and the gradients of the total with respect to each
model output it reads, for each loss scale switched on alone, the canonical
mix, and the options (blend before softmax, exponential concept weights,
plain concept logits, relu diversity, layer-averaged maps, registers,
multi-label rows). f32, rtol 1e-5 on values, atol 1e-6 on gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.losses import common as jcommon
from concepthash_tpu.losses.concepthash import lgh_loss as jlgh
from concepthash_tpu_torch.losses import common as tcommon
from concepthash_tpu_torch.losses.concepthash import lgh_loss as tlgh

B, C, Q, NBIT, H, L = 6, 7, 4, 16, 2, 14


def _outputs(seed, nregs=0, multilabel=False):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    logits = rng.standard_normal((2, B, H, L, L)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    out = {"logits": u(B, C), "logits_cont": u(B, C), "logits_bin": u(B, C),
           "logits_concept": u(Q, B, C), "codes": rng.standard_normal(
               (B, NBIT)).astype(np.float32),
           "logits_filip_i2t": u(B, C), "logits_filip_t2i": u(B, C),
           "attn_cache": tuple(attn.astype(np.float32))}
    y = rng.integers(0, C, B)
    onehot = np.eye(C, dtype=np.float32)[y]
    if multilabel:
        onehot[:, (y + 1) % C] = 1.0
    return out, onehot


def _run_both(outputs, onehot, kw):
    keys = [k for k in outputs if k != "attn_cache"]

    def jtotal(vals, attn):
        total, parts = jlgh({**dict(zip(keys, vals)), "attn_cache": attn},
                            jnp.asarray(onehot), **kw)
        return total, parts

    jvals = [jnp.asarray(outputs[k]) for k in keys]
    jattn = tuple(jnp.asarray(a) for a in outputs["attn_cache"])
    (jt, jparts), (jg, jga) = jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True)(jvals, jattn)

    tvals = [torch.tensor(outputs[k], requires_grad=True) for k in keys]
    tattn = tuple(torch.tensor(a, requires_grad=True)
                  for a in outputs["attn_cache"])
    tt, tparts = tlgh({**dict(zip(keys, tvals)), "attn_cache": tattn},
                      torch.tensor(onehot), **kw)
    tt.backward()
    return (jt, jparts, list(jg) + list(jga),
            tt, tparts, [t.grad for t in tvals + list(tattn)],
            keys + [f"attn_cache[{i}]" for i in range(len(tattn))])


SCALE_OFF = {k: 0.0 for k in ("logits", "hash_logits", "bin_logits",
                              "cont_logits", "concept_logits",
                              "attn_div_loss", "filip_logits")}
CASES = [
    *({"loss_scales": {**SCALE_OFF, k: 1.0}} for k in SCALE_OFF),
    {},                                              # the canonical mix
    {"loss_scales": {**SCALE_OFF, "hash_logits": 0.7},
     "avg_before_softmax": True, "lmbd": 0.3},
    {"loss_scales": {**SCALE_OFF, "concept_logits": 1.0},
     "exponential_scale": 2.0},
    {"loss_scales": {**SCALE_OFF, "concept_logits": 1.0},
     "concept_cossim": False},
    {"loss_scales": {**SCALE_OFF, "attn_div_loss": 0.5}, "div_method": 0,
     "div_min": 0.1, "avg_attn": True},
    {"loss_scales": {**SCALE_OFF, "attn_div_loss": 1.0}, "nregs": 1,
     "ncontext": 3},
    {"loss_scales": {"bin_logits": 2.0, "cont_logits": 0.5,
                     "concept_logits": 1.0, "hash_logits": 1.0},
     "multilabel": True},
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_lgh_loss_and_gradients_match_jax(case):
    kw = dict(CASES[case])
    multilabel = kw.pop("multilabel", False)
    outputs, onehot = _outputs(case, multilabel=multilabel)
    kw.setdefault("ncontext", Q)
    jt, jparts, jgrads, tt, tparts, tgrads, names = _run_both(outputs,
                                                              onehot, kw)
    np.testing.assert_allclose(float(tt.detach()), float(jt), rtol=1e-5)
    assert set(tparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k].detach()), float(jparts[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert not tparts["quan"].requires_grad
    for name, jg, tg in zip(names, jgrads, tgrads):
        jg = np.asarray(jg)
        if tg is None:                      # an output the loss never reads
            assert not jg.any(), name
            continue
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("fn", ["soft_cross_entropy", "margin_ce",
                                "quantization_cosine"])
def test_common_pieces_match_jax(fn):
    """The shared pieces on their own, including 3-d concept logits and
    codes with exact zeros (sign 0 counts in neither the numerator nor the
    denominator)."""
    outputs, onehot = _outputs(11)
    if fn == "soft_cross_entropy":
        args = (outputs["logits"], onehot / onehot.sum(-1, keepdims=True))
        extra = {}
    elif fn == "margin_ce":
        args = (outputs["logits_concept"], onehot)
        extra = {"margin": 0.2, "scale": 8.0}
    else:
        codes = outputs["codes"].copy()
        codes[:, :3] = 0.0
        args, extra = (codes,), {}
    want = getattr(jcommon, fn)(*(jnp.asarray(a) for a in args), **extra)
    got = getattr(tcommon, fn)(*(torch.tensor(a) for a in args), **extra)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
