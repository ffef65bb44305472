"""The train slice of the PyTorch port on the CPU, against the JAX package:
three steps of the reference's ``make_train_step`` and of the port's, both
built from the same config dicts (the canonical ConceptHash objective and
optimizer, adam at lr 1e-3 with weight decay 1e-5, the csw schedule, a
frozen backbone) at a tiny size, from the same weights carried across by
``from_flax``. Both run ``attention_impl="pallas"``, ``fused_ln="pallas"``
(the reference's Pallas kernels in interpret mode, the port's plain
versions); a bf16 case and the ``xla``-against-``xla`` case follow.

Dropout is 0 here: JAX and torch random streams cannot be matched
(``test_torch_train_parts.py`` checks the port's dropout on its own)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu import methods as jmethods
from concepthash_tpu.ops import attention as jattention
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state
from concepthash_tpu.train.state import make_eval_step as jmake_eval_step
from concepthash_tpu.train.state import make_train_step as jmake_train_step
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.train.state import make_eval_step
from concepthash_tpu_torch.weights import from_flax

NCLASS, BATCH, IMAGE, STEPS, STEPS_PER_EPOCH = 10, 8, 48, 3, 2
# Parameters whose gradient is zero in exact arithmetic: the hash-query
# attention's softmax is invariant to the key bias (it shifts a whole row of
# logits), and the train-mode code BatchNorm to hash_pe (a constant shift of
# every code over the batch). Their gradients are rounding noise, which adam
# (plus the weight decay) turns into updates of up to the learning rate that
# no two frameworks share; they are checked to get no gradient instead.
NULL_GRADIENT = ("hash_attention.sa.key.bias", "hash_pe")


def config(dtype="float32"):
    """main.py's config groups for the canonical ConceptHash, cut to size:
    hidden 64, 2 layers, 4 heads, 48^2 images in patches of 8 (L = 36 + 1 +
    4 concepts = 41), adapters of width 16, 16 bits, 10 classes."""
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
        "compute_dtype": dtype, "seed": 0, "dataset": {"nclass": NCLASS},
    }


def batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        y = rng.integers(0, NCLASS, BATCH)
        out.append({"image": rng.standard_normal(
                        (BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
                    "label": np.eye(NCLASS, dtype=np.float32)[y]})
    return out


def _interpreted_pallas_forward(orig):
    def forward(q, k, v, interpret):
        return orig(q, k, v, True)     # the Pallas attention, interpreted
    return forward


def run_both(dtype, impl):
    """Three steps on each side from the same start, then one eval step.
    Returns the per-step metrics of both, the port's model and state dict
    before the steps, the JAX variables after them, and both eval steps'
    (codes, metrics)."""
    cfg = config(dtype)
    vision = dict(attention_impl=impl, fused_ln=impl)
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((NCLASS, 32)).astype(np.float32)
    jm = jmethods._build_concepthash(cfg, centers)
    jm = jm.clone(vision_cfg=jm.vision_cfg.__class__(
        **{**jm.vision_cfg.__dict__, **vision}))
    jloss = jmethods._lgh_build_loss(cfg, centers)
    sample = jnp.zeros((BATCH, IMAGE, IMAGE, 3))
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "_pallas_forward",
                   _interpreted_pallas_forward(jattention._pallas_forward))
        # one jit: the init op by op compiles each operation on its own
        variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
            {"params": key, "dropout": jax.random.fold_in(key, 1)}, sample)
        variables = jax.tree_util.tree_map(np.array, variables)
        # the adapters' up-projections start at zero, which would leave
        # their down-projections without a gradient: seeded values instead
        for i in range(cfg["backbone"]["num_layers"]):
            layer = variables["params"]["backbone"][f"layers_{i}"]
            for name in ("adapter_attn", "adapter_mlp"):
                up = layer[name]["up"]
                up["kernel"] = (0.1 * rng.standard_normal(up["kernel"].shape)
                                ).astype(np.float32)
        tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"],
                              STEPS_PER_EPOCH, variables["params"],
                              backbone_lr_scale=0.0)
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

    tr = tmethods.build_training(cfg, centers, STEPS_PER_EPOCH, device="cpu",
                                 vision=vision)
    pm = tr.model
    pm.load_state_dict(from_flax(variables), strict=True)
    before = copy.deepcopy(pm.state_dict())
    tmetrics = []
    for b in batches(2):
        m = tr.step({k: torch.tensor(v) for k, v in b.items()})
        tmetrics.append({k: float(v) for k, v in m.items()})
    # the eval step on the reference's trained variables: the null-gradient
    # parameters (see above) differ after training, and hash_pe moves the
    # codes once the BatchNorm uses running statistics
    trained = copy.deepcopy(pm)
    trained.load_state_dict(from_flax(jafter))
    teval = make_eval_step(trained, tr.loss_fn)(
        {k: torch.tensor(v) for k, v in eval_batch.items()})
    return jmetrics, tmetrics, pm, before, jafter, (jeval, teval)


@pytest.fixture(scope="module")
def f32_pallas():
    return run_both("float32", "pallas")


def test_losses_and_accuracies_match_per_step(f32_pallas):
    """Each step's loss, its parts (bin, cont, concept, quan) and the
    accuracies: f32, rtol 1e-4."""
    jm, tm = f32_pallas[:2]
    for step, (j, t) in enumerate(zip(jm, tm)):
        assert set(j) == set(t), (set(j), set(t))
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step}: {k}")
    assert {"loss", "bin", "cont", "concept", "quan", "acc_cont", "acc_bin",
            "acc_concept"} <= set(tm[0])


def test_trained_params_and_bn_stats_match(f32_pallas):
    """After three steps, every parameter and BN running statistic, carried
    back from the JAX variables through ``from_flax``: f32, rtol 1e-4 (atol
    1e-6, 1% of the first steps' learning rate, for entries near zero);
    ``NULL_GRADIENT`` within the updates' bound, 2 x the summed rates."""
    _, _, pm, before, jafter, _ = f32_pallas
    want = from_flax(jafter)
    got = pm.state_dict()
    assert set(got) == set(want)
    for k in got:
        if k in NULL_GRADIENT:
            assert (got[k] - want[k]).abs().max() <= 2 * 4e-4, k
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for stat in ("hash_bn.running_mean", "hash_bn.running_var"):
        assert not torch.equal(got[stat], torch.zeros_like(got[stat]) +
                               (stat.endswith("var")))


def test_frozen_params_bit_unchanged(f32_pallas):
    """The backbone outside the adapters is frozen: no gradient, no optimizer
    state, bit-unchanged on both sides; the adapters and heads moved."""
    _, _, pm, before, jafter, _ = f32_pallas
    want = from_flax(jafter)
    frozen = [n for n, p in pm.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith("backbone.") and "adapter" not in n
                          for n in frozen)
    for n in frozen:
        assert torch.equal(pm.state_dict()[n], before[n]), n
        assert torch.equal(want[n], before[n]), n
    for n, p in pm.named_parameters():
        if p.requires_grad and n != "backbone.layers.0.adapter_attn.scale":
            assert not torch.equal(p.detach(), before[n]), n


def test_eval_step_matches(f32_pallas):
    """One eval step on the variables after the three train steps (running
    statistics in the BatchNorm, no dropout): the codes (atol 1e-4, as the
    serving slice's forward) and the loss, parts and accuracies (rtol
    1e-4)."""
    (jcodes, jmetrics), (tcodes, tmetrics) = f32_pallas[5]
    assert set(tcodes) == set(jcodes) == {"codes"}
    np.testing.assert_allclose(tcodes["codes"].numpy(),
                               np.asarray(jcodes["codes"]), rtol=0, atol=1e-4)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_null_gradient_params_get_none(f32_pallas):
    """The parameters left out above get a gradient of rounding size only
    (< 1e-6 of the largest gradient entry) in the port's train forward."""
    pm = copy.deepcopy(f32_pallas[2])
    pm.load_state_dict(f32_pallas[3])
    b = batches(2)[0]
    out = pm(torch.tensor(b["image"]), train=True)
    loss_fn = tmethods._lgh_build_loss(config(), None)
    pm.zero_grad()
    loss_fn(out, {"label": torch.tensor(b["label"])})[0].backward()
    grads = {n: p.grad.abs().max() for n, p in pm.named_parameters()
             if p.grad is not None}
    top = max(grads.values())
    for n in NULL_GRADIENT:
        assert grads[n] < 1e-6 * top, (n, float(grads[n]), float(top))


def test_bf16_steps_match():
    """compute_dtype bfloat16 on both sides: bf16 rounds at other places in
    the two frameworks, so each step's loss and parts agree within 2e-2
    relative, and the trained tensors' updates point the same way (cosine
    >= 0.9 against the reference's)."""
    jm, tm, pm, before, jafter, _ = run_both("bfloat16", "pallas")
    for j, t in zip(jm, tm):
        for k in ("loss", "bin", "cont", "concept", "quan"):
            np.testing.assert_allclose(t[k], j[k], rtol=2e-2, err_msg=k)
    want = from_flax(jafter)
    for n, p in pm.named_parameters():
        if not p.requires_grad or n in NULL_GRADIENT:
            continue
        d_got = (p.detach() - before[n]).flatten().double()
        d_want = (want[n] - before[n]).flatten().double()
        cos = torch.nn.functional.cosine_similarity(d_got, d_want, dim=0)
        assert cos >= 0.9, (n, float(cos))


def test_xla_steps_match():
    """attention_impl and fused_ln 'xla' on both sides (the einsum attention
    and the separate LayerNorm and Linear): f32, rtol 1e-4 per step and on
    the trained parameters."""
    jm, tm, pm, _, jafter, _ = run_both("float32", "xla")
    for j, t in zip(jm, tm):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    want = from_flax(jafter)
    for k, v in pm.state_dict().items():
        if k not in NULL_GRADIENT:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
