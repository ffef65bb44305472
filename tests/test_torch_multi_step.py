"""Several steps per call (``train.state.make_multi_train_step`` and
``make_multi_eval_step``) on the CPU: K=3 steps of the multi step equal
three single steps exactly (dropout on, the same generator), and equal the
JAX package's ``make_multi_train_step`` (``lax.scan``) on bridged weights
and the same stacked batches at rtol 1e-4 with dropout 0, the tolerance of
test_torch_train_slice.py; the multi eval step equals the sequential eval
and JAX's ``make_multi_eval_step``; an epoch at ``train_chunk=3`` with a
tail writes the history ``train_chunk=1`` writes; ``auto`` is 8 on CUDA and
1 on the CPU. Also the float32 schedule the card's graphs read
(``optim.scheduled_lrs``) against ``current_lr``, and chunked meters."""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu import methods as jmethods
from concepthash_tpu.train.optim import build_optimizer as jbuild_optimizer
from concepthash_tpu.train.state import create_train_state as jcreate_state
from concepthash_tpu.train.state import make_multi_eval_step as jmulti_eval
from concepthash_tpu.train.state import make_multi_train_step as jmulti_train
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.experiments.hashing import resolve_train_chunk
from concepthash_tpu_torch.train import optim as toptim
from concepthash_tpu_torch.train.state import (make_eval_step,
                                               make_multi_eval_step,
                                               make_multi_train_step,
                                               make_train_step)
from concepthash_tpu_torch.utils.meters import MeterBank
from concepthash_tpu_torch.weights import from_flax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import main_gpu  # noqa: E402

NCLASS, BATCH, IMAGE, K, STEPS_PER_EPOCH = 10, 8, 48, 3, 2


def config(dropout=0.0):
    """The canonical ConceptHash cut to size (hidden 64, 2 layers, 48^2
    images in patches of 8, adapters of 16, 16 bits, 10 classes), adam at
    lr 1e-3, csw, frozen backbone."""
    return {
        "model": {"name": "concepthash", "nbit": 16, "nclass": NCLASS,
                  "ncontext": 4, "has_adapter": True,
                  "adapter_bottleneck_dim": 16,
                  "upt_config": {"multi": True, "num_heads": 8,
                                 "dropout": dropout,
                                 "ensemble_method": "concat",
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


def stacked(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, NCLASS, (K, BATCH))
    return {"image": rng.standard_normal(
                (K, BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
            "label": np.eye(NCLASS, dtype=np.float32)[y]}


def _centers():
    return np.random.default_rng(1).standard_normal((NCLASS, 32)).astype(
        np.float32)


def _torch(batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


def test_multi_step_equals_single_steps_exactly():
    cfg = config(dropout=0.1)
    a = tmethods.build_training(cfg, _centers(), STEPS_PER_EPOCH,
                                device="cpu")
    b = tmethods.build_training(cfg, _centers(), STEPS_PER_EPOCH,
                                device="cpu")
    multi = make_multi_train_step(a.model, a.loss_fn, a.optimizer,
                                  a.scheduler, generator=a.generator)
    batches = _torch(stacked(2))
    got = multi(batches)
    singles = [b.step({k: v[i] for k, v in batches.items()})
               for i in range(K)]
    assert set(got) == set(singles[0])
    for key, v in got.items():
        assert v.shape == (K,)
        assert torch.equal(v, torch.stack([s[key] for s in singles])), key
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.scheduler.last_epoch == b.scheduler.last_epoch == K
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    # every step's rate is the float32 of the reference's schedule
    want_lr = [toptim.current_lr(cfg["optim"], cfg["scheduler"],
                                 cfg["epochs"], STEPS_PER_EPOCH, e)
               for e in range(K)]
    assert multi.last_lrs.tolist() == want_lr


@pytest.fixture(scope="module")
def both():
    """K steps of JAX's scan and of the port's multi step from the same
    weights (``xla`` on both sides), then both multi eval steps on the
    trained weights."""
    cfg = config()
    centers = _centers()
    jm = jmethods._build_concepthash(cfg, centers)
    jloss = jmethods._lgh_build_loss(cfg, centers)
    sample = jnp.zeros((BATCH, IMAGE, IMAGE, 3))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)}, sample)
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(4)
    for i in range(cfg["backbone"]["num_layers"]):
        layer = variables["params"]["backbone"][f"layers_{i}"]
        for name in ("adapter_attn", "adapter_mlp"):
            up = layer[name]["up"]
            up["kernel"] = (0.1 * rng.standard_normal(up["kernel"].shape)
                            ).astype(np.float32)
    tx = jbuild_optimizer(cfg["optim"], cfg["scheduler"], cfg["epochs"],
                          STEPS_PER_EPOCH, variables["params"],
                          backbone_lr_scale=0.0)
    state = jcreate_state(jm, tx, sample, key, variables=variables)
    batches = stacked(2)
    state, jmetrics = jmulti_train(jm, jloss, tx, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batches.items()})
    eval_batches = stacked(3)
    jcodes, jeval = jmulti_eval(jm, jloss)(
        state, {k: jnp.asarray(v) for k, v in eval_batches.items()})
    jafter = jax.tree_util.tree_map(np.asarray, state.variables())

    tr = tmethods.build_training(cfg, centers, STEPS_PER_EPOCH, device="cpu")
    tr.model.load_state_dict(from_flax(variables), strict=True)
    multi = make_multi_train_step(tr.model, tr.loss_fn, tr.optimizer,
                                  tr.scheduler, generator=tr.generator)
    tmetrics = multi(_torch(batches))
    trained = tmethods.build_training(cfg, centers, STEPS_PER_EPOCH,
                                      device="cpu")
    trained.model.load_state_dict(from_flax(jafter))
    tcodes, teval = make_multi_eval_step(trained.model, trained.loss_fn)(
        _torch(eval_batches))
    return (jmetrics, tmetrics, jcodes, jeval, tcodes, teval, trained,
            eval_batches)


def test_multi_step_matches_jax_scan(both):
    jmetrics, tmetrics = both[:2]
    assert set(jmetrics) == set(tmetrics)
    for key in jmetrics:
        np.testing.assert_allclose(tmetrics[key].numpy(),
                                   np.asarray(jmetrics[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert tmetrics["loss"].shape == (K,)


def test_multi_eval_matches_sequential_and_jax(both):
    _, _, jcodes, jeval, tcodes, teval, trained, eval_batches = both
    step = make_eval_step(trained.model, trained.loss_fn)
    batches = _torch(eval_batches)
    for i in range(K):
        codes, metrics = step({k: v[i] for k, v in batches.items()})
        assert torch.equal(tcodes["codes"][i], codes["codes"])
        for key in metrics:
            assert torch.equal(teval[key][i], metrics[key]), key
    assert tcodes["codes"].shape == (K, BATCH, 16)
    np.testing.assert_allclose(tcodes["codes"].numpy(),
                               np.asarray(jcodes["codes"]), atol=1e-4, rtol=0)
    for key in jeval:
        np.testing.assert_allclose(teval[key].numpy(), np.asarray(jeval[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_auto_train_chunk():
    assert resolve_train_chunk("auto", torch.device("cuda")) == 8
    assert resolve_train_chunk("auto", torch.device("cpu")) == 1
    assert resolve_train_chunk(None, torch.device("cuda")) == 8
    assert resolve_train_chunk(3, torch.device("cuda")) == 3
    assert resolve_train_chunk("2", torch.device("cpu")) == 2
    assert resolve_train_chunk(0, torch.device("cpu")) == 1


def test_scheduled_lrs_are_current_lr():
    """The float32 rates a graphed chunk reads: column 0 is current_lr
    exactly, a scaled group its base times the same multiplier."""
    model = torch.nn.Sequential()
    model.add_module("backbone", torch.nn.Linear(2, 2))
    model.add_module("head", torch.nn.Linear(2, 2))
    for sched in ({"name": "csw", "warmup_epochs": 3},
                  {"name": "step", "step_size": 2, "gamma": 0.5}):
        opt, sch = toptim.build_optimizer({"lr": 1e-3}, sched, 9, 5, model,
                                          backbone_lr_scale=0.1)
        rates = toptim.scheduled_lrs(sch, 7, 30)
        assert rates.shape == (30, 2) and rates.dtype == np.float32
        for i, s in enumerate(range(7, 37)):
            assert float(rates[i, 0]) == toptim.current_lr(
                {"lr": 1e-3}, sched, 9, 5, s)
        # the state dict leaves the law out and loads back
        sd = sch.state_dict()
        assert "epoch_multiplier" not in sd
        sch.load_state_dict(sd)
        assert np.array_equal(toptim.scheduled_lrs(sch, 7, 30), rates)


class _Tiny(torch.nn.Module):
    """A frozen-able 'backbone' and a head: two parameter groups at
    backbone_lr_scale 0.1, with the train step's model interface."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.backbone = torch.nn.Linear(3, 4)
        self.head = torch.nn.Linear(4, 2)

    def forward(self, x, train=False, output_attentions=False,
                generator=None):
        return {"logits": self.head(torch.tanh(self.backbone(x)))}


def test_every_step_takes_the_float32_schedule():
    """Over a csw schedule crossing epoch boundaries (warm-up, then the
    cosine), the rate each single step's optimizer reads, per group, is
    ``scheduled_lrs``'s float32 exactly, and a chunk's ``last_lrs`` is its
    column 0: one arithmetic on every device and at every train_chunk."""
    sched, epochs, spe, steps = {"name": "csw", "warmup_epochs": 2}, 5, 2, 9
    rng = np.random.default_rng(0)
    batches = [{"image": torch.tensor(rng.standard_normal((4, 3)),
                                      dtype=torch.float32),
                "label": torch.eye(2)[rng.integers(0, 2, 4)]}
               for _ in range(steps)]

    def loss_fn(out, batch):
        total = ((out["logits"] - batch["label"]) ** 2).mean()
        return total, {}

    seen, rates = [], None
    for chunked in (False, True):
        model = _Tiny()
        opt, sch = toptim.build_optimizer({"lr": 1e-3}, sched, epochs, spe,
                                          model, backbone_lr_scale=0.1)
        if rates is None:
            rates = toptim.scheduled_lrs(sch, 0, steps)
        opt.register_step_pre_hook(lambda o, args, kwargs: seen.append(
            [g["lr"] for g in o.param_groups]))
        if chunked:
            multi = make_multi_train_step(model, loss_fn, opt, sch)
            stacked = {k: torch.stack([b[k] for b in batches])
                       for k in batches[0]}
            multi(stacked)
            assert multi.last_lrs.tolist() == [float(r) for r in rates[:, 0]]
        else:
            step = make_train_step(model, loss_fn, opt, sch)
            for b in batches:
                step(b)
    assert len({round(float(r), 12) for r in rates[:, 0]}) > 2
    want = [[float(r) for r in row] for row in rates]
    assert seen == want + want
    assert all(type(lr) is float for row in seen for lr in row)


def test_make_capturable_keeps_the_rates():
    model = torch.nn.Linear(3, 2)
    opt, sch = toptim.build_optimizer({"lr": 1e-3}, None, 4, 2, model)
    lrs = toptim.make_capturable(opt)
    assert torch.is_tensor(opt.param_groups[0]["lr"])
    assert lrs[0] is opt.param_groups[0]["lr"]
    assert opt.param_groups[0]["capturable"]
    sch.step()
    assert float(lrs[0]) == pytest.approx(sch.get_last_lr()[0], rel=1e-7)
    toptim.follow_schedule(opt, sch)
    assert float(lrs[0]) == float(toptim.scheduled_lrs(sch, 1, 1)[0, 0])
    # sgd (configs/optim/sgd.yaml) gets a tensor rate and keeps no counter;
    # the stock SGD, whose step reads its rate on the host, still raises
    sgd, sch = toptim.build_optimizer(
        {"name": "sgd", "lr": 1e-3, "momentum": 0.9}, None, 4, 2, model)
    lrs = toptim.make_capturable(sgd)
    assert lrs[0] is sgd.param_groups[0]["lr"] and torch.is_tensor(lrs[0])
    assert "capturable" not in sgd.param_groups[0]
    sch.step()
    toptim.follow_schedule(sgd, sch)
    assert float(lrs[0]) == float(toptim.scheduled_lrs(sch, 1, 1)[0, 0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        toptim.make_capturable(torch.optim.SGD(model.parameters(), lr=0.1))


@pytest.mark.parametrize("cfg", [
    {"momentum": 0.0, "weight_decay": 0.0},
    {"momentum": 0.9, "weight_decay": 5e-4},
    {"momentum": 0.9, "weight_decay": 5e-4, "nesterov": True},
])
def test_capturable_sgd_steps_equal_the_stock_steps(cfg):
    """Four sgd steps with the rates as device tensors (the step a CUDA
    graph captures) against the stock step with float rates, over a warm-up
    schedule, from the same weights and batches; and the momentum buffers
    they leave."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((4, 8, 5)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal((4, 8, 3)), dtype=torch.float32)
    models, opts = [], []
    for capturable in (False, True):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Tanh(),
                                    torch.nn.Linear(7, 3))
        opt, sch = toptim.build_optimizer(
            {"name": "sgd", "lr": 0.05, **cfg},
            {"name": "csw", "warmup_epochs": 2}, 6, 1, model)
        assert isinstance(opt, toptim.CapturableSGD)
        if capturable:
            toptim.make_capturable(opt)
        for k in range(4):
            loss = ((model(x[k]) - y[k]) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            toptim.follow_schedule(opt, sch)
            opt.step()
            sch.step()
        models.append(model)
        opts.append(opt)
    for (n, p), q in zip(models[0].named_parameters(),
                         models[1].parameters()):
        torch.testing.assert_close(q, p, atol=1e-6, rtol=1e-6, msg=n)
        if cfg["momentum"]:
            torch.testing.assert_close(opts[1].state[q]["momentum_buffer"],
                                       opts[0].state[p]["momentum_buffer"],
                                       atol=1e-6, rtol=1e-6, msg=n)
        else:
            assert q not in opts[1].state


def test_meters_take_a_chunk():
    a, b = MeterBank(), MeterBank()
    vals = [torch.tensor(1.5), torch.tensor(2.0), torch.tensor(4.0)]
    for v, n in zip(vals, (8, 8, 3)):
        a.update_device({"loss": v}, n)
    b.update_device({"loss": torch.stack(vals)}, [8, 8, 3])
    assert a.materialize() == b.materialize()


def _args(wd, logdir, *extra):
    return ["--device", "cpu", "dataset=synthetic", "model=concepthash",
            "backbone=tiny_test", "model.nbit=16",
            "model.text_projection_dims=[32]", "batch_size=4", "epochs=2",
            "eval_interval=1", f"data_dir={wd}", f"logdir={logdir}", "seed=7",
            *extra]


def test_chunked_epoch_writes_the_same_history(tmp_path):
    """24 train images in batches of 4: 6 steps an epoch, two chunks of 3
    at train_chunk=3; train_chunk=4 leaves a tail of 2 single steps. Eval
    chunks the full batches of the 12 test and 24 database images."""
    from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset

    wd = str(tmp_path)
    make_synthetic_dataset(os.path.join(wd, "data", "synthetic"), nclass=3,
                           per_class_train=8, per_class_test=4,
                           image_size=64)
    hist = {}
    for chunk in (1, 3, 4):
        logdir = os.path.join(wd, f"c{chunk}")
        exp = main_gpu.build_experiment(_args(wd, logdir,
                                              f"train_chunk={chunk}"))
        assert exp.train_chunk == chunk
        exp.main()
        with open(os.path.join(logdir, "train_history.json")) as f:
            train = json.load(f)
        with open(os.path.join(logdir, "test_history.json")) as f:
            test = json.load(f)
        for r in train:
            r.pop("time")
        hist[chunk] = (train, test)
        codes = torch.load(os.path.join(logdir, "outputs", "db_best.pt"))
        hist[chunk] += (codes["codes"],)
    for chunk in (3, 4):
        assert hist[chunk][0] == hist[1][0]
        assert hist[chunk][1] == hist[1][1]
        assert torch.equal(hist[chunk][2], hist[1][2])
