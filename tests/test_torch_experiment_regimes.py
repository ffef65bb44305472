"""The port's CLI (``main_gpu.py --device cpu``) through its other regimes,
on the 3-class synthetic set of ``test_torch_experiment.py`` with the
``tiny_test`` backbone, 16 bits, batch 8, float32: the pretraining configs
(moco, dino, mae, autoencoder) train an epoch under ``exp=general``, a moco
run resumes to the uninterrupted run bit for bit, the adsh regime (adsh,
semicon) runs an epoch to its database codes, and the shallow regime (itq,
pca, lsh, sh) fits and scores. These need no JAX run, so they sit apart
from ``test_torch_experiment.py``'s reference fixtures."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from concepthash_tpu.data.synthetic import make_synthetic_dataset

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import main_gpu  # noqa: E402


def _args(wd, logdir, *extra):
    return ["dataset=synthetic", "model=concepthash", "backbone=tiny_test",
            "model.nbit=16", "model.text_projection_dims=[32]",
            "batch_size=8", "epochs=2", "eval_interval=1", f"data_dir={wd}",
            f"logdir={logdir}", "seed=7", "wandb=true", *extra]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torch_e2e")
    make_synthetic_dataset(str(wd / "data" / "synthetic"), nclass=3,
                           per_class_train=8, per_class_test=4, image_size=64)
    return str(wd)


def _history(logdir, name):
    with open(os.path.join(logdir, f"{name}_history.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("model", ["moco", "dino", "mae", "autoencoder"])
def test_pretraining_runs(workdir, model):
    """One epoch of each pretraining config (``exp: general``): a finite
    train record, a test record whose ``test_loss`` is the run's best (0 for
    all four: their eval forward carries no objective, as in the
    reference), and what the method keeps beside the model: moco's and
    dino's EMA teacher (dino's center too) in ``optims/last.pt``, the MAE's
    decoder in ``models/last.pt``."""
    logdir = os.path.join(workdir, f"pretrain_{model}")
    best = main_gpu.main(["--device", "cpu", *_args(workdir, logdir),
                          "epochs=1", f"model={model}",
                          "save_training_state=true"])
    train, test = _history(logdir, "train"), _history(logdir, "test")
    assert len(train) == len(test) == 1 and np.isfinite(train[0]["loss"])
    assert best == test[0]["test_loss"] == 0.0
    sd = torch.load(os.path.join(logdir, "models", "last.pt"))["model"]
    extra = torch.load(os.path.join(logdir, "optims",
                                    "last.pt")).get("extra", {})
    if model in ("moco", "dino"):
        teacher = extra["teacher"]
        assert set(teacher) == set(sd)
        assert ("pred_fc2.weight" in sd) == (model == "moco")
        assert train[0]["loss"] > 0
        if model == "moco":
            assert 0.99 <= train[0]["momentum"] < 1.0
        else:
            assert tuple(extra["center"].shape) == (16,)
            assert extra["center"].abs().max() > 0
    else:
        assert not extra
        assert {"recon_mse"} <= set(train[0])
        assert tuple(sd["dec_pred.weight"].shape) == (8 * 8 * 3, 256)
        assert tuple(sd["mask_token"].shape) == (1, 1, 256)


def test_moco_run_resumes_to_the_uninterrupted_run(workdir):
    """A moco run stopped after epoch 1 and resumed equals the
    uninterrupted 2-epoch run: the epoch-2 train record, the parameters
    and the EMA teacher restored from ``optims/last.pt``, bit for bit."""
    runs = {}
    for name in ("whole", "first", "resumed"):
        extra = ["model=moco", "save_training_state=true",
                 "eval_interval=2"]
        if name == "resumed":
            extra.append(f"resume_logdir={runs['first']}")
        logdir = os.path.join(workdir, f"moco_{name}")
        exp = main_gpu.build_experiment(["--device", "cpu",
                                         *_args(workdir, logdir), *extra])
        if name == "first":
            exp.epochs = 1
        exp.main()
        runs[name] = logdir
    whole, resumed = (_history(runs[n], "train") for n in ("whole",
                                                          "resumed"))
    assert len(whole) == len(resumed) == 2
    assert whole[1]["loss"] == resumed[1]["loss"]
    assert whole[1]["momentum"] == resumed[1]["momentum"]
    for kind, key in (("models", "model"), ("optims", "extra")):
        a, b = (torch.load(os.path.join(runs[n], kind, "last.pt"))[key]
                for n in ("whole", "resumed"))
        if kind == "optims":
            a, b = a["teacher"], b["teacher"]
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("model", ["adsh", "semicon"])
def test_adsh_regime_runs(workdir, model):
    """One epoch of the adsh regime (the csq head, SEMICON): finite train
    records with the objective's parts, a test record with mAP in [0, 1]
    scored against V, and V as ``outputs/db_codes.pt``: +-1, one row a
    train image."""
    logdir = os.path.join(workdir, f"adsh_{model}")
    best = main_gpu.main(["--device", "cpu", *_args(workdir, logdir),
                          "epochs=1", f"model={model}"])
    train, test = _history(logdir, "train"), _history(logdir, "test")
    assert len(train) == len(test) == 1 and np.isfinite(train[0]["loss"])
    assert {"hash", "quan"} <= set(train[0])
    assert best == test[0]["mAP"] and 0.0 <= best <= 1.0
    V = torch.load(os.path.join(logdir, "outputs", "db_codes.pt"))["V"]
    assert tuple(V.shape) == (24, 16)
    assert set(V.unique().tolist()) == {-1.0, 1.0}
    assert os.path.exists(os.path.join(logdir, "models", "best.pt"))


@pytest.mark.parametrize("model", ["itq", "pca", "lsh", "sh"])
def test_shallow_regime_runs(workdir, model):
    """The shallow regime's one pass: one test record at epoch 0 with a
    mAP in [0, 1] (the run's best), the fit in ``models/best.pt`` as
    ``criterion``, and ``exp=validation`` on the run raising the
    ``ValueError`` that names the cause."""
    logdir = os.path.join(workdir, f"shallow_{model}")
    best = main_gpu.main(["--device", "cpu", *_args(workdir, logdir),
                          f"model={model}"])
    test = _history(logdir, "test")
    assert len(test) == 1 and test[0]["ep"] == 0
    assert best == test[0]["mAP"] and 0.0 <= best <= 1.0
    assert not os.path.exists(os.path.join(logdir, "train_history.json"))
    blob = torch.load(os.path.join(logdir, "models", "best.pt"))
    assert blob["epoch"] == 0 and blob["criterion"]["kind"] == model
    with pytest.raises(ValueError, match="not a network checkpoint"):
        main_gpu.main(["--device", "cpu", "exp=validation",
                       f"logdir={logdir}", f"data_dir={workdir}",
                       f"eval_logdir={logdir}/val"])
