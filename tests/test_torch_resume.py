"""Checkpoints, resume and the train-only experiment of the port on the CPU
(3-class synthetic set, ``tiny_test`` backbone, 16 bits, batch 4, float32):
``save_training_state`` writes ``optims/``; a run stopped after epoch 1 and
resumed with ``resume_logdir`` equals the uninterrupted run at epoch 2
(parameters, BatchNorm statistics and history within 1e-6), at one step a
dispatch and at three; the strict restore raises on a changed shape and
names ``finetune_path``; ``GeneralExperiment`` keeps the lowest test loss,
and ``main_gpu.py exp=general`` runs as a script."""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset
from concepthash_tpu_torch.experiments.hashing import GeneralExperiment

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import main_gpu  # noqa: E402

TOL = 1e-6


def _args(wd, logdir, *extra):
    return ["--device", "cpu", "dataset=synthetic", "model=concepthash",
            "backbone=tiny_test", "model.nbit=16",
            "model.text_projection_dims=[32]", "batch_size=4", "epochs=2",
            "eval_interval=1", f"data_dir={wd}", f"logdir={logdir}", "seed=5",
            "save_training_state=true", *extra]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torch_resume")
    make_synthetic_dataset(str(wd / "data" / "synthetic"), nclass=3,
                           per_class_train=6, per_class_test=2, image_size=64)
    return str(wd)


def _history(logdir, name):
    with open(os.path.join(logdir, f"{name}_history.json")) as f:
        return json.load(f)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "time"} for r in records]


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    else:
        assert a == pytest.approx(b, abs=TOL, rel=0)


@pytest.mark.parametrize("chunk", [1, 3])
def test_resume_equals_the_uninterrupted_run(workdir, chunk):
    whole = os.path.join(workdir, f"whole{chunk}")
    first = os.path.join(workdir, f"first{chunk}")
    resumed = os.path.join(workdir, f"resumed{chunk}")
    a = main_gpu.build_experiment(_args(workdir, whole,
                                        f"train_chunk={chunk}"))
    a.main()
    b = main_gpu.build_experiment(_args(workdir, first,
                                        f"train_chunk={chunk}"))
    b.epochs = 1                        # stopped after epoch 1
    b.main()
    for name in ("best", "last"):
        assert os.path.exists(os.path.join(first, "optims", f"{name}.pt"))
    blob = torch.load(os.path.join(first, "optims", "last.pt"))
    assert set(blob) == {"optimizer", "scheduler", "step", "generators",
                         "loader_epoch", "epoch"}
    assert blob["step"] == len(b.loaders["train"]) and blob["epoch"] == 0
    assert set(blob["generators"]) == {"dropout", "augment", "op"}
    c = main_gpu.build_experiment(_args(workdir, resumed,
                                        f"train_chunk={chunk}",
                                        f"resume_logdir={first}"))
    assert c.start_epoch == 1 and c.best_metric is not None
    c.main()
    sa, sc = a.model.state_dict(), c.model.state_dict()
    for k in sa:
        torch.testing.assert_close(sc[k], sa[k], atol=TOL, rtol=0, msg=k)
    for name in ("train", "test"):
        _close(_strip(_history(resumed, name)), _strip(_history(whole, name)))
    assert c.state.step == a.state.step == 2 * len(a.loaders["train"])


def test_strict_restore_raises_on_a_changed_shape(workdir):
    run = os.path.join(workdir, "whole1")
    if not os.path.exists(os.path.join(run, "models", "last.pt")):
        main_gpu.build_experiment(_args(workdir, run)).main()
    with pytest.raises(ValueError, match="finetune_path"):
        main_gpu.build_experiment(_args(workdir,
                                        os.path.join(workdir, "wider"),
                                        "model.nbit=32",
                                        f"resume_logdir={run}"))
    # the lenient finetune keeps the fresh head and loads the rest
    exp = main_gpu.build_experiment(_args(workdir,
                                          os.path.join(workdir, "ft"),
                                          "model.nbit=32",
                                          f"finetune_path={run}"))
    assert exp.start_epoch == 0


def test_general_experiment_keeps_the_lowest_test_loss(workdir):
    logdir = os.path.join(workdir, "general")
    exp = main_gpu.build_experiment(_args(workdir, logdir, "exp=general",
                                          "epochs=3"))
    assert isinstance(exp, GeneralExperiment)
    best = exp.main()
    losses = [r["test_loss"] for r in _history(logdir, "test")]
    assert len(losses) == 3 and best == min(losses)
    ep = torch.load(os.path.join(logdir, "models", "best.pt"))["epoch"]
    assert losses[ep] == best
    assert not os.path.exists(os.path.join(logdir, "outputs",
                                           "test_best.pt"))
    # a resumed train-only run takes the lowest as its best
    exp2 = main_gpu.build_experiment(_args(
        workdir, os.path.join(workdir, "general2"), "exp=general",
        "epochs=3", f"resume_logdir={logdir}"))
    assert exp2.best_metric == best and exp2.start_epoch == 3


def test_main_gpu_exp_general_runs_as_a_script(workdir):
    logdir = os.path.join(workdir, "script")
    out = subprocess.run(
        [sys.executable, str(ROOT / "main_gpu.py"),
         *_args(workdir, logdir, "exp=general", "epochs=1")],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(_history(logdir, "test")) == 1
    assert os.path.exists(os.path.join(logdir, "optims", "last.pt"))


def test_train_state_keeps_a_capturable_optimizer_form():
    """Loading a train state into a capturable optimizer (a graphed run's)
    keeps its own lr tensors in the live groups, the ones a captured step
    reads, set to the loaded rate."""
    from concepthash_tpu_torch.train import optim as toptim
    from concepthash_tpu_torch.train.state import create_train_state

    model = torch.nn.Linear(3, 2)
    opt, sch = toptim.build_optimizer({"lr": 1e-3}, None, 4, 2, model)
    src = create_train_state(model, opt, sch,
                             {"g": torch.Generator().manual_seed(1)})
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    sch.step()
    sd = src.state_dict()
    model2 = torch.nn.Linear(3, 2)
    opt2, sch2 = toptim.build_optimizer({"lr": 5e-3}, None, 4, 2, model2)
    lrs = toptim.make_capturable(opt2)
    dst = create_train_state(model2, opt2, sch2,
                             {"g": torch.Generator().manual_seed(2)})
    dst.load_state_dict(sd)
    group = opt2.param_groups[0]
    assert group["lr"] is lrs[0] and group["capturable"]
    assert float(lrs[0]) == pytest.approx(opt.param_groups[0]["lr"],
                                          rel=1e-7)
    assert dst.step == 1
    assert torch.equal(dst.generators["g"].get_state(),
                       src.generators["g"].get_state())
    for p in model2.parameters():
        assert opt2.state[p]["step"].dtype == torch.float32


def test_train_state_loads_into_a_capturable_sgd():
    """An sgd train state (momentum buffers) loads into a capturable sgd:
    the live group keeps its own lr tensor at the loaded rate and takes no
    capturable flag; the next steps equal those of the saved optimizer."""
    from concepthash_tpu_torch.train import optim as toptim
    from concepthash_tpu_torch.train.state import create_train_state

    cfg = {"name": "sgd", "lr": 0.1, "momentum": 0.9, "weight_decay": 1e-3}
    x = torch.linspace(-1, 1, 6).reshape(2, 3)
    model = torch.nn.Linear(3, 2)
    opt, sch = toptim.build_optimizer(cfg, None, 4, 2, model)
    src = create_train_state(model, opt, sch, {})
    model(x).square().sum().backward()
    opt.step()
    sch.step()
    model2 = torch.nn.Linear(3, 2)
    model2.load_state_dict(model.state_dict())
    opt2, sch2 = toptim.build_optimizer(dict(cfg, lr=0.5), None, 4, 2,
                                        model2)
    lrs = toptim.make_capturable(opt2)
    dst = create_train_state(model2, opt2, sch2, {})
    # a copy, as a checkpoint gives: state_dict() holds the live buffers
    dst.load_state_dict(copy.deepcopy(src.state_dict()))
    group = opt2.param_groups[0]
    assert group["lr"] is lrs[0] and "capturable" not in group
    assert float(lrs[0]) == pytest.approx(opt.param_groups[0]["lr"],
                                          rel=1e-7)
    for m, o, s in ((model, opt, sch), (model2, opt2, sch2)):
        o.zero_grad(set_to_none=True)
        m(x).square().sum().backward()
        toptim.follow_schedule(o, s)
        o.step()
        s.step()
    for p, q in zip(model.parameters(), model2.parameters()):
        torch.testing.assert_close(q, p, atol=1e-6, rtol=1e-6)


def test_evaluation_builds_no_training_objects(workdir):
    """``exp=validation`` builds the model and its eval steps only (no
    optimizer, train step or train state) and writes nothing into the run
    directory but its ``evaluations/``; it scores the run's last model to
    the run's last test record."""
    run = os.path.join(workdir, "whole1")
    if not os.path.exists(os.path.join(run, "models", "last.pt")):
        main_gpu.build_experiment(_args(workdir, run)).main()
    before = {f: os.path.getmtime(os.path.join(d, f))
              for d, _, fs in os.walk(run) for f in fs}
    ev = main_gpu.build_experiment(["--device", "cpu", "exp=validation",
                                    f"logdir={run}", f"data_dir={workdir}",
                                    "use_last=true"])
    for name in ("training", "train_step", "train_multi_step", "state",
                 "tracker"):
        assert not hasattr(ev.exp, name), name
    res = ev.main()
    assert res["mAP"] == pytest.approx(_history(run, "test")[-1]["mAP"],
                                       abs=TOL)
    after = {f: os.path.getmtime(os.path.join(d, f))
             for d, _, fs in os.walk(run) for f in fs
             if "evaluations" not in d}
    assert after == before


def test_sgd_run_resumes_to_the_uninterrupted_run(workdir):
    """optim=sgd (momentum, weight decay) at three steps a dispatch: a run
    stopped after epoch 1 and resumed equals the uninterrupted run."""
    sgd = ("optim=sgd", "train_chunk=3")
    whole, first, resumed = (os.path.join(workdir, f"sgd_{n}")
                             for n in ("whole", "first", "resumed"))
    a = main_gpu.build_experiment(_args(workdir, whole, *sgd))
    assert type(a.training.optimizer).__name__ == "CapturableSGD"
    a.main()
    b = main_gpu.build_experiment(_args(workdir, first, *sgd))
    b.epochs = 1
    b.main()
    c = main_gpu.build_experiment(_args(workdir, resumed, *sgd,
                                        f"resume_logdir={first}"))
    c.main()
    sa, sc = a.model.state_dict(), c.model.state_dict()
    for k in sa:
        torch.testing.assert_close(sc[k], sa[k], atol=TOL, rtol=0, msg=k)
    _close(_strip(_history(resumed, "train")), _strip(_history(whole,
                                                              "train")))
