"""The port's experiment loop and CLI (``main_gpu.py``) against the JAX
package's on the CPU, on a 3-class synthetic set with the ``tiny_test``
backbone, 16 bits, batch 8, float32:

(a) the reference trains two epochs; the port, given its
    ``models/last.msgpack`` as ``finetune_path``, evaluates to the same test
    and database codes (within 1e-4) and the same mAP, recalls and
    precisions (within 1e-6);
(b) ``main_gpu.py --device cpu`` trains two epochs and writes the
    reference's run directory with ``.pt`` files; its history records carry
    the reference's keys and its ``lr`` values equal the reference's;
(c) without ``--device`` and without CUDA it raises;
(d) ``models/last.pt`` reloads to the same codes, bit for bit;
(e) ``profile`` writes its trace and ``debug.nans`` raises
    ``FloatingPointError`` on a NaN in both packages, and each option this
    round ported (FILIP,
    DecorrelatedBN, vpt_pe, ``backbone.remat``, lars; the orthohash, csq,
    hashnet with its bank and clip baselines; the A2-Net-CE and SEMICON-CE
    heads; the C++ decode and the image cache; the unsupervised cibhash,
    bihalf, nsh and ssdh; tbh, and odc with its k-means and NMI) trains an
    epoch and evaluates, the adsh regime (adsh, semicon) runs an epoch to
    its database codes, the shallow regime (itq, pca, lsh, sh) fits and
    scores, the pretraining configs (moco, dino, mae, autoencoder) train
    an epoch under ``exp=general``, and a moco run resumes to the
    uninterrupted run bit for bit; the non-CLIP backbones (resnet18 with
    its frozen BatchNorm, a Swin, vgg16, a2net_ce on resnet18's grid,
    tbh on alexnet) and ``debug.disable_jit`` train an epoch too;
(f) the eval-only modes: ``exp=validation`` and ``exp=extract`` on the
    reference's run directory (its ``last.msgpack``) against the reference's
    own eval-only runs (codes in sign on >= 99.9% of bits, mAP within 1e-3),
    and on the port's run a list ``R``, sub-code eval with the test split as
    database, and the PR curve.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from concepthash_tpu.config import loader as jloader
from concepthash_tpu.data.synthetic import make_synthetic_dataset
from concepthash_tpu.experiments.hashing import (RetrievalExperiment as
                                                 JExperiment)
from concepthash_tpu_torch.train.optim import current_lr

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import main_gpu  # noqa: E402

CODES_ATOL = 1e-4
SCORE_ATOL = 1e-6


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


@pytest.fixture(scope="module")
def reference(workdir):
    """The JAX package's run, built once: the experiment after main()."""
    logdir = os.path.join(workdir, "ref")
    cfg = jloader.load_config(str(ROOT / "configs"), "train",
                              _args(workdir, logdir))
    exp = JExperiment(cfg)
    exp.main()
    return exp, logdir


@pytest.fixture(scope="module")
def port_run(workdir):
    """The port's run through main_gpu on the CPU: the experiment after
    main(), and its logdir."""
    logdir = os.path.join(workdir, "port")
    exp = main_gpu.build_experiment(["--device", "cpu",
                                     *_args(workdir, logdir)])
    best = exp.main()
    assert best is not None and 0.0 <= best <= 1.0
    return exp, logdir


def _history(logdir, name):
    with open(os.path.join(logdir, f"{name}_history.json")) as f:
        return json.load(f)


def test_port_evaluates_the_reference_weights_alike(reference, workdir):
    jexp, ref_logdir = reference
    want, (jtc, jtl, jdc, jdl) = jexp.evaluation(1)
    logdir = os.path.join(workdir, "finetuned")
    exp = main_gpu.build_experiment([
        "--device", "cpu", *_args(workdir, logdir),
        f"finetune_path={ref_logdir}/models/last.msgpack"])
    got, (tc, tl, dc, dl) = exp.evaluation(1)
    np.testing.assert_array_equal(tl, jtl)
    np.testing.assert_array_equal(dl, jdl)
    for codes, jcodes in ((tc, jtc), (dc, jdc)):
        assert codes["codes"].shape == jcodes["codes"].shape
        np.testing.assert_allclose(codes["codes"].numpy(), jcodes["codes"],
                                   atol=CODES_ATOL, rtol=0)
    assert set(got) == set(want)
    for key in ("mAP", "recalls", "precisions"):
        np.testing.assert_allclose(got[key], want[key], atol=SCORE_ATOL,
                                   rtol=0, err_msg=key)
    # a run directory loads as well as its checkpoint file
    exp.finetune_init(ref_logdir)


def test_main_gpu_writes_the_reference_run_directory(port_run, reference):
    _, logdir = port_run
    _, ref_logdir = reference
    for f in ("config.yaml", "log.txt", "train_history.json",
              "test_history.json", "events.jsonl", "models/best.pt",
              "models/last.pt", "outputs/test_best.pt", "outputs/db_best.pt"):
        assert os.path.exists(os.path.join(logdir, f)), f
    for name in ("train", "test"):
        got, want = _history(logdir, name), _history(ref_logdir, name)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w), name
    train = _history(logdir, "train")
    assert [r["lr"] for r in train] == \
        [r["lr"] for r in _history(ref_logdir, "train")]
    for r in train:
        assert np.isfinite(r["loss"])
    for r in _history(logdir, "test"):
        assert 0.0 <= r["mAP"] <= 1.0 and len(r["recalls"]) == 3
    with open(os.path.join(logdir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert any("train/loss" in e for e in events)
    assert any("test/mAP" in e for e in events)
    with open(os.path.join(logdir, "log.txt")) as f:
        assert "offline fallback" in f.read()


def test_main_gpu_config_is_the_references(port_run, reference):
    """--device stays out of config.yaml: the two saved configs differ only
    in their logdir."""
    from concepthash_tpu_torch.config.loader import load_saved_config

    got = load_saved_config(os.path.join(port_run[1], "config.yaml"))
    want = load_saved_config(os.path.join(reference[1], "config.yaml"))
    assert {k: v for k, v in got.items() if k != "logdir"} == \
        {k: v for k, v in want.items() if k != "logdir"}


def test_current_lr_matches_reference():
    """Within an ulp of float32 (XLA's float32 cosine is not always the
    correctly rounded one); the warm-up and step laws exactly."""
    from concepthash_tpu.train.optim import current_lr as jlr

    for sched in ({"name": "csw", "warmup_epochs": 10},
                  {"name": "csw", "warmup_epochs": 1},
                  {"name": "step", "step_size": 3, "gamma": 0.5},
                  {"name": "milestones", "milestones": [2, 5], "gamma": 0.3},
                  {"name": "no_decay"}):
        for step in range(0, 400, 9):
            args = ({"lr": 1e-3}, sched, 30, 12, step)
            want, got = jlr(*args), current_lr(*args)
            if sched["name"] == "csw" and step // 12 >= \
                    sched["warmup_epochs"]:
                assert got == pytest.approx(want, rel=2.5e-7, abs=0)
            else:
                assert got == want, (sched, step)


def test_cuda_is_the_default(monkeypatch, workdir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    logdir = os.path.join(workdir, "no_cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        main_gpu.main(_args(workdir, logdir))
    assert not os.path.exists(logdir)


def test_last_checkpoint_reloads_to_the_same_codes(port_run, workdir):
    exp, logdir = port_run
    codes = exp.encode_split("test")[0]["codes"]
    fresh = main_gpu.build_experiment([
        "--device", "cpu", *_args(workdir, os.path.join(workdir, "reload")),
        f"finetune_path={logdir}/models/last.pt"])
    assert torch.equal(fresh.encode_split("test")[0]["codes"], codes)
    fresh.load_model_state(os.path.join(logdir, "models", "last.pt"))
    assert torch.equal(fresh.encode_split("test")[0]["codes"], codes)
    best = torch.load(os.path.join(logdir, "outputs", "test_best.pt"))
    assert best["codes"].shape == codes.shape


@pytest.mark.parametrize("extra", [
    ["+profile.enabled=true"], ["+debug.nans=true"],
])
def test_unported_options_raise(workdir, extra):
    """The two diagnostics the port once refused, now working (the test's
    name kept): ``profile`` writes a Chrome trace of the chosen train
    dispatches (here step 1 of 3 an epoch) and keeps every dispatch's host
    time; ``debug.nans`` on an orthohash run fed a NaN (``criterion.s=.nan``:
    the loss's logits scaled by NaN) raises ``FloatingPointError`` in both
    packages."""
    logdir = os.path.join(workdir, "diag_" + extra[0][1:6])
    if extra[0].startswith("+profile"):
        exp = main_gpu.build_experiment(
            ["--device", "cpu", *_args(workdir, logdir), "epochs=1", *extra,
             "profile.start_step=1", "profile.num_steps=1"])
        exp.main()
        trace = os.path.join(logdir, "profile", "steps_1-1.json")
        assert exp.profiler.trace_path == trace
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any(n.startswith("aten::") for n in names)
        assert len(exp.profiler.step_times) == exp.steps_per_epoch == 3
        with open(os.path.join(logdir, "log.txt")) as f:
            assert "profiler trace stopped at step 2" in f.read()
        return
    import jax

    args = [*_args(workdir, logdir), "epochs=1", "model=orthohash_adapter",
            "criterion.s=.nan", *extra]
    with pytest.raises(FloatingPointError, match="debug.nans"):
        main_gpu.main(["--device", "cpu", *args])
    cfg = jloader.load_config(str(ROOT / "configs"), "train",
                              [*args, f"logdir={logdir}_jax"])
    try:
        with pytest.raises(FloatingPointError):
            JExperiment(cfg).main()
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("extra", [
    ["model=concepthash_filip"], ["+backbone.remat=true"],
    ["optim.name=lars"], ["model.add_bn=dbn"], ["model.vpt_pe=true"],
    ["model=orthohash_adapter"], ["model=csq_adapter"],
    ["model=hashnet_adapter", "+criterion.keep_train_size=1",
     "save_training_state=true"],
    ["model=clip_finetune"], ["model=a2net_ce_adapter"],
    ["model=semicon_ce_adapter"], ["native_decode=true"],
    ["cache_images=true"], ["model=cibhash"], ["model=bihalf"],
    ["model=nsh"], ["model=ssdh"], ["model=tbh"], ["model=odc"],
    ["model=orthohash_adapter", "backbone=resnet18"],
    ["model=csq_adapter", "backbone=swin_tiny", "backbone.variant=test",
     "backbone.window_size=4", "dataset.crop=32"],
    ["model=dpsh_adapter", "backbone=vgg16"],
    ["model=a2net_ce_adapter", "backbone=resnet18"],
    ["model=tbh", "backbone=alexnet", "dataset.crop=64"],
    ["+debug.disable_jit=true"],
])
def test_ported_options_run(workdir, extra):
    """One epoch of main_gpu with the option: a finite train record, a test
    record, and the option in the checkpoint (FILIP's pseudo-token
    embeddings, offline, at the backbone's projection width, 8 a class;
    the DBN's statistics; vpt_pe's prompts; orthohash's fixed centroids as
    a buffer; csq's Hadamard codebook in its accuracy meter; HashNet's bank
    of the 24 train images in the train state; clip's logit_scale;
    A2-Net's tied f32 hash layer; SEMICON-CE's maps' LayerNorm over the 36
    patches; the C++ decode taking every image; the image cache; the
    unsupervised objectives' parts, NSH's projector and SSDH's structure,
    logged; TBH's actor and critic parts and its 16 codes a bit; ODC's
    k-means logged and the NMI of both splits in its test record)."""
    logdir = os.path.join(workdir, "ported_" + "".join(
        c if c.isalnum() else "_" for c in "_".join(extra)))
    best = main_gpu.main(["--device", "cpu", *_args(workdir, logdir),
                          "epochs=1", *extra])
    assert best is not None and 0.0 <= best <= 1.0
    train, test = _history(logdir, "train"), _history(logdir, "test")
    assert len(train) == len(test) == 1 and np.isfinite(train[0]["loss"])
    sd = torch.load(os.path.join(logdir, "models", "last.pt"))["model"]
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    if extra == ["model=concepthash_filip"]:
        assert tuple(sd["token_embeds"].shape) == (3, 8, 32)
        assert "pseudo-tokens" in log and "filip" in train[0]
    if extra == ["model.add_bn=dbn"]:
        assert tuple(sd["hash_bn.whiten"].shape) == (4, 4, 4)
        assert "hash_bn.running_var" not in sd
    if extra == ["model.vpt_pe=true"]:
        assert tuple(sd["backbone.vpt_pe.1"].shape) == (1, 4, 64)
    if extra == ["model=orthohash_adapter"]:
        cent = sd["ce_fc.centroids"]
        assert tuple(cent.shape) == (3, 16) and set(cent.unique().tolist()) \
            <= {-1.0, 1.0}
        assert "hacc" in train[0] and "hash_bn.running_var" in sd
    if extra == ["model=csq_adapter"]:
        assert "hacc" in train[0] and "ce_fc.centroids" not in sd
    if extra[0] == "model=hashnet_adapter":
        assert train[0]["beta"] == 1.0
        bank = torch.load(os.path.join(logdir, "optims", "last.pt"))["extra"]
        assert tuple(bank["U"].shape) == (24, 16)
        assert tuple(bank["Y"].shape) == (24, 3)
        # 3 steps of 8 cover the 24 train images: every row written
        assert (bank["Y"].sum(1) == 1).all() and bank["U"].abs().min() > 0
    if extra == ["model=clip_finetune"]:
        assert float(sd["logit_scale"]) != 0.0 and "acc" in train[0]
        assert "codebook stage failed" in log
    if extra == ["model=a2net_ce_adapter"]:
        assert sd["hash_w"].dtype == torch.float32
        assert tuple(sd["hash_w"].shape) == (5 * 64, 16)
        assert {"hash", "decorr", "rec", "acc"} <= set(train[0])
    if extra == ["model=semicon_ce_adapter"]:
        assert tuple(sd["sem_norm.0.weight"].shape) == (36,)
        assert {"hash", "quan", "acc"} <= set(train[0])
    parts = {"model=cibhash": {"contrastive", "kl"},
             "model=bihalf": {"mse", "quan"},
             "model=nsh": {"sort", "contrastive", "quan"},
             "model=ssdh": {"pairwise"}}.get(extra[0])
    if parts is not None:
        assert parts <= set(train[0]) and "acc" not in train[0]
    if extra == ["model=nsh"]:
        assert tuple(sd["latent_fc1.weight"].shape) == (256, 64)
        assert "hash_fc.bias" not in sd
    if extra == ["model=ssdh"]:
        assert "ssdh structure: " in log
    if extra == ["model=tbh"]:
        assert {"rec", "adv", "disc"} <= set(train[0])
        assert tuple(sd["enc_b.weight"].shape) == (16, 256)
    if extra == ["model=odc"]:
        assert "odc: initial k-means into 3 clusters" in log
        assert 0.0 <= test[0]["test_nmi"] <= 1.0
        assert 0.0 <= test[0]["db_nmi"] <= 1.0
        assert "test NMI" in log and "acc" in train[0]
    if extra == ["native_decode=true"]:
        from concepthash_tpu_torch import native

        assert native.available() and native.counts["native"] > 0
        assert "C++ decoder" not in log      # no fallback was logged


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


def test_self_attn_at_last_needs_a_mapping(workdir):
    """A bare ``self_attn_at_last: true`` (the reference fails on it with an
    AttributeError) raises a ValueError that asks for a mapping."""
    logdir = os.path.join(workdir, "sa_bool")
    with pytest.raises(ValueError, match="mapping"):
        main_gpu.main(["--device", "cpu", *_args(workdir, logdir),
                       "+model.self_attn_at_last=true"])


def test_help(capsys):
    with pytest.raises(SystemExit) as e:
        main_gpu.main(["--help"])
    assert e.value.code == 0
    assert "methods: concepthash" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the eval-only modes (exp=validation / extract), against the reference's
# ---------------------------------------------------------------------------

MIN_SIGN_AGREEMENT = 0.999
MAP_ATOL = 1e-3


def _eval_args(workdir, logdir, eval_dir, *extra):
    return ["--device", "cpu", f"logdir={logdir}", f"data_dir={workdir}",
            f"eval_logdir={eval_dir}", *extra]


@pytest.fixture(scope="module")
def reference_evals(reference, workdir):
    """JAX ``main.py exp=validation`` and ``exp=extract`` on the
    reference's run directory (its last checkpoint)."""
    import main as jmain
    from concepthash_tpu.utils.io import load_checkpoint

    _, ref_logdir = reference
    val = jmain.main(["exp=validation", f"logdir={ref_logdir}",
                      f"data_dir={workdir}", "use_last=true",
                      f"eval_logdir={os.path.join(workdir, 'jval')}"])
    ext_dir = os.path.join(workdir, "jext")
    jmain.main(["exp=extract", f"logdir={ref_logdir}", f"data_dir={workdir}",
                "use_last=true", f"eval_logdir={ext_dir}"])
    codes = load_checkpoint(os.path.join(ext_dir, "outputs.msgpack"))[
        "test"]["codes"]
    return val, np.asarray(codes)


def test_eval_only_modes_on_the_reference_run(reference, reference_evals,
                                              workdir):
    """The port's exp=validation and exp=extract read the reference's
    last.msgpack: codes agree in sign on >= 99.9% of bits with JAX
    exp=extract's, the mAP within 1e-3 of JAX exp=validation's."""
    _, ref_logdir = reference
    val, jcodes = reference_evals
    vdir = os.path.join(workdir, "tval")
    res = main_gpu.build_experiment(_eval_args(
        workdir, ref_logdir, vdir, "exp=validation", "use_last=true")).main()
    assert abs(res["mAP"] - val["mAP"]) <= MAP_ATOL, (res["mAP"],
                                                      val["mAP"])
    with open(os.path.join(vdir, "history.json")) as f:
        assert json.load(f)["mAP"] == pytest.approx(res["mAP"])
    edir = os.path.join(workdir, "text")
    ex = main_gpu.build_experiment(_eval_args(
        workdir, ref_logdir, edir, "exp=extract", "use_last=true"))
    ex.main()
    assert not os.path.exists(os.path.join(edir, "history.json"))
    codes = torch.load(os.path.join(edir, "outputs.pt"))["test"]["codes"]
    assert codes.shape == jcodes.shape
    agree = ((codes.numpy() > 0) == (jcodes > 0)).mean()
    assert agree >= MIN_SIGN_AGREEMENT, agree


def test_validation_list_R(port_run, workdir):
    _, logdir = port_run
    vdir = os.path.join(workdir, "tval_R")
    res = main_gpu.build_experiment(_eval_args(
        workdir, logdir, vdir, "exp=validation", "R=[1,5]")).main()
    assert isinstance(res["mAP"], list) and len(res["mAP"]) == 2
    assert all(0.0 <= m <= 1.0 for m in res["mAP"])
    with open(os.path.join(vdir, "history.json")) as f:
        assert len(json.load(f)["mAP"]) == 2


def test_validation_sub_code_and_self_retrieval(port_run, workdir):
    """Bits 0-8 of the test codes, the test split as its own database with
    each query's first hit dropped: calculate_mAP's answer on those codes."""
    from concepthash_tpu_torch.ops.retrieval import calculate_mAP

    exp, logdir = port_run
    res = main_gpu.build_experiment(_eval_args(
        workdir, logdir, os.path.join(workdir, "tval_sub"),
        "exp=validation", "sub_code_eval=true",
        "sub_code_eval_setting.start_bit=0",
        "sub_code_eval_setting.end_bit=8", "test_as_database=true")).main()
    codes, labels, _ = exp.encode_split("test")
    best = torch.load(os.path.join(logdir, "outputs", "test_best.pt"))
    sub = best["codes"][:, :8]
    want, _, _ = calculate_mAP(sub, labels, sub, labels, R=-1,
                               remove_first_retrieved=True, device="cpu")
    assert res["mAP"] == pytest.approx(want, abs=1e-9)
    assert codes["codes"].shape[1] == 16


def test_validation_pr_curve(port_run, workdir):
    _, logdir = port_run
    res = main_gpu.build_experiment(_eval_args(
        workdir, logdir, os.path.join(workdir, "tval_pr"), "exp=validation",
        "compute_mAP=false")).main()
    assert "mAP" not in res
    assert len(res["recalls"]) == len(res["precisions"]) == len(res["Rs"])
