"""Data parallelism of every other method on the CPU: a world of 2 gloo
processes (one spawn for the whole file) against the one-process port, as
tests/test_torch_distributed.py holds the flagship and six others. Held:

- three steps at W=2 of each remaining method from the same state as
  three one-process steps, under sgd: the losses and every parameter and
  buffer within 1e-5 + 1e-5 |ref|, on both ranks, and a method's extras
  (DINO's center, ODC's memory, TBH's discriminator) with them. Among them
  the two-view methods (cibhash, bihalf, nsh: each rank's block of each
  view, stacked ``[v1; v2]``), SSDH's structure block (``aux``, its rows
  gathered), DINO's and MoCo-like teachers, the MAE's mask (drawn at the
  global batch's shape), TBH's discriminator (reached after the gather,
  not summed over the ranks) and ODC's memory;
- ``main_gpu.py`` at W=2 against its one-process run, for the regimes'
  host work: ``adsh`` and ``semicon`` (the adsh regime: SGD on a subset,
  its encode, the discrete update of V), ``itq``, ``pca``, ``lsh`` and
  ``sh`` (the shallow regime's train-augmented extraction and fit),
  ``odc`` (its initial k-means over the train codes) and ``ssdh`` (its
  structure from the train codes): the records (and V, the fit) within
  that tolerance, written by rank 0 alone.
"""

import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_distributed import (ATOL, BATCH, RTOL, STEPS, _close,
                                    _codebook, _compose, _free_port,
                                    _history, _local_batch, _step_batches)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
SPAWN_TIMEOUT_S = 240

STEP_CASES = {
    "orthohash_bcs": ("model=orthohash_bcs_adapter",),
    "csq": ("model=csq_adapter",),
    "dpn": ("model=dpn_adapter",),
    "dtsh": ("model=dtsh_adapter",),
    "greedyhash": ("model=sgh_adapter",),
    # no config of its own: cibhash's groups, its loss at its defaults
    "unsup_greedyhash": ("model=cibhash", "model.name=unsup_greedyhash"),
    "ce": ("model=ce_adapter",),
    "descriptor": ("model=ce_adapter", "model.name=descriptor"),
    "a2net_ce": ("model=a2net_ce_adapter",),
    "clip": ("model=clip_finetune",),
    "cibhash": ("model=cibhash",),
    "bihalf": ("model=bihalf",),
    "nsh": ("model=nsh",),
    "ssdh": ("model=ssdh",),
    "dino": ("model=dino",),
    "mae": ("model=mae",),
    "autoencoder": ("model=autoencoder",),
    "tbh": ("model=tbh",),
    "odc": ("model=odc",),
}
RUN_CASES = {
    "adsh": ("model=adsh", "criterion.max_iters=1"),
    "semicon": ("model=semicon", "criterion.max_iters=1"),
    "itq": ("model=itq", "model.nbit=8"),
    "pca": ("model=pca", "model.nbit=8"),
    "lsh": ("model=lsh", "model.nbit=8"),
    "sh": ("model=sh", "model.nbit=8"),
    "odc": ("model=odc",),
    "ssdh": ("model=ssdh",),
}


def run_args(workdir: str, logdir: str, over) -> list:
    return ["--device", "cpu", "dataset=synthetic", "backbone=tiny_test",
            "model.nbit=16", "model.adapter_bottleneck_dim=16",
            f"batch_size={BATCH}", "optim=sgd", "epochs=1", "eval_interval=1",
            f"data_dir={workdir}", f"logdir={logdir}", "seed=7", *over]


def _seed_extras(name: str, trs, rng) -> None:
    """ODC's memory as the experiment's k-means would leave it: seeded
    and equal on both trainings."""
    if name != "odc":
        return
    ex = trs[0].extra
    vals = {"features": rng.standard_normal(tuple(ex["features"].shape)),
            "labels": rng.integers(0, ex["centroids"].shape[0],
                                   tuple(ex["labels"].shape)),
            "centroids": rng.standard_normal(tuple(ex["centroids"].shape)),
            "weights": rng.uniform(0.5, 1.5, tuple(ex["weights"].shape))}
    for tr in trs:
        for k, v in vals.items():
            tr.extra[k].copy_(torch.as_tensor(v))


def _extras(tr) -> dict:
    out = {}
    for k, v in tr.extra.items():
        if torch.is_tensor(v):
            out[k] = v.detach().clone()
        elif isinstance(v, torch.nn.Module):
            out.update({f"{k}.{n}": t.detach().clone()
                        for n, t in v.state_dict().items()})
    return out


def _steps(mesh, results):
    from concepthash_tpu_torch import methods as M

    for name, over in STEP_CASES.items():
        cfg = _compose(*over)
        if name == "unsup_greedyhash":
            cfg["criterion"] = {"name": name}
        method = M.get_method(cfg["model"]["name"])
        cb = _codebook(method, np.random.default_rng(1))
        ref = M.build_training(cfg, cb, 2, device="cpu")
        dp = M.build_training(cfg, cb, 2, device="cpu", mesh=mesh)
        _seed_extras(name, (ref, dp), np.random.default_rng(4))
        rng = np.random.default_rng(5)
        losses = []
        for b in _step_batches(int(cfg["dataset"]["crop"]), method.two_view,
                               2):
            if method.needs_structure:
                b["aux"] = rng.integers(-1, 2, (BATCH, BATCH)).astype(
                    np.int8)
            want = ref.step({k: torch.from_numpy(v) for k, v in b.items()})
            got = dp.step({k: torch.from_numpy(v) for k, v in
                           _local_batch(b, mesh, method.two_view).items()})
            losses.append((float(got["loss"]), float(want["loss"])))
        results[name] = {"losses": losses, "got": dp.model.state_dict(),
                         "want": ref.model.state_dict(),
                         "got_extra": _extras(dp), "want_extra": _extras(ref)}


def _runs(workdir, results):
    sys.path.insert(0, str(ROOT))
    import main_gpu

    for name, over in RUN_CASES.items():
        exp = main_gpu.build_experiment(run_args(
            workdir, os.path.join(workdir, f"dp_{name}"), over))
        results[f"run_{name}"] = {"writes": exp.writes,
                                  "mesh_size": exp.mesh.size,
                                  "best": exp.main()}


def _worker(rank: int, port: int, workdir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    import torch.distributed as dist

    from concepthash_tpu_torch.parallel.mesh import (init_distributed,
                                                     make_mesh)

    results = {}
    try:
        assert init_distributed("cpu")
        _steps(make_mesh(), results)
        _runs(workdir, results)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the 2-rank world once and, meanwhile, the one-process CLI
    runs; returns both ranks' results."""
    from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset

    workdir = str(tmp_path_factory.mktemp("torch_distributed_methods"))
    make_synthetic_dataset(os.path.join(workdir, "data", "synthetic"),
                           nclass=3, per_class_train=4, per_class_test=3,
                           image_size=64)
    ctx = mp.start_processes(_worker, args=(_free_port(), workdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.time() + SPAWN_TIMEOUT_S
    try:
        sys.path.insert(0, str(ROOT))
        import main_gpu

        for name, over in RUN_CASES.items():
            main_gpu.main(run_args(workdir, os.path.join(workdir,
                                                         f"one_{name}"),
                                   over))
        while not ctx.join(timeout=1):
            if time.time() > deadline:
                raise TimeoutError(f"the gloo world ran past "
                                   f"{SPAWN_TIMEOUT_S} s")
    except BaseException:
        errs = [Path(workdir, f"rank{r}.err") for r in range(WORLD)]
        msg = "".join(p.read_text() for p in errs if p.exists())
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        pytest.fail(f"the gloo world failed:\n{msg}", pytrace=True)
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"))
             for r in range(WORLD)]
    return {"workdir": workdir, "ranks": ranks}


def _assert_tensors_close(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if w.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{where} {k}")
        else:
            assert torch.equal(g, w), (where, k)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_steps_equal_one_process(world, name):
    r0, r1 = world["ranks"]
    for res in (r0, r1):
        got = res[name]
        assert len(got["losses"]) == STEPS
        for i, (g, w) in enumerate(got["losses"]):
            assert abs(g - w) <= ATOL + RTOL * abs(w), (name, i, g, w)
        _assert_tensors_close(got["got"], got["want"], name)
        _assert_tensors_close(got["got_extra"], got["want_extra"],
                              f"{name} extras")
    for k, v in r0[name]["got"].items():
        assert torch.equal(v, r1[name]["got"][k]), (name, k)


@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_regime_run_equals_one_process(world, name):
    wd = world["workdir"]
    dp, one = (os.path.join(wd, f"{p}_{name}") for p in ("dp", "one"))
    runs = [r[f"run_{name}"] for r in world["ranks"]]
    assert [r["writes"] for r in runs] == [True, False]
    assert {r["mesh_size"] for r in runs} == {WORLD}
    assert runs[0]["best"] == runs[1]["best"]
    for hist in ("train", "test"):
        path = os.path.join(one, f"{hist}_history.json")
        if os.path.exists(path):
            _close(_history(dp, hist), _history(one, hist), hist)
    assert sorted(p.name for p in Path(dp).rglob("*") if p.is_file()) == \
        sorted(p.name for p in Path(one).rglob("*") if p.is_file())
    for rel in ("outputs/db_codes.pt", "models/best.pt"):
        path = os.path.join(one, rel)
        if not os.path.exists(path):
            continue
        got = torch.load(os.path.join(dp, rel), weights_only=False)
        want = torch.load(path, weights_only=False)
        _close_blob(got, want, rel)


def _close_blob(got, want, where: str) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close_blob(got[k], want[k], f"{where}.{k}")
    elif torch.is_tensor(want) or isinstance(want, np.ndarray):
        g, w = np.asarray(got), np.asarray(want)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(g, w, err_msg=where)
    else:
        assert got == want, where
