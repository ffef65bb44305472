"""Data parallelism of the PyTorch port on the CPU: a world of 3 gloo
processes (one spawn for the whole file) against the one-process port and
the JAX package's 8-device mesh. Held:

- ``ops/sharded.py``: ``make_sharded_topk`` at W=3, dense and streaming,
  plain and packed, ``exact`` true and false, over galleries padded by
  ``shard_gallery`` (masked by ``n_valid``) and 16-bit codes full of ties:
  every rank's distances and indices equal the one-process
  ``retrieve_topk``'s exactly, and (``exact=True``) the JAX package's
  ``make_sharded_topk`` on its mesh;
- the train steps: ``batch_size`` 4 shrinks the mesh to 2 ranks (rank 2
  idle); three steps of the flagship ``concepthash`` (``CodeBatchNorm``),
  ``concepthash`` with ``add_bn=dbn`` (``DecorrelatedBN``),
  ``dpsh_adapter`` (a pairwise loss), ``orthohash_adapter`` on
  ``resnet18`` (conv BatchNorm), ``hashnet_adapter`` (its bank), ``moco``
  (the teacher, in-batch negatives) and ``semicon_ce_adapter`` (batch
  standardisation), each with its config's dropout, under sgd (Adam turns
  the rounding noise of the flagship's null-gradient leaves into
  lr-sized updates, see test_torch_train_slice.py): the losses and every
  parameter and buffer within 1e-5 + 1e-5 |ref| of the one-process steps
  from the same state, on both ranks;
- the flagship's BatchNorm running statistics after one W=2 step equal
  the JAX mesh step's (as tests/test_train_step.py holds them);
- ``main_gpu.py``'s entry at W=2 (and the idle third rank): 2 epochs of
  the flagship under sgd on a synthetic set, in chunks of 2 steps with a
  padded eval tail: its records, mAP and ``models/last.pt`` within that
  tolerance of the one-process run's, the run directory written by rank 0
  alone; the same run stopped after epoch 1 and resumed on both ranks
  reaches the uninterrupted one's records and ``models/last.pt``.
"""

import json
import os
import socket
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent.parent
CONFIG_DIR = str(ROOT / "configs")
WORLD = 3
SPAWN_TIMEOUT_S = 240
RTOL = ATOL = 1e-5
STEPS = 3
BATCH = 4       # splits over 2 of the 3 ranks
NCLASS = 4

STEP_CASES = {
    "concepthash": ("model=concepthash", "model.text_projection_dims=[32]"),
    "concepthash_dbn": ("model=concepthash", "model.text_projection_dims=[32]",
                        "model.add_bn=dbn"),
    "dpsh_adapter": ("model=dpsh_adapter",),
    "orthohash_resnet18": ("model=orthohash_adapter", "backbone=resnet18",
                           "dataset.crop=32"),
    "hashnet_adapter": ("model=hashnet_adapter",
                        "+criterion.keep_train_size=1"),
    "moco": ("model=moco",),
    "semicon_ce_adapter": ("model=semicon_ce_adapter",),
}
STEP_COMMON = ("dataset=synthetic", "backbone=tiny_test", "model.nbit=16",
               "model.adapter_bottleneck_dim=16", "optim=sgd",
               f"batch_size={BATCH}", "seed=0", f"dataset.nclass={NCLASS}",
               "compute_dtype=float32")
TRAIN_SIZE = STEPS * BATCH

# (nbit, N, Q, k, layout, streaming_block, exact): dense takes +-1 float
# codes, plain and packed int8 signs (packed: pack_serving_gallery's rows)
TOPK_CASES = {
    "dense_exact_32": (32, 1000, 8, 10, "dense", 0, True),
    "dense_exact_16_ties": (16, 1000, 8, 10, "dense", 0, True),
    "dense_approx_16_ties": (16, 1000, 8, 10, "dense", 0, False),
    "plain_streaming_exact_32": (32, 1000, 8, 10, "plain", 64, True),
    "plain_streaming_approx_16": (16, 1000, 8, 10, "plain", 64, False),
    "packed_exact_32": (32, 1000, 8, 10, "packed", 0, True),
    "packed_exact_16_ties": (16, 1000, 8, 10, "packed", 0, True),
    "packed_approx_16": (16, 1000, 8, 10, "packed", 0, False),
}

# the BatchNorm check against the JAX mesh step: configs of
# tests/test_train_step.py's width, batch 8 (the JAX mesh's 8 devices)
BN_BATCH = 8
BN_CFG = {
    "model": {"name": "concepthash", "nbit": 16, "nclass": NCLASS,
              "ncontext": 4, "has_adapter": True,
              "adapter_bottleneck_dim": 8,
              "upt_config": {"multi": True, "num_heads": 4, "dropout": 0.0,
                             "ensemble_method": "concat",
                             "single_hash_fc": True, "hash_pe": True},
              "add_bn": True, "use_before_projection": True,
              "concept_reg": True, "text_projection_dims": [32]},
    "backbone": {"name": "tiny", "hidden_size": 32, "intermediate_size": 64,
                 "num_layers": 2, "num_heads": 4, "patch_size": 8,
                 "image_size": 16, "projection_dim": 32},
    "criterion": {"name": "lgh", "margin": 0.2, "scale": 8,
                  "loss_scales": {"logits": 0, "hash_logits": 0,
                                  "bin_logits": 1, "cont_logits": 1,
                                  "attn_div_loss": 0, "concept_logits": 1},
                  "avg_before_softmax": False, "lmbd": 0.5, "div_method": 1,
                  "ncontext": 4},
    "optim": {"name": "sgd", "lr": 0.01, "momentum": 0.9},
    "scheduler": {"name": "csw", "warmup_epochs": 1},
    "epochs": 4, "backbone_lr_scale": 0, "batch_size": BN_BATCH,
    "compute_dtype": "float32", "seed": 0, "dataset": {"nclass": NCLASS},
}


def run_args(workdir: str, logdir: str) -> list:
    """main_gpu.py's command line of the W=2 run and of its one-process
    twin: 12 train images (3 steps of 4, a chunk of 2 and one single
    step), 9 test images (two batches and a tail of 1); sgd, as the steps
    above take it."""
    return ["--device", "cpu", "dataset=synthetic", "model=concepthash",
            "backbone=tiny_test", "model.nbit=16",
            "model.text_projection_dims=[32]",
            "model.adapter_bottleneck_dim=16", f"batch_size={BATCH}",
            "optim=sgd", "epochs=2", "eval_interval=1", "train_chunk=2",
            f"data_dir={workdir}", f"logdir={logdir}", "seed=7"]


# ---------------------------------------------------------------- the world
def topk_inputs(name: str):
    nbit, N, Q, k, layout, block, exact = TOPK_CASES[name]
    rng = np.random.default_rng(sorted(TOPK_CASES).index(name))
    db = np.where(rng.standard_normal((N, nbit)) > 0, 1.0, -1.0).astype(
        np.float32)
    q = rng.standard_normal((Q, nbit)).astype(np.float32)
    return db, q


def _topk(mesh, results):
    from concepthash_tpu_torch.ops.retrieval import retrieve_topk
    from concepthash_tpu_torch.ops.sharded import (make_sharded_topk,
                                                   shard_gallery)
    from concepthash_tpu_torch.ops.topk_select import pack_serving_gallery

    for name, (nbit, N, Q, k, layout, block, exact) in TOPK_CASES.items():
        db, q = topk_inputs(name)
        gallery = torch.from_numpy(db)
        if layout == "plain":
            gallery = gallery.to(torch.int8)
        elif layout == "packed":
            gallery, _ = pack_serving_gallery(gallery)
        shard, _ = shard_gallery(gallery, mesh, streaming_block=block)
        fn = make_sharded_topk(mesh, k, exact=exact, streaming_block=block,
                               n_valid=N)
        d, idx = fn(torch.from_numpy(q), shard)
        ref = retrieve_topk(torch.from_numpy(q), torch.from_numpy(db), k=k,
                            exact=True)
        results[name] = {"d": d, "idx": idx, "ref_d": ref[0],
                         "ref_idx": ref[1], "shard_rows": shard.shape[0]}


def _compose(*over):
    from concepthash_tpu_torch.config.loader import load_config

    cfg = load_config(CONFIG_DIR, "train", list(STEP_COMMON) + list(over))
    cfg["_train_size_"] = TRAIN_SIZE
    return cfg


def _codebook(method, rng):
    if method.codebook == "continuous":
        return rng.standard_normal((NCLASS, 32)).astype(np.float32)
    if method.codebook == "signed":
        return np.where(rng.standard_normal((NCLASS, 16)) > 0, 1.0,
                        -1.0).astype(np.float32)
    return None


def _step_batches(crop: int, two_view: bool, seed: int) -> list:
    rng = np.random.default_rng(seed)
    rows = BATCH * (2 if two_view else 1)
    return [{"image": rng.standard_normal((rows, crop, crop, 3)).astype(
                 np.float32),
             "label": np.eye(NCLASS, dtype=np.float32)[
                 rng.integers(0, NCLASS, BATCH)],
             "index": np.arange(i * BATCH, (i + 1) * BATCH, dtype=np.int64)}
            for i in range(STEPS)]


def _local_batch(batch: dict, mesh, two_view: bool) -> dict:
    from concepthash_tpu_torch.parallel.mesh import shard_batch

    out = shard_batch({k: v for k, v in batch.items() if k != "image"}, mesh)
    x = batch["image"]
    if two_view:        # each view's block, stacked [v1; v2]
        out["image"] = np.concatenate(
            [shard_batch({"x": v}, mesh)["x"] for v in (x[:BATCH],
                                                          x[BATCH:])])
    else:
        out["image"] = shard_batch({"x": x}, mesh)["x"]
    return out


def _steps(mesh, results):
    from concepthash_tpu_torch import methods as M

    for name, over in STEP_CASES.items():
        cfg = _compose(*over)
        method = M.get_method(cfg["model"]["name"])
        cb = _codebook(method, np.random.default_rng(1))
        ref = M.build_training(cfg, cb, 2, device="cpu")
        dp = M.build_training(cfg, cb, 2, device="cpu", mesh=mesh)
        assert all(torch.equal(a, b) for a, b in zip(
            ref.model.state_dict().values(), dp.model.state_dict().values()))
        losses = []
        for b in _step_batches(int(cfg["dataset"]["crop"]), method.two_view,
                               2):
            want = ref.step({k: torch.from_numpy(v) for k, v in b.items()})
            got = dp.step({k: torch.from_numpy(v) for k, v in
                           _local_batch(b, mesh, method.two_view).items()})
            losses.append((float(got["loss"]), float(want["loss"])))
        state = {"losses": losses, "got": dp.model.state_dict(),
                 "want": ref.model.state_dict()}
        if "U" in dp.extra:
            state["got_bank"] = dp.extra["U"].clone()
            state["want_bank"] = ref.extra["U"].clone()
        results[name] = state


def _wait_for(path: str, timeout: float = 180.0) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def _bn_step(mesh, out_dir, results):
    from concepthash_tpu_torch import methods as M
    from concepthash_tpu_torch.parallel.mesh import shard_batch

    path = os.path.join(out_dir, "bn_inputs.pt")
    _wait_for(path)
    blob = torch.load(path)
    tr = M.build_training(BN_CFG, blob["centers"].numpy(), 2, device="cpu",
                          mesh=mesh)
    tr.model.load_state_dict(blob["state"])
    tr.step(shard_batch(blob["batch"], mesh))
    results["bn"] = {"mean": tr.model.hash_bn.running_mean.clone(),
                     "var": tr.model.hash_bn.running_var.clone()}


def _run(workdir, results):
    sys.path.insert(0, str(ROOT))
    import main_gpu

    exp = main_gpu.build_experiment(run_args(workdir,
                                             os.path.join(workdir, "dp")))
    results["run"] = {"idle": exp.idle, "writes": exp.writes,
                      "mesh_size": exp.mesh.size,
                      "best": exp.main()}
    # the same run stopped after epoch 1, then resumed on every rank
    first = os.path.join(workdir, "dp_first")
    exp = main_gpu.build_experiment(run_args(workdir, first) +
                                    ["save_training_state=true"])
    if not exp.idle:
        exp.epochs = 1
    exp.main()
    exp = main_gpu.build_experiment(
        run_args(workdir, os.path.join(workdir, "dp_resumed"))
        + ["save_training_state=true", f"resume_logdir={first}"])
    results["resumed_start"] = None if exp.idle else exp.start_epoch
    exp.main()


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
        _topk(make_mesh(), results)
        mesh2 = make_mesh(2)
        results["mesh2"] = (mesh2.rank, mesh2.size)
        if mesh2.member:
            _steps(mesh2, results)
            _bn_step(mesh2, workdir, results)
        _run(workdir, results)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))


# ------------------------------------------------------- the JAX side, here
def _jax_bn(workdir: str) -> dict:
    """The flagship's variables and a batch for the workers, then the JAX
    mesh step's BatchNorm running statistics."""
    import jax
    import jax.numpy as jnp

    from concepthash_tpu import methods as jmethods
    from concepthash_tpu.parallel.mesh import (make_mesh, replicate,
                                               shard_batch)
    from concepthash_tpu.train.optim import build_optimizer
    from concepthash_tpu.train.state import (create_train_state,
                                             make_train_step)
    from concepthash_tpu_torch.weights import from_flax

    rng = np.random.default_rng(3)
    centers = rng.standard_normal((NCLASS, 32)).astype(np.float32)
    jm = jmethods._build_concepthash(BN_CFG, centers)
    jloss = jmethods._lgh_build_loss(BN_CFG, centers)
    side = BN_CFG["backbone"]["image_size"]
    sample = jnp.zeros((BN_BATCH, side, side, 3))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=True))(
        {"params": key, "dropout": jax.random.fold_in(key, 1)}, sample)
    variables = jax.tree_util.tree_map(np.array, variables)
    y = rng.integers(0, NCLASS, BN_BATCH)
    batch = {"image": rng.standard_normal(
                 (BN_BATCH, side, side, 3)).astype(np.float32),
             "label": np.eye(NCLASS, dtype=np.float32)[y]}
    path = os.path.join(workdir, "bn_inputs.pt")
    torch.save({"state": from_flax(variables),
                "centers": torch.from_numpy(centers),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               path + ".tmp")
    os.replace(path + ".tmp", path)

    tx = build_optimizer(BN_CFG["optim"], BN_CFG["scheduler"],
                         BN_CFG["epochs"], 2, variables["params"], 0.0)
    state = create_train_state(jm, tx, sample, key, variables=variables)
    mesh = make_mesh()
    step = make_train_step(jm, jloss, tx, mesh=mesh)
    state, _ = step(replicate(state, mesh), shard_batch(batch, mesh))
    bn = state.batch_stats["hash_bn"]["bn"]
    return {"mean": np.asarray(bn["mean"]), "var": np.asarray(bn["var"])}


def _jax_topk() -> dict:
    """The JAX package's make_sharded_topk on its 8-device mesh, for the
    exact cases."""
    import jax.numpy as jnp

    from concepthash_tpu.ops.sharded import make_sharded_topk, shard_gallery
    from concepthash_tpu.ops.topk_select import pack_serving_gallery
    from concepthash_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    out = {}
    for name, (nbit, N, Q, k, layout, block, exact) in TOPK_CASES.items():
        if not exact:
            continue
        db, q = topk_inputs(name)
        gallery = db
        if layout == "plain":
            gallery = db.astype(np.int8)
        elif layout == "packed":
            gallery = np.asarray(pack_serving_gallery(db)[0])
        sharded, _ = shard_gallery(gallery, mesh, streaming_block=block)
        fn = make_sharded_topk(mesh, k=k, exact=True, streaming_block=block,
                               n_valid=N)
        d, idx = fn(jnp.asarray(q), sharded)
        out[name] = (np.asarray(d), np.asarray(idx))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the 3-rank world once and, meanwhile, the JAX side and the
    one-process CLI run; returns every rank's results."""
    from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset

    workdir = str(tmp_path_factory.mktemp("torch_distributed"))
    make_synthetic_dataset(os.path.join(workdir, "data", "synthetic"),
                           nclass=3, per_class_train=4, per_class_test=3,
                           image_size=64)
    ctx = mp.start_processes(_worker, args=(_free_port(), workdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.time() + SPAWN_TIMEOUT_S
    try:
        jax_bn = _jax_bn(workdir)
        jax_topk = _jax_topk()
        sys.path.insert(0, str(ROOT))
        import main_gpu

        main_gpu.main(run_args(workdir, os.path.join(workdir, "one")))
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
    return {"workdir": workdir, "ranks": ranks, "jax_bn": jax_bn,
            "jax_topk": jax_topk}


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_sharded_topk_equals_one_process(world, name):
    nbit, N, Q, k, layout, block, exact = TOPK_CASES[name]
    P = 128 // nbit if layout == "packed" else 1
    for r, res in enumerate(world["ranks"]):
        assert res[name]["shard_rows"] * P * WORLD > N     # pad rows
        got = res[name]
        assert torch.equal(got["d"], got["ref_d"]), (name, r)
        assert torch.equal(got["idx"], got["ref_idx"]), (name, r)


@pytest.mark.parametrize("name", sorted(n for n, c in TOPK_CASES.items()
                                        if c[-1]))
def test_sharded_topk_equals_jax(world, name):
    d, idx = world["jax_topk"][name]
    got = world["ranks"][0][name]
    np.testing.assert_array_equal(got["d"].numpy(), d)
    np.testing.assert_array_equal(got["idx"].numpy(), idx)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_steps_equal_one_process(world, name):
    r0, r1, r2 = world["ranks"]
    assert r0["mesh2"] == (0, 2) and r1["mesh2"] == (1, 2)
    assert r2["mesh2"] == (-1, 2) and name not in r2
    for res in (r0, r1):
        got = res[name]
        for i, (g, w) in enumerate(got["losses"]):
            assert abs(g - w) <= ATOL + RTOL * abs(w), (name, i, g, w)
        assert set(got["got"]) == set(got["want"])
        for k, w in got["want"].items():
            g = got["got"][k]
            if w.is_floating_point():
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} {k}")
            else:
                assert torch.equal(g, w), (name, k)
        if "want_bank" in got:
            np.testing.assert_allclose(got["got_bank"].numpy(),
                                       got["want_bank"].numpy(), rtol=RTOL,
                                       atol=ATOL)
    # the two replicas hold the same state
    for k, v in r0[name]["got"].items():
        assert torch.equal(v, r1[name]["got"][k]), (name, k)


def test_batchnorm_stats_equal_the_jax_mesh_step(world):
    want = world["jax_bn"]
    for res in world["ranks"][:2]:
        for key in ("mean", "var"):
            np.testing.assert_allclose(res["bn"][key].numpy(), want[key],
                                       rtol=1e-4, atol=1e-5, err_msg=key)


def _history(logdir: str, name: str) -> list:
    with open(os.path.join(logdir, f"{name}_history.json")) as f:
        return json.load(f)


def _close(got, want, where: str) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        if where.endswith(".time"):
            return
        assert abs(got - want) <= ATOL + RTOL * abs(want), (where, got, want)
    else:
        assert got == want, where


def test_main_gpu_run_equals_one_process(world):
    wd = world["workdir"]
    dp, one = os.path.join(wd, "dp"), os.path.join(wd, "one")
    for name in ("train", "test"):
        _close(_history(dp, name), _history(one, name), name)
    assert len(_history(dp, "test")) == 2
    best = [r["run"]["best"] for r in world["ranks"]]
    assert best[2] is None and best[0] == best[1]
    assert abs(best[0] - _history(one, "test")[-1]["mAP"]) <= 1e-5 + 1e-5
    got = torch.load(os.path.join(dp, "models", "last.pt"))
    want = torch.load(os.path.join(one, "models", "last.pt"))
    assert got["epoch"] == want["epoch"] == 1
    for k, w in want["model"].items():
        np.testing.assert_allclose(got["model"][k].numpy(), w.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_main_gpu_run_resumes_on_two_ranks(world):
    """A W=2 run stopped after epoch 1 and resumed on both ranks (its
    ``optims/last.pt`` loaded on every rank) reaches the uninterrupted W=2
    run's records and ``models/last.pt``."""
    wd = world["workdir"]
    whole, resumed = (os.path.join(wd, d) for d in ("dp", "dp_resumed"))
    assert [r["resumed_start"] for r in world["ranks"]] == [1, 1, None]
    for name in ("train", "test"):
        _close(_history(resumed, name), _history(whole, name), name)
    got = torch.load(os.path.join(resumed, "models", "last.pt"))["model"]
    want = torch.load(os.path.join(whole, "models", "last.pt"))["model"]
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_rank_zero_alone_writes_the_run(world):
    runs = [r["run"] for r in world["ranks"]]
    assert [r["idle"] for r in runs] == [False, False, True]
    assert [r["writes"] for r in runs] == [True, False, False]
    assert {r["mesh_size"] for r in runs} == {2}
    wd = world["workdir"]
    dp, one = os.path.join(wd, "dp"), os.path.join(wd, "one")

    def files(d):
        return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*")
                      if p.is_file())

    assert files(dp) == files(one)
    log = Path(dp, "log.txt").read_text()
    assert "using 2-device mesh" in log
    assert "idle" not in log
    # one process's log: each epoch's line once
    assert log.count("ep 0 train:") == 1 and log.count("ep 1 eval:") == 1
