"""The port's data-parallel helpers against the JAX package's, with no
process group (``parallel/mesh.py``, the loader's process shards, the
experiment's mesh shrink), and the coverage of the gloo worlds:

- ``pad_to_multiple`` equal to the reference's;
- ``shard_batch`` / ``shard_batch_chunk`` at W=8: rank r's block equal to
  the shard the reference places on device r of its 8-device mesh;
- the shrink rule (``mesh_size_for``) equal to the mesh the reference's
  experiment builds (``_load_data``) for batch and device counts;
- ``Loader(process_index=, process_count=4)`` equal to the reference's
  ``Loader``, batch by batch, ``drop_last`` on and off, shuffled;
- every registered method is held on two ranks by one of the gloo
  worlds (tests/test_torch_distributed*.py).
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from concepthash_tpu.data import pipeline as jpipeline
from concepthash_tpu.data.manifest import HashingDataset as JDataset
from concepthash_tpu.experiments import hashing as jhashing
from concepthash_tpu.parallel import mesh as jmesh
from concepthash_tpu_torch import methods as tmethods
from concepthash_tpu_torch.data.manifest import HashingDataset
from concepthash_tpu_torch.data.pipeline import Loader
from concepthash_tpu_torch.data.synthetic import make_synthetic_dataset
from concepthash_tpu_torch.parallel.mesh import (Mesh, mesh_size_for,
                                                 pad_to_multiple, shard_batch,
                                                 shard_batch_chunk)

W = 8


def fake_mesh(rank: int, size: int = W) -> Mesh:
    return Mesh(None, rank, size, torch.device("cpu"))


def host_batch(rng, n: int, lead=()) -> dict:
    return {"image": rng.integers(0, 256, (*lead, n, 6, 6, 3),
                                  dtype=np.uint8),
            "label": np.eye(5, dtype=np.float32)[
                rng.integers(0, 5, (*lead, n))],
            "index": rng.integers(0, 99, (*lead, n)).astype(np.int32)}


@pytest.mark.parametrize("n,multiple", [(8, 8), (13, 8), (5, 3), (1, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    batch = host_batch(np.random.default_rng(n), n)
    got, n_got = pad_to_multiple(batch, multiple)
    want, n_want = jmesh.pad_to_multiple(batch, multiple)
    assert n_got == n_want == n
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _device_blocks(placed: dict, mesh) -> list:
    """Each device's shard of every array, in the mesh's device order."""
    out = []
    for dev in mesh.devices.flat:
        out.append({k: np.asarray(next(s.data for s in v.addressable_shards
                                        if s.device == dev))
                    for k, v in placed.items()})
    return out


def test_shard_batch_matches_jax_placement():
    batch = host_batch(np.random.default_rng(0), 16)
    mesh = jmesh.make_mesh()
    want = _device_blocks(jmesh.shard_batch(batch, mesh), mesh)
    for r in range(W):
        got = shard_batch(batch, fake_mesh(r))
        for k in batch:
            np.testing.assert_array_equal(got[k], want[r][k], err_msg=k)


def test_shard_batch_chunk_matches_jax_placement():
    batches = host_batch(np.random.default_rng(1), 16, lead=(3,))
    mesh = jmesh.make_mesh()
    want = _device_blocks(jmesh.shard_batch_chunk(batches, mesh), mesh)
    for r in range(W):
        got = shard_batch_chunk(batches, fake_mesh(r))
        for k in batches:
            np.testing.assert_array_equal(got[k], want[r][k], err_msg=k)


def test_shard_batch_rejects_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(host_batch(np.random.default_rng(2), 12), fake_mesh(0))


@pytest.fixture(scope="module")
def ds_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel") / "data" / "synthetic"
    make_synthetic_dataset(str(root), nclass=3, per_class_train=7,
                           per_class_test=2, image_size=24)
    return str(root)


@pytest.mark.parametrize("batch_size,ndev", [(32, 8), (4, 3), (6, 4),
                                             (7, 8), (12, 8), (1, 2)])
def test_mesh_shrink_matches_the_reference_experiment(ds_root, monkeypatch,
                                                      batch_size, ndev):
    devices = jax.devices()[:ndev]
    monkeypatch.setattr(jhashing, "make_mesh", lambda n=None: jmesh.make_mesh(
        n, devices=devices))
    cfg = {"dataset": {"data_folder": os.path.basename(ds_root), "nclass": 3},
           "data_dir": os.path.dirname(ds_root), "batch_size": batch_size}
    exp = types.SimpleNamespace(config=cfg)
    jhashing.RetrievalExperiment._load_data(exp)
    assert mesh_size_for(batch_size, ndev) == exp.mesh.devices.size


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_process_shards_match_jax(ds_root, drop_last):
    """4 processes' shards of the train split (21 rows: the train shards
    truncate to 5, the eval ones pad to 6 with sentinels), shuffled, two
    epochs, batch by batch against the reference's loader."""
    pc, bs = 4, 4
    for pi in range(pc):
        got = Loader(HashingDataset(ds_root, "train.txt", 3), bs, resize=24,
                     shuffle=True, drop_last=drop_last, seed=5,
                     process_index=pi, process_count=pc)
        want = jpipeline.Loader(JDataset(ds_root, "train.txt", 3), bs,
                                resize=24, shuffle=True, drop_last=drop_last,
                                seed=5, process_index=pi, process_count=pc)
        assert len(got) == len(want) > 0
        for _ in range(2):
            pairs = list(zip(got, want, strict=True))
            assert pairs
            for g, w in pairs:
                assert g["n_valid"] == w["n_valid"]
                for k in ("image", "label", "index"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        got.close()


def test_loader_all_sentinel_batch_matches_jax(ds_root):
    """More processes than rows at the tail: a process's last eval batch
    holds only sentinels and comes out as the reference's empty batch."""
    ds = HashingDataset(ds_root, "test.txt", 3)
    pc = len(ds) + 2
    got = list(Loader(ds, 1, resize=24, process_index=pc - 1,
                      process_count=pc))
    want = list(jpipeline.Loader(JDataset(ds_root, "test.txt", 3), 1,
                                 resize=24, process_index=pc - 1,
                                 process_count=pc))
    assert len(got) == len(want) == 1 and got[0]["n_valid"] == 0
    for k in ("image", "label", "index"):
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)


def test_every_method_is_held_on_several_ranks():
    """Each method the port registers has its steps or its run held at
    W=2 against one process (tests/test_torch_distributed.py and
    tests/test_torch_distributed_methods.py)."""
    import test_torch_distributed as d1
    import test_torch_distributed_methods as d2

    held = {d1._compose(*over)["model"]["name"]
            for over in (*d1.STEP_CASES.values(), *d2.STEP_CASES.values())}
    held |= {d1._compose(*over)["model"]["name"]
             for over in d2.RUN_CASES.values()}
    assert held == set(tmethods.list_methods())


def test_init_distributed_needs_the_whole_environment(monkeypatch):
    """Without a launcher's environment nothing starts; with WORLD_SIZE
    but no RANK it raises rather than run on one process."""
    import torch.distributed as dist

    from concepthash_tpu_torch.parallel.mesh import init_distributed

    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed("cpu") is False and not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(KeyError, match="RANK"):
        init_distributed("cpu")
    assert not dist.is_initialized()
