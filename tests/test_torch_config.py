"""The port's config composition against the JAX package's on the repo's own
configs/ directory: the composed dicts are equal (``logdir`` given, so no
``${now}`` timestamp differs), and a saved config loads back equal."""

import os
from pathlib import Path

import pytest

from concepthash_tpu.config import loader as jloader
from concepthash_tpu_torch.config import loader as tloader

CONFIGS = str(Path(__file__).resolve().parent.parent / "configs")

CASES = [
    ("train", ["dataset=cub200", "model=concepthash", "compute_dtype=bfloat16",
               "data_dir=/data", "dataset.data_folder=cub", "epochs=2",
               "eval_interval=1", "logdir=/runs/a"]),
    ("train", ["dataset=synthetic", "model=concepthash", "backbone=tiny_test",
               "model.nbit=16", "model.text_projection_dims=[32]",
               "optim=sgd", "logdir=/runs/b"]),
    ("train", ["model=concepthash", "+new.key=7", "+extra=[1, 2]",
               "scheduler=step", "transforms=simple", "logdir=/runs/c",
               "tag=t_"]),
    ("val", ["dataset=cub200", "logdir=/runs/d", "eval_logdir=/runs/d/e",
             "R=[1,5]"]),
]


@pytest.mark.parametrize("name,overrides", CASES)
def test_load_config_equals_reference(name, overrides):
    want = jloader.load_config(CONFIGS, name, overrides)
    got = tloader.load_config(CONFIGS, name, overrides)
    assert got == want
    assert got["_choices_"] == want["_choices_"]


def test_flagship_compose():
    cfg = tloader.load_config(CONFIGS, "train", CASES[0][1])
    assert cfg["model"]["nclass"] == 200 and cfg["batch_size"] == 32
    assert cfg["backbone"]["name"] == "openai/clip-vit-base-patch32"
    assert cfg["model"]["fixed_center"]["class_name_path"] == \
        "/data/cub/class_names.txt"
    assert cfg["dataset"]["norm"] == 3 and cfg["optim"]["lr"] == 0.001
    assert cfg["transforms_name"] == "trivialaugment"


def test_unresolved_logdir_has_a_timestamp():
    cfg = tloader.load_config(CONFIGS, "train", ["model=concepthash"])
    assert cfg["logdir"].startswith("./logs/cub200/concepthash64_100/42_")


def test_save_and_load_saved_config_round_trip(tmp_path):
    cfg = tloader.load_config(CONFIGS, "train", CASES[1][1])
    path = str(tmp_path / "run" / "config.yaml")
    tloader.save_config(cfg, path)
    back = tloader.load_saved_config(path)
    assert back == {k: v for k, v in cfg.items() if not k.startswith("_")}
    assert back == jloader.load_saved_config(path)
    jpath = str(tmp_path / "ref" / "config.yaml")
    jloader.save_config(cfg, jpath)
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    assert os.path.getsize(path) > 0


def test_bad_override_raises():
    with pytest.raises(ValueError, match="key=value"):
        tloader.load_config(CONFIGS, "train", ["model"])
    with pytest.raises(FileNotFoundError):
        tloader.load_config(CONFIGS, "train", ["model=nope"])
