#!/usr/bin/env python3
"""CLI entry point of the PyTorch port (``concepthash_tpu_torch``): main.py's
argument grammar over the same configs/ directory, on an NVIDIA GPU.

    python3 main_gpu.py dataset=cub200 model=concepthash \\
        compute_dtype=bfloat16 data_dir=/data \\
        dataset.data_folder=cub200_2011 logdir=runs/cub
    python3 main_gpu.py --device cpu dataset=synthetic model=concepthash \\
        backbone=tiny_test model.nbit=16 epochs=2

Arguments: ``--config-name NAME`` (or ``-cn``, default train), ``group=choice``
and ``a.b=value`` overrides, ``+a.b=value`` to add a key, ``--help``.
``--device DEVICE`` (default cuda) picks the device; it stays out of the
composed config, so the run's config.yaml is the reference's.

exp modes: 'hashing' (train + retrieve), 'general' (train; the best run has
the lowest test loss), 'validation' / 'descriptor' / 'extract' (eval-only:
they take the val config and reload the run's saved config.yaml with the
eval keys laid over it; 'extract' writes the test codes only):

    python3 main_gpu.py exp=validation logdir=runs/cub use_last=true
    python3 main_gpu.py exp=extract logdir=runs/cub
    python3 main_gpu.py dataset=cub200 model=concepthash \\
        resume_logdir=runs/cub logdir=runs/cub_resumed

Data-parallel over W GPUs (or W CPU processes with ``--device cpu``, over
gloo): the same command under ``torchrun``, the same run with each global
batch split over the ranks; rank 0 writes the run directory:

    torchrun --standalone --nproc_per_node=W main_gpu.py dataset=cub200 \
        model=concepthash compute_dtype=bfloat16 logdir=runs/cub

``train_chunk`` (default auto: 8 on CUDA, 1 on the CPU) is the number of
train and eval steps per dispatch; ``backbone.name`` may name a local CLIP
checkpoint directory (or a model in the Hugging Face cache), whose weights
``pretrained: true`` loads and whose text tower and tokenizer the
codebook's text stage runs; nothing is downloaded.
"""

from __future__ import annotations

import os
import sys

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")
_EVAL_MODES = ("validation", "descriptor", "extract")
# what an eval-only command line lays over the run's saved config
_EVAL_KEYS = ("data_dir", "work_dir", "R", "PRs", "use_last", "compute_mAP",
              "ternary_threshold", "dist_metric", "batch_size", "save_code",
              "sub_code_eval", "sub_code_eval_setting", "zero_mean_eval",
              "test_as_database", "eval_logdir", "logdir", "seed")


def parse_argv(argv):
    """(config name, overrides, device) from the command line."""
    config_name, overrides, device = "train", [], None
    it = iter(argv)
    for arg in it:
        if arg in ("--config-name", "-cn"):
            config_name = next(it)
        elif arg.startswith("--config-name="):
            config_name = arg.split("=", 1)[1]
        elif arg == "--device":
            device = next(it)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        elif arg in ("--help", "-h"):
            from concepthash_tpu_torch.methods import list_methods

            print(__doc__)
            print("methods:", ", ".join(list_methods()))
            sys.exit(0)
        else:
            overrides.append(arg)
    return config_name, overrides, device


def build_experiment(argv=None):
    """The experiment the command line asks for, built and ready to run."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_name, overrides, device = parse_argv(argv)

    from concepthash_tpu_torch.config.loader import (load_config,
                                                     load_saved_config)

    # "exp=validation" with the train config means the val config
    exp_hint = next((o.split("=", 1)[1] for o in overrides
                     if o.startswith("exp=")), None)
    if exp_hint in _EVAL_MODES and config_name == "train":
        config_name = "val"
    config = load_config(CONFIG_DIR, config_name, overrides)
    exp_mode = config.get("exp", "hashing")

    saved_path = os.path.join(config.get("logdir") or "", "config.yaml")
    if exp_mode == "validation" or (
            exp_mode in _EVAL_MODES and "model" not in config
            and os.path.exists(saved_path)):
        # the run's saved config with the eval keys laid over it
        saved = load_saved_config(saved_path)
        for key in _EVAL_KEYS:
            if key in config:
                saved[key] = config[key]
        if config.get("dataset"):
            saved["dataset"] = config["dataset"]
        saved["exp"] = exp_mode
        config = saved

    from concepthash_tpu_torch.experiments.hashing import (
        GeneralExperiment, RetrievalEvaluation, RetrievalExperiment)

    if exp_mode == "general":
        return GeneralExperiment(config, device=device)
    if exp_mode == "hashing":
        return RetrievalExperiment(config, device=device)
    if exp_mode in _EVAL_MODES:
        return RetrievalEvaluation(config, device=device)
    raise ValueError(f'unknown exp mode: "{exp_mode}"')


def main(argv=None):
    from concepthash_tpu_torch.parallel.mesh import shutdown

    try:
        return build_experiment(argv).main()
    finally:
        shutdown()      # the group a launcher's environment started


if __name__ == "__main__":
    main()
