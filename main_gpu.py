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

exp modes: 'hashing' (train + retrieve) runs; 'general', 'validation',
'descriptor' and 'extract' are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import os
import sys

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


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

    from concepthash_tpu_torch.config.loader import load_config

    config = load_config(CONFIG_DIR, config_name, overrides)
    exp_mode = config.get("exp", "hashing")
    if exp_mode in ("general", "validation", "descriptor", "extract"):
        raise NotImplementedError(
            f"exp={exp_mode} (GeneralExperiment / RetrievalEvaluation) is not "
            "ported yet (ROADMAP Queue 1 item 4)")
    if exp_mode != "hashing":
        raise ValueError(f'unknown exp mode: "{exp_mode}"')

    from concepthash_tpu_torch.experiments.hashing import RetrievalExperiment

    return RetrievalExperiment(config, device=device)


def main(argv=None):
    return build_experiment(argv).main()


if __name__ == "__main__":
    main()
