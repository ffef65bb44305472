"""Startup banner: the host, the software and the card (counterpart of
concepthash_tpu/utils/machine_stats.py)."""

from __future__ import annotations

import logging
import os
import platform

import torch


def print_stats(device: torch.device):
    logging.info("host: %s (%s)", platform.node(), platform.platform())
    logging.info("python: %s", platform.python_version())
    logging.info("torch: %s, CUDA %s", torch.__version__, torch.version.cuda)
    if device.type == "cuda":
        i = device.index if device.index is not None else 0
        props = torch.cuda.get_device_properties(i)
        logging.info("device: %s (cuda:%d of %d), %.1f GiB, %d SMs",
                     props.name, i, torch.cuda.device_count(),
                     props.total_memory / 2 ** 30, props.multi_processor_count)
    else:
        logging.info("device: %s", device)
    logging.info("cpu count: %s", os.cpu_count())
