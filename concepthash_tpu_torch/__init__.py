"""PyTorch and CUDA port of concepthash_tpu for an NVIDIA H100.

The JAX package ``concepthash_tpu`` is the reference; this package imports
nothing of it, nor of JAX. Its entry points run on the card unless the caller
asks for another device, and raise when CUDA is asked for and absent. Every
TPU kernel on the ported path is a CUDA kernel written by hand (``csrc/``),
built by ``_build`` at first use; beside each one, in the same module, is a
plain PyTorch version that the CPU runs and that the card is checked against.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises when CUDA is asked for and not available — there is no
    quiet fall-back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU")
    return dev
