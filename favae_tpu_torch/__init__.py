"""favae_tpu_torch: the PyTorch/CUDA port of favae_tpu for NVIDIA Hopper.

The JAX package `favae_tpu` stays the reference; this package imports nothing
of it (and no JAX). Public functions take NHWC tensors like the JAX package;
inside, activations are NCHW tensors in `torch.channels_last` memory format.
Every TPU kernel on a ported path is a hand-written Hopper kernel
(`csrc/*.cu` through `_build.py`, or Triton), with a plain PyTorch version
beside it that CPU tensors take.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or implied) and absent, so a
    missing card never turns into a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
