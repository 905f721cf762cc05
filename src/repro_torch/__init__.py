"""PyTorch/CUDA port of the runnable model stack, beside the JAX package.

Same sub-package and module names as ``repro`` so a reader finds the
counterpart of each file; PyTorch's idiom inside. The package imports ``torch``
and never ``jax`` or ``repro``. Its kernels are CUDA C++ for Hopper, built at
first use (see ``repro_torch.kernels``). Entry points run on the GPU unless
the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the GPU.

    With no request and no GPU this raises: an entry point never drops to the
    CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless device='cpu' "
            "is requested explicitly")
    return torch.device("cuda")
