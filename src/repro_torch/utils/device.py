"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. With no CUDA device and no explicit choice this
    raises; it never drops quietly to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions of "
                "the kernels on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
