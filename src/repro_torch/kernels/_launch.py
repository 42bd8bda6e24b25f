"""Checks shared by the kernel wrappers before a pointer reaches C."""
from __future__ import annotations

import ctypes

import torch

P = ctypes.c_void_p
I = ctypes.c_int


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain versions run);
    False when every one lies on one CUDA device (the kernel launches).
    Anything else raises."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"kernel inputs must share one device; got {sorted(map(str, devices))}")


def arg(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> int:
    """The data pointer of ``t`` after checking dtype, shape and
    contiguity (the kernels index flat row-major arrays)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def count_launch(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel, counted where it launches.
    A call under CUDA-graph capture records the kernel into the graph and
    launches nothing; the graph's replays count its kernel nodes instead
    (``capture.Captured``)."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_aligned(t: torch.Tensor, name: str) -> None:
    """The int16 histogram is incremented through its 32-bit words."""
    if t.data_ptr() % 4:
        raise ValueError(f"{name}: must be 4-byte aligned")
