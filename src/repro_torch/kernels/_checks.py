"""Argument checks shared by the CUDA kernels' wrappers."""
from __future__ import annotations


def check(name, t, dtype, shape):
    """``t`` has this dtype and shape and is contiguous, or raise."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_cuda(*tensors):
    """The tensors lie on one CUDA device, or raise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
