"""Shared checks and argument plumbing of the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kernel dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def check_tensors(name: str, floats: dict, ints: dict) -> int:
    """Raise ValueError unless every tensor is a contiguous CUDA tensor on
    one device, the float ones of one kernel dtype, the int ones int32.
    Returns the dtype code."""
    dev = next(iter(floats.values())).device
    dtype = next(iter(floats.values())).dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    for arg, t in {**floats, **ints}.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: {arg} must be on {dev} (CUDA), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in floats.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
    for arg, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {t.dtype}")
    return DTYPE_CODES[dtype]


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{status}")


def opt_int(x: Optional[int]) -> int:
    return int(x) if x else 0


def opt_float(x: Optional[float]) -> float:
    return float(x) if x else 0.0


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
