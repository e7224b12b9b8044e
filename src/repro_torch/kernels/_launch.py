"""Shared checks and argument plumbing of the kernel wrappers."""
from __future__ import annotations

import ctypes
import itertools
from typing import Optional

import torch

# kernel dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# impl names of the ops with a gradient (``fastattn``, ``mlstm_chunkwise``):
# "kernel" (the JAX package's name for its kernel, "pallas", is accepted
# too) and "reference" (plain PyTorch); None or "auto" = the kernel for
# CUDA tensors, the plain version for CPU tensors.
IMPLS = ("kernel", "reference")
# head dims the attention kernels are built for (csrc dispatch_d); a CUDA
# tensor with any other raises, it never falls back to the plain version
HEAD_DIMS = (64, 80, 96, 128, 256)

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def resolve_impl(impl: Optional[str], x: torch.Tensor, what: str) -> str:
    """``impl`` as one of IMPLS, for an op named ``what`` on ``x``."""
    if impl in (None, "auto"):
        return "kernel" if x.is_cuda else "reference"
    if impl == "pallas":
        return "kernel"
    if impl not in IMPLS:
        raise ValueError(f"unknown {what} impl {impl!r}")
    return impl


def check_tensors(name: str, floats: dict, ints: dict) -> int:
    """Raise ValueError unless every tensor is a contiguous CUDA tensor on
    one device, the float ones of one kernel dtype, the int ones int32.
    Returns the dtype code."""
    dev = next(iter(floats.values())).device
    dtype = next(iter(floats.values())).dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    on_cuda = dev.type == "cuda"
    for arg, t in itertools.chain(floats.items(), ints.items()):
        if not on_cuda or t.device != dev:
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


def check_strided(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Raise ValueError unless ``t`` is on ``like``'s CUDA device with its
    dtype, a contiguous last dimension, and a base address and strides
    that keep every row 16-byte aligned (the kernels load 16 bytes a
    thread).  Its other dimensions may be strided."""
    if t.device != like.device:
        raise ValueError(f"{name}: must be on {like.device}, got {t.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {like.dtype}")
    if t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous")
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
        raise ValueError(f"{name}: rows must be 16-byte aligned "
                         f"(strides {t.stride()})")


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{status}")


def opt_int(x: Optional[int]) -> int:
    return int(x) if x else 0


def opt_float(x: Optional[float]) -> float:
    return float(x) if x else 0.0


def stream_ptr(device: torch.device) -> int:
    """The raw cudaStream_t of ``device``'s current stream: the binding
    PyTorch's own generated kernels call.  ``torch.cuda.current_stream(
    device).cuda_stream`` builds a Stream object first, ~7 us a call on
    the H100's host, 32 times a decode step."""
    return torch._C._cuda_getCurrentRawStream(device.index)
