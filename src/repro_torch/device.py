"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means ``"cuda"``.  Without a
GPU they raise instead of falling back to the CPU quietly; the CPU runs
only when the caller asks for it (as the tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """A config dtype name ("bfloat16", "float32") as a torch dtype."""
    return DTYPES[name]
