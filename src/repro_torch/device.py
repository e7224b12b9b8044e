"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means ``"cuda"``.  Without a
GPU they raise instead of falling back to the CPU quietly; the CPU runs
only when the caller asks for it (as the tests do).  A model on the meta
device holds shapes and dtypes only (the dry run, ``launch/dryrun.py``).
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


def check_generator(gen: Optional[torch.Generator],
                    device: torch.device) -> None:
    """An init's generator must be on the model's device type; an init
    with none (``gen=None``: every leaf empty, nothing drawn) runs on the
    meta device only."""
    if gen is None:
        if device.type != "meta":
            raise ValueError(f"a model on {device} needs a generator to "
                             "draw its parameters (only the meta device "
                             "takes none)")
    elif gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, model on {device}")


def torch_dtype(name: str) -> torch.dtype:
    """A config dtype name ("bfloat16", "float32") as a torch dtype."""
    return DTYPES[name]


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU), so a
    host clock read after it measures the work and not its enqueueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
