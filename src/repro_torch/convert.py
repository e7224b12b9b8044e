"""Bridge from the JAX package's parameter pytree to the port's parameters.

``params_from_jax`` takes the pytree of the JAX package's ``LM.init``,
already converted to numpy arrays by the caller (the port never imports
JAX), and returns the port's parameter dict.  The JAX model scans over
repeating units: ``seg{i}`` holds a unit ``{"u0": ..., "u1": ...}`` whose
leaves carry a leading repeat axis when the unit repeats more than once.
Layer ``rep * len(unit) + i`` of the port is unit member ``u{i}`` at
repeat ``rep``.  ``periodic_segments`` below copies the JAX package's rule
for finding the unit (``models/lm.py``), so both sides agree on it.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device


def _segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    segs: List[Tuple[str, int]] = []
    for kind in cfg.blocks():
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


def periodic_segments(cfg: ModelConfig
                      ) -> List[Tuple[Tuple[str, ...], int]]:
    """[(unit_kinds, repeats)]: the JAX model's scan segments."""
    blocks = cfg.blocks()
    n = len(blocks)
    for p in (1, 2, 3, 4):
        if n % p == 0:
            unit = blocks[:p]
            if all(blocks[i] == unit[i % p] for i in range(n)):
                return [(tuple(unit), n // p)]
    return [((k,), c) for k, c in _segments(cfg)]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: no numpy/torch bridge
        bits = a.view(np.uint16).astype(np.int32) << 16
        return torch.from_numpy(bits).view(torch.float32).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None, *,
                    scan_layers: bool = True) -> dict:
    """The port's parameters from a numpy copy of a JAX ``LM.init`` tree.

    ``scan_layers`` must match the JAX model's
    ``ParallelConfig.scan_layers`` (the default, True, stacks repeating
    units).
    """
    dev = resolve_device(device)
    segs = (periodic_segments(cfg) if scan_layers
            else [((k,), 1) for k in cfg.blocks()])
    layers = []
    for si, (unit, reps) in enumerate(segs):
        seg = tree[f"seg{si}"]
        for rep in range(reps):
            for i in range(len(unit)):
                layers.append(_map(seg[f"u{i}"], lambda a: _tensor(
                    a[rep] if reps > 1 else a, dev)))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.num_layers}")
    return {"embedding": _map(tree["embedding"], lambda a: _tensor(a, dev)),
            "final_norm": _map(tree["final_norm"],
                               lambda a: _tensor(a, dev)),
            "layers": layers}
