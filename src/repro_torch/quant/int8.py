"""Weight-only int8 quantization (paper Appendix D.2: "FastAttention is
orthogonal to ... quantization").

The port's copy of the JAX package's ``quant/int8.py``: per-output-channel
symmetric int8 for every floating leaf of two or more dimensions, the
scale taken over every axis but the last; other leaves stay as they are.

JAX quantizes its own parameter tree, whose layout depends on
``ParallelConfig.scan_layers``: under the default (True) each periodic
segment's layers are stacked along a leading axis, so a leaf's scale is
taken jointly over the segment's layers, and a leaf that is 1-D per layer
(a norm scale) is 2-D once stacked and is quantized -- when the segment
repeats more than once.  Under False every layer is its own leaf.  The
port keeps a list of per-layer trees, so ``quantize_tree`` takes the
config and the layout and gives each layer the slice of what JAX's gives
its stack: its own int8 values and the segment's shared scale (one
tensor, counted once by ``quantized_size_bytes``).  An encoder-decoder's
``enc_blocks`` and ``dec_blocks`` are stacks in JAX either way.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.convert import periodic_segments
from repro_torch.training import tree


class QuantizedTensor(NamedTuple):
    q: torch.Tensor            # int8
    scale: torch.Tensor        # f32, per output channel (last dim)


def _amax(w: torch.Tensor) -> torch.Tensor:
    """max |w| over every axis but the last, kept as size-1 axes."""
    a = w.float().abs()
    return a.amax(dim=tuple(range(w.ndim - 1)), keepdim=True) \
        if w.ndim > 1 else a


def _quantize(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(w.float() / scale), -127, 127).to(
        torch.int8)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax / 127.0, 1e-12)


def quantize_tensor(w: torch.Tensor) -> QuantizedTensor:
    scale = _scale(_amax(w))
    return QuantizedTensor(q=_quantize(w, scale), scale=scale)


def dequantize_tensor(qt: QuantizedTensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (qt.q.float() * qt.scale).to(dtype)


def _should_quantize(x, ndim: int) -> bool:
    return (isinstance(x, torch.Tensor) and ndim >= 2
            and x.is_floating_point())


def _quantize_stack(layers: List[dict]) -> List[dict]:
    """Each layer's tree quantized as JAX quantizes the stack of
    ``layers`` (one layer: no stack).  The stack's scale is the max of
    the layers' maxima, so no stack is built."""
    stacked = len(layers) > 1
    flat = [tree.leaves(layer) for layer in layers]
    out: List[list] = [[] for _ in layers]
    for ws in zip(*flat):
        if not _should_quantize(ws[0], ws[0].ndim + stacked):
            for o, w in zip(out, ws):
                o.append(w)
            continue
        amax = _amax(ws[0])
        for w in ws[1:]:
            amax = torch.maximum(amax, _amax(w))
        scale = _scale(amax)
        for o, w in zip(out, ws):
            o.append(QuantizedTensor(q=_quantize(w, scale), scale=scale))
    return [tree.unflatten(layer, o) for layer, o in zip(layers, out)]


def _quantize_leaves(t: Any) -> Any:
    """Each leaf of ``t`` quantized on its own (a leaf outside the
    layers' stacks)."""
    return tree.tree_map(
        lambda x: quantize_tensor(x) if _should_quantize(x, x.ndim) else x,
        t)


def quantize_tree(params: dict, cfg: ModelConfig, *,
                  scan_layers: bool = True) -> dict:
    """Quantize every matrix leaf of the port's parameter tree as the JAX
    package's ``quantize_tree`` quantizes its tree under
    ``ParallelConfig(scan_layers=scan_layers)``; returns a tree with
    QuantizedTensor leaves where quantized, original leaves elsewhere."""
    stacks = {"layers": [], "enc_blocks": [], "dec_blocks": []}
    if cfg.is_encoder_decoder:
        stacks["enc_blocks"] = [list(range(cfg.encoder_layers))]
        stacks["dec_blocks"] = [list(range(cfg.num_layers))]
    elif scan_layers:
        first = 0
        for unit, reps in periodic_segments(cfg):
            stacks["layers"] += [[first + r * len(unit) + i
                                  for r in range(reps)]
                                 for i in range(len(unit))]
            first += reps * len(unit)
    else:
        stacks["layers"] = [[i] for i in range(cfg.num_layers)]
    out = {}
    for key, value in params.items():
        if key not in stacks:
            out[key] = _quantize_leaves(value)
            continue
        layers = [None] * len(value)
        for idx in stacks[key]:
            for i, q in zip(idx, _quantize_stack([value[i] for i in idx])):
                layers[i] = q
        out[key] = layers
    return out


def _map_qt(fn, t):
    if isinstance(t, QuantizedTensor):
        return fn(t)
    if isinstance(t, dict):
        return {k: _map_qt(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_map_qt(fn, v) for v in t]
    return t


def dequantize_tree(qparams: Any,
                    dtype: torch.dtype = torch.bfloat16) -> Any:
    return _map_qt(lambda x: dequantize_tensor(x, dtype), qparams)


def quantized_size_bytes(qparams: Any) -> int:
    """Bytes of every leaf (int8 values, scales, unquantized leaves); a
    scale that several layers share is one tensor and counts once."""
    total, seen = 0, set()
    for leaf in tree.leaves(qparams):
        if id(leaf) in seen:
            continue
        seen.add(id(leaf))
        total += leaf.numel() * leaf.element_size()
    return total
