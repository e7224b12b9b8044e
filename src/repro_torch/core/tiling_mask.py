"""The paper's tiling-mask strategy (§4.1, T2), in numpy/PyTorch.

A causal (or banded) mask block depends only on ``delta = q_start -
kv_start``, so the JAX kernel reads the *B-mask* of any ``bq x bk`` score
block as a shifted slice of one (2M) x (2M) lower-triangular *M-mask*
(``make_m_mask``).  Blocks are classified SKIP (all masked: no load, no
math), FULL (all visible: no mask work) or PARTIAL (mask applied).
``csrc/fastattn_fwd.cu`` classifies its sub-tiles with exactly
``classify_block``'s rule and walks the macro-block range of
``MaskSpec.block_limits``; on Hopper it masks PARTIAL sub-tiles by
arithmetic compares instead of reading the M-mask (see its header), so
the slices are not ported.  These host-side rules are what the tests
hold the kernel's loop bounds and sub-tile classes to.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

# Block classifications.
SKIP, PARTIAL, FULL = 0, 1, 2


@functools.lru_cache(maxsize=8)
def _m_mask_np(m: int) -> np.ndarray:
    u = np.arange(2 * m)
    return (u[:, None] >= u[None, :]).astype(np.int8)


def make_m_mask(m: int, dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """The (2M, 2M) lower-triangular M-mask (paper Fig. 3)."""
    return torch.from_numpy(_m_mask_np(m)).to(dtype)


def classify_block(q_start: int, kv_start: int, bq: int, bk: int, *,
                   causal: bool = True, window: Optional[int] = None,
                   kv_len: Optional[int] = None) -> int:
    """Classify a (bq, bk) score block as SKIP / PARTIAL / FULL.

    ``kv_len`` optionally marks KV padding (positions >= kv_len are
    masked).  Python ints only: the CUDA kernel evaluates the same rule on
    the device.
    """
    q_end = q_start + bq - 1
    kv_end = kv_start + bk - 1
    skip, full = False, True
    if causal:
        delta = q_start - kv_start
        skip = skip or delta <= -bq
        full = full and delta >= bk - 1
    if window is not None:
        # visible requires k > q - w; fully masked if kv_end <= q_start - w
        skip = skip or kv_end <= q_start - window
        full = full and kv_start >= q_end - window + 1
    if kv_len is not None:
        skip = skip or kv_start >= kv_len
        full = full and kv_end < kv_len
    return SKIP if skip else (FULL if full else PARTIAL)


class MaskSpec(NamedTuple):
    """Static description of the mask pattern for a kernel launch."""
    causal: bool = True
    window: Optional[int] = None     # sliding window width (includes self)
    q_offset: int = 0                # global position of q row 0

    def block_limits(self, n_q_blocks: int, n_kv_blocks: int,
                     bq: int, bk: int, kv_len: int):
        """Per-q-block [first, last] valid kv-block indices (numpy)."""
        first = np.zeros(n_q_blocks, np.int64)
        last = np.full(n_q_blocks, n_kv_blocks - 1, np.int64)
        for qi in range(n_q_blocks):
            q0 = self.q_offset + qi * bq
            qe = q0 + bq - 1
            if self.causal:
                last[qi] = min(last[qi], qe // bk)
            if self.window is not None:
                first[qi] = max(first[qi], (q0 - self.window + 1) // bk)
            last[qi] = min(last[qi], max((kv_len - 1) // bk, 0))
            first[qi] = max(min(first[qi], last[qi]), 0)
        return first, last


def mask_memory_bytes(seq_len: int, dtype_bytes: int = 2) -> int:
    """Memory of a dense S x S mask (the paper's 8 GB at 64K example)."""
    return seq_len * seq_len * dtype_bytes


def m_mask_memory_bytes(m: int, dtype_bytes: int = 1) -> int:
    return (2 * m) * (2 * m) * dtype_bytes


def dense_mask(seq_q: int, seq_k: int, *, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Reference dense (seq_q, seq_k) bool mask (oracle for the tests)."""
    q = torch.arange(seq_q, device=device)[:, None] + q_offset
    k = torch.arange(seq_k, device=device)[None, :]
    m = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    if causal:
        m = m & (q >= k)
    if window is not None:
        m = m & (q - k < window)
    return m
