"""Two-level tiling planner for Hopper (paper §4.1, re-derived for the H100).

The paper sizes its first-level block from the Ascend L1 buffer and its
second-level block from L0; the JAX package sized them from TPU VMEM
(64 MiB).  On the H100 a CTA has at most 227 KB of shared memory
(232,448 bytes, of the SM's 228 KB), so the sizes of ``csrc/fastattn_fwd.cu``
are derived here from that:

* level 2, ``block_kv2`` = 32 keys: the register tile of the kernel's
  128 threads (16 x 8 threads, each 4 query rows x 4 keys), and
  ``block_q`` = 64 query rows per CTA, both fixed by that layout;
* level 1, ``block_kv1``: the macro-block of keys one CTA stages in shared
  memory per barrier, K transposed and V in the input dtype beside the
  CTA's float32 Q tile.  It grows in powers of two while two CTAs still
  fit on one SM (latency hiding); where even one sub-tile does not allow
  that (head_dim 256 in float32) the whole 227 KB of one CTA is the
  budget.  Larger level-1 blocks mean fewer barriers per key -- the
  synchronisations the paper's level-1 enlargement removes.
"""
from __future__ import annotations

from dataclasses import dataclass

SMEM_PER_BLOCK = 232_448      # the most dynamic shared memory one CTA may use
SMEM_PER_SM = 233_472         # 228 KB per SM
SMEM_RESERVED = 1_024         # per resident CTA, kept by the runtime
BLOCK_Q = 64                  # query rows per CTA (16 thread rows x 4)
BLOCK_KV2 = 32                # keys per sub-tile (8 thread columns x 4)
PAD = 4                       # row padding of the transposed tiles
MAX_BLOCK_KV1 = 32 * BLOCK_KV2  # the kernel's sub-tile bit masks hold 32


@dataclass(frozen=True)
class TilingPlan:
    block_q: int
    block_kv1: int          # level 1: keys staged per barrier
    block_kv2: int          # level 2: keys per register sub-tile
    smem_bytes: int         # dynamic shared memory of one CTA

    @property
    def n_sub(self) -> int:
        return self.block_kv1 // self.block_kv2

    @property
    def ctas_per_sm(self) -> int:
        return SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED)


def smem_working_set(block_q: int, block_kv1: int, head_dim: int,
                     dtype_bytes: int = 2) -> int:
    """Dynamic shared memory of one fastattn_fwd CTA, exactly as the kernel
    lays it out: the float32 Q tile transposed, the K macro-block
    transposed and the V macro-block, both in the input dtype."""
    q = 4 * head_dim * (block_q + PAD)
    k = dtype_bytes * head_dim * (block_kv1 + PAD)
    v = dtype_bytes * block_kv1 * head_dim
    return q + k + v


def plan_two_level_tiling(seq_q: int, seq_kv: int, head_dim: int, *,
                          dtype_bytes: int = 2) -> TilingPlan:
    """Choose (block_q, block_kv1, block_kv2) for a problem shape
    (``seq_q`` is unused: block_q is fixed by the thread layout)."""
    def smem(kv1: int) -> int:
        return smem_working_set(BLOCK_Q, kv1, head_dim, dtype_bytes)

    two_ctas = SMEM_PER_SM // 2 - SMEM_RESERVED
    budget = two_ctas if smem(BLOCK_KV2) <= two_ctas else SMEM_PER_BLOCK
    if smem(BLOCK_KV2) > budget:
        raise ValueError(f"head_dim {head_dim} x {dtype_bytes}-byte inputs "
                         f"need {smem(BLOCK_KV2)} B of shared memory, over "
                         f"the budget of {budget} B")
    block_kv1 = BLOCK_KV2
    while (block_kv1 * 2 <= MAX_BLOCK_KV1
           and block_kv1 * 2 <= _round_up(seq_kv, BLOCK_KV2)
           and smem(block_kv1 * 2) <= budget):
        block_kv1 *= 2
    return TilingPlan(block_q=BLOCK_Q, block_kv1=block_kv1,
                      block_kv2=BLOCK_KV2, smem_bytes=smem(block_kv1))


def sync_count(seq_kv: int, block: int) -> int:
    """Number of staging barriers for one KV pass -- the quantity the
    paper's level-1 enlargement minimises."""
    return (seq_kv + block - 1) // block


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m
