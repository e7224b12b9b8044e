"""Two-level tiling planner for Hopper (paper §4.1, re-derived for the H100).

The paper sizes its first-level block from the Ascend L1 buffer and its
second-level block from L0; the JAX package sized them from TPU VMEM
(64 MiB).  On the H100 a CTA has at most 227 KB of shared memory
(232,448 bytes, of the SM's 228 KB), and the plan describes the kernel
that an input dtype actually launches in ``csrc/fastattn_fwd.cu``:

* 2-byte inputs (bfloat16): the tensor-core kernel of ``attn_sm90.cuh``.
  Level 2, ``block_kv2`` = 64 keys, is the width N of one ``wgmma``
  m64n64k16 sub-tile; ``block_q`` is 64 rows per consumer warpgroup, two
  warpgroups (128 rows) for head_dim <= 128 and one (64) for head_dim
  256, whose f32 accumulator alone is 128 registers a thread.  Its tiles
  hold ``padded_head_dim`` columns a row (whole 64-column blocks of the
  128-byte swizzle: 128 for head dims 80 and 96, zero-filled past D).  Level 1,
  ``block_kv1``, is one stage of the K/V ring (``stages`` = 3 slots: the
  next stage loads while one is computed and the previous one's last P V
  may still run; one mbarrier wait a stage): the largest power of two
  from 64 whose three slots, beside the bf16 Q tile, the slots'
  mbarriers and 1 KB of alignment slack (the 128-byte swizzle's atom),
  fit the 227 KB of one CTA.  Registers hold the kernel to one CTA an SM
  anyway.
* 4-byte inputs (float32): the FP32 FMA kernel.  ``block_kv2`` = 32 keys
  and ``block_q`` = 64 rows, fixed by its 16 x 8 thread register tile;
  ``block_kv1`` is the macro-block staged per barrier (K transposed and V
  beside the float32 Q tile, single-buffered), grown in powers of two
  while two CTAs still fit on one SM (latency hiding); where even one
  sub-tile does not allow that (head_dim 256) the whole 227 KB of one CTA
  is the budget.

Larger level-1 blocks mean fewer barriers per key -- the synchronisations
the paper's level-1 enlargement removes.
"""
from __future__ import annotations

from dataclasses import dataclass
SMEM_PER_BLOCK = 232_448      # the most dynamic shared memory one CTA may use
SMEM_PER_SM = 233_472         # 228 KB per SM
SMEM_RESERVED = 1_024         # per resident CTA, kept by the runtime
# float32: the FMA kernel
FMA_BLOCK_Q = 64              # query rows per CTA (16 thread rows x 4)
FMA_BLOCK_KV2 = 32            # keys per sub-tile (8 thread columns x 4)
PAD = 4                       # row padding of the transposed tiles
FMA_MAX_BLOCK_KV1 = 32 * FMA_BLOCK_KV2   # its sub-tile bit masks hold 32
# bfloat16: the wgmma kernel
WG_ROWS = 64                  # query rows per consumer warpgroup
BLOCK_KV2 = 64                # keys per wgmma sub-tile (N of m64n64k16)
STAGES = 3                    # K/V slots in the cp.async ring
SMEM_ALIGN = 1_024            # slack to align the tiles to the swizzle atom
MBARRIER_BYTES = 8            # one mbarrier: a full and an empty a slot


@dataclass(frozen=True)
class TilingPlan:
    block_q: int
    block_kv1: int          # level 1: keys staged per barrier
    block_kv2: int          # level 2: keys per register / wgmma sub-tile
    smem_bytes: int         # dynamic shared memory of one CTA
    stages: int = 1         # level-1 blocks resident at once (the ring)

    @property
    def n_sub(self) -> int:
        return self.block_kv1 // self.block_kv2

    @property
    def ctas_per_sm(self) -> int:
        return SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED)


def padded_head_dim(head_dim: int) -> int:
    """Columns a row of the bf16 kernel's shared-memory tiles: head_dim
    rounded up to whole 64-column (128-byte) swizzle blocks."""
    return _round_up(head_dim, 64)


def block_q_for(head_dim: int, dtype_bytes: int) -> int:
    """Query rows per CTA of the kernel that ``dtype_bytes`` inputs
    launch."""
    if dtype_bytes == 4:
        return FMA_BLOCK_Q
    return 2 * WG_ROWS if padded_head_dim(head_dim) <= 128 else WG_ROWS


def smem_working_set(block_q: int, block_kv1: int, head_dim: int,
                     dtype_bytes: int = 2) -> int:
    """Dynamic shared memory of one fastattn_fwd CTA, exactly as the
    kernel lays it out.  2-byte inputs: alignment slack, the bf16 Q tile,
    the ring's STAGES slots of K and V (rows ``padded_head_dim`` columns
    wide), and their mbarriers.  4-byte inputs: the float32 Q tile
    transposed, the K macro-block transposed and the V macro-block (one
    stage)."""
    if dtype_bytes == 4:
        q = 4 * head_dim * (block_q + PAD)
        k = 4 * head_dim * (block_kv1 + PAD)
        v = 4 * block_kv1 * head_dim
        return q + k + v
    dp = padded_head_dim(head_dim)
    return (SMEM_ALIGN + dtype_bytes * block_q * dp
            + STAGES * 2 * dtype_bytes * block_kv1 * dp
            + STAGES * 2 * MBARRIER_BYTES)


def plan_two_level_tiling(seq_q: int, seq_kv: int, head_dim: int, *,
                          dtype_bytes: int = 2) -> TilingPlan:
    """Choose (block_q, block_kv1, block_kv2, stages) for a problem shape
    and input width (``seq_q`` is unused: block_q is fixed by the
    kernel's thread layout)."""
    block_q = block_q_for(head_dim, dtype_bytes)
    if dtype_bytes == 4:
        kv2, stages, max_kv1 = FMA_BLOCK_KV2, 1, FMA_MAX_BLOCK_KV1
    else:
        kv2, stages, max_kv1 = BLOCK_KV2, STAGES, None

    def smem(kv1: int) -> int:
        return smem_working_set(block_q, kv1, head_dim, dtype_bytes)

    two_ctas = SMEM_PER_SM // 2 - SMEM_RESERVED
    budget = (two_ctas if dtype_bytes == 4 and smem(kv2) <= two_ctas
              else SMEM_PER_BLOCK)
    if smem(kv2) > budget:
        raise ValueError(f"head_dim {head_dim} x {dtype_bytes}-byte inputs "
                         f"need {smem(kv2)} B of shared memory, over "
                         f"the budget of {budget} B")
    block_kv1 = kv2
    while ((max_kv1 is None or block_kv1 * 2 <= max_kv1)
           and block_kv1 * 2 <= _round_up(seq_kv, kv2)
           and smem(block_kv1 * 2) <= budget):
        block_kv1 *= 2
    return TilingPlan(block_q=block_q, block_kv1=block_kv1, block_kv2=kv2,
                      smem_bytes=smem(block_kv1), stages=stages)


def sync_count(seq_kv: int, block: int) -> int:
    """Number of staging barriers for one KV pass -- the quantity the
    paper's level-1 enlargement minimises."""
    return (seq_kv + block - 1) // block


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m
