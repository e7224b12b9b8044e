"""Paper §4.2: tiling-AllReduce (T3), over ``torch.distributed``.

In tensor-parallel inference every layer ends in ``partial = x @ W_row``
followed by an AllReduce.  The paper splits the B*S dimension into blocks
and issues one *B-allreduce* per block so communication of block i
overlaps compute of block i+1.  Here each block's all-reduce is issued
asynchronously (``async_op=True``) right after its matmul, and all are
waited on at the end.  Two paper details are preserved:

  * the FIRST block is smaller (``first_chunk_frac``) -- its AllReduce is
    the only one that cannot be overlapped, so shrinking it shrinks the
    exposed latency;
  * the chunk count is bounded so per-block payloads stay large enough to
    saturate link bandwidth.

Every function runs on one rank, on its local shards, and takes the
process group to reduce over (``None``: the default world group):

  matmul_allreduce         -- row-parallel matmul + all-reduce, tiled or
                              single (O-proj and MLP down-proj).
  tiled_matmul_reducescatter, ring_matmul_allreduce -- the sequence-
                              parallel and explicit-ring variants.
  fused_attention_linear   -- the paper's fused attention + Linear +
                              B-allreduce block (head-sharded).

``COUNTS`` tallies the all-reduces issued here and their bytes.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# all-reduces issued by this module (and the LSE merge), and their bytes
COUNTS = {"all_reduce": 0, "bytes": 0}


def all_reduce(t: torch.Tensor, group=None, *, op=dist.ReduceOp.SUM,
               async_op: bool = False):
    """``dist.all_reduce`` in place, counted in ``COUNTS``."""
    COUNTS["all_reduce"] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()
    return dist.all_reduce(t, op=op, group=group, async_op=async_op)


def chunk_sizes(total: int, n_chunks: int, first_frac: float = 0.5,
                align: int = 1) -> Sequence[int]:
    """Split ``total`` into ``n_chunks`` pieces, the first scaled by
    ``first_frac`` (paper: smaller head block), EVERY piece a multiple of
    ``align``.

    The split is computed in units of ``align`` so the trailing chunk is
    aligned too.  ``total`` itself must be a multiple of ``align``;
    callers with ragged totals pad first and slice the result (see
    ``ring_matmul_allreduce``).
    """
    align = max(align, 1)
    if total <= 0:
        raise ValueError(f"total must be positive, got {total}")
    if total % align:
        raise ValueError(
            f"total={total} is not a multiple of align={align}; pad the "
            f"leading dim to a multiple first and slice the result")
    units = total // align
    n_chunks = max(1, min(n_chunks, units))
    if n_chunks == 1:
        sizes = [total]
    else:
        base = units / (n_chunks - 1 + first_frac)
        first = min(max(1, int(base * first_frac)),
                    units - (n_chunks - 1))
        sizes = [first * align]
        remaining = units - first
        for i in range(n_chunks - 2):
            su = max(1, int(base))
            su = min(su, remaining - (n_chunks - 2 - i))
            sizes.append(su * align)
            remaining -= su
        sizes.append(remaining * align)
    assert sum(sizes) == total, sizes
    assert all(s > 0 for s in sizes), sizes
    assert all(s % align == 0 for s in sizes), sizes
    return sizes


def tiled_matmul_allreduce(x: torch.Tensor, w: torch.Tensor, group=None, *,
                           n_chunks: int = 4,
                           first_chunk_frac: float = 0.5) -> torch.Tensor:
    """all_reduce(x @ w) over ``group``, chunked over the leading dim of
    x: x (T, F_local), w (F_local, D).  One asynchronous all-reduce a
    chunk, issued right after the chunk's product, so that it overlaps
    the next chunk's."""
    out = x.new_empty((x.shape[0], w.shape[1]))
    works, off = [], 0
    for s in chunk_sizes(x.shape[0], n_chunks, first_chunk_frac):
        y = out[off:off + s]
        torch.matmul(x[off:off + s], w, out=y)
        works.append(all_reduce(y, group, async_op=True))   # B-allreduce
        off += s
    for work in works:
        work.wait()
    return out


def single_matmul_allreduce(x: torch.Tensor, w: torch.Tensor,
                            group=None) -> torch.Tensor:
    """Baseline: unfused matmul + one monolithic AllReduce."""
    y = x @ w
    all_reduce(y, group)
    return y


def matmul_allreduce(x: torch.Tensor, w: torch.Tensor, group=None, *,
                     mode: str = "tiled", n_chunks: int = 4,
                     first_chunk_frac: float = 0.5) -> torch.Tensor:
    """Row-parallel matmul + AllReduce, dispatching on ``mode``: the
    entry point the tensor-parallel serving path uses for O-proj and
    down-proj partial sums.  ``"tiled"`` issues one all-reduce per chunk
    of the token dim (paper T3, overlapped); ``"single"`` is the
    monolithic baseline."""
    if mode == "single":
        return single_matmul_allreduce(x, w, group)
    if mode != "tiled":
        raise ValueError(f"unknown allreduce mode {mode!r} "
                         "(expected 'tiled' or 'single')")
    return tiled_matmul_allreduce(x, w, group, n_chunks=n_chunks,
                                  first_chunk_frac=first_chunk_frac)


def tiled_matmul_reducescatter(x: torch.Tensor, w: torch.Tensor,
                               group=None, *, n_chunks: int = 4,
                               first_chunk_frac: float = 0.5
                               ) -> torch.Tensor:
    """Chunked row-parallel matmul + reduce-scatter (sequence-parallel
    TP).  Rank i gets piece i of every chunk's reduced product, the
    pieces concatenated: (T, D) -> (T / world, D)."""
    t = x.shape[0]
    n = dist.get_world_size(group)
    if t % n:
        raise ValueError(
            f"tiled_matmul_reducescatter: leading dim {t} must divide the "
            f"group size {n} -- every chunk scatters evenly over the "
            f"group; pad the rows first")
    sizes = chunk_sizes(t, n_chunks, first_chunk_frac, align=n)
    out = x.new_empty((t // n, w.shape[1]))
    works, off, o = [], 0, 0
    for s in sizes:
        y = x[off:off + s] @ w
        works.append(dist.reduce_scatter_tensor(
            out[o:o + s // n], y, group=group, async_op=True))
        off += s
        o += s // n
    for work in works:
        work.wait()
    return out


def ring_matmul_allreduce(x: torch.Tensor, w: torch.Tensor, group=None, *,
                          n_chunks: int = 4) -> torch.Tensor:
    """Explicit overlap variant: a reduce-scatter ring interleaved with
    the per-chunk matmuls, then an all-gather.  Each ring step's
    send/recv of chunk i runs while later work is queued.

    Rows are padded to a multiple of the group size (each chunk ring-
    scatters into ``s // n`` pieces) and the pad sliced off the result,
    so ragged token counts stay exact."""
    t = x.shape[0]
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    pad = (-t) % n
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    peer = ((lambda i: i % n) if group is None else
            (lambda i: dist.get_global_rank(group, i % n)))
    nxt, prv = peer(idx + 1), peer(idx - 1)
    outs, off = [], 0
    for s in chunk_sizes(t + pad, n_chunks, 1.0, align=n):
        y = x[off:off + s] @ w                              # (s, D)
        # ring reduce-scatter over n-1 steps on this chunk; rank i ends
        # holding fully-reduced piece i, so the all-gather tiles back in
        # order
        piece = s // n
        acc = y[((idx - 1) % n) * piece:][:piece].contiguous()
        for step in range(1, n):
            got = torch.empty_like(acc)
            for work in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, acc, nxt, group),
                    dist.P2POp(dist.irecv, got, prv, group)]):
                work.wait()
            src = (idx - step - 1) % n
            acc = got + y[src * piece:(src + 1) * piece]
        full = y.new_empty((s, y.shape[1]))
        dist.all_gather_into_tensor(full, acc, group=group)
        outs.append(full)
        off += s
    out = torch.cat(outs)
    return out[:t] if pad else out


def fused_attention_linear(q, k, v, w_o, group=None, *, n_chunks: int = 4,
                           first_chunk_frac: float = 0.5,
                           causal: bool = True,
                           softcap: Optional[float] = None,
                           attention_fn: Optional[Callable] = None,
                           mode: str = "tiled") -> torch.Tensor:
    """Paper Fig. 4: fused attention + Linear + B-allreduce.

    Head-sharded: q (B, S, H_local, D), k/v (B, S, Hkv_local, D), w_o
    (H_local*D, d_model) are this rank's heads and O-proj rows.  The S
    dimension is split into blocks; each block runs attention -> O-proj
    -> B-allreduce, block i's allreduce overlapping block i+1's compute.
    Returns (B, S, d_model), the same on every rank.
    """
    from repro_torch.core.fastattention import fast_attention
    b, s, h, d = q.shape
    attention_fn = attention_fn or (
        lambda qq, kk, vv, off: fast_attention(
            qq, kk, vv, causal=causal, softcap=softcap, q_offset=off,
            impl="reference"))
    if mode == "single":
        o = attention_fn(q, k, v, 0).reshape(b * s, h * d)
        return single_matmul_allreduce(o, w_o, group).reshape(b, s, -1)
    # tile along S (paper tiles along B*S; S keeps causal offsets simple)
    outs, works, off = [], [], 0
    for sz in chunk_sizes(s, n_chunks, first_chunk_frac):
        kv_end = off + sz if causal else s
        o_c = attention_fn(q[:, off:off + sz], k[:, :kv_end],
                           v[:, :kv_end], off).reshape(b, sz, h * d)
        y = o_c @ w_o
        works.append(all_reduce(y, group, async_op=True))   # B-allreduce
        outs.append(y)
        off += sz
    for work in works:
        work.wait()
    return torch.cat(outs, dim=1)


def sharded_fused_block(q, k, v, w_o, group=None, **kw) -> torch.Tensor:
    """This rank's share of ``make_sharded_fused_block``: slice the
    rank's contiguous block of heads from whole q/k/v (B, S, H, D) and
    its rows of w_o (H*D, d_model), then run ``fused_attention_linear``
    over ``group``."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    hq, hkv, d = q.shape[2] // n, k.shape[2] // n, q.shape[3]
    return fused_attention_linear(
        q[:, :, r * hq:(r + 1) * hq], k[:, :, r * hkv:(r + 1) * hkv],
        v[:, :, r * hkv:(r + 1) * hkv], w_o[r * hq * d:(r + 1) * hq * d],
        group, **kw)
