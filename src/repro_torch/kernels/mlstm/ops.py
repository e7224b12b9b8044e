"""Wrappers of the chunkwise mLSTM CUDA kernel.

* ``mlstm_chunkwise_fwd`` -- the forward, ``csrc/mlstm_chunkwise.cu``:
  h and the final (C, n, m) state;
* ``mlstm_chunkwise`` -- h with a gradient (``torch.autograd.Function``
  whose backward recomputes through the plain ``ref.mlstm_chunkwise``, as
  the JAX package's ``custom_vjp`` does: it has no backward kernel).

For CUDA tensors ``mlstm_chunkwise_fwd`` launches the kernel (built at
first use, see ``kernels/build.py``) or raises; for CPU tensors it runs
the plain version.  ``mlstm_chunkwise_fwd.launches`` counts kernel
launches (plain-version calls are not counted).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _launch as L
from repro_torch.kernels import build
from repro_torch.kernels.mlstm import ref

MAX_CHUNK = 128           # rows of the kernel's intra-chunk tile
NO_FIT = -2               # the C entry's status when dk does not fit SMEM
GATE_FLOATS = 5 * MAX_CHUNK + 4     # a chunk's gate record in the workspace

_ARGTYPES = (L.P, L.P, L.P, L.P, L.P,                 # q k v ig fg
             L.P, L.P, L.P, L.P, L.P,                 # h C n m workspace
             L.I, L.I, L.I, L.I, L.I, L.I, L.F,       # B H S dk dv L scale
             L.L, L.L, L.L, L.L, L.L, L.L,            # q, k strides b h s
             L.L, L.L, L.L, L.L, L.L, L.L,            # v, h strides b h s
             L.I, L.P)                                # dtype stream


def _check(q, k, v, i_gate, f_gate, chunk):
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if (k.shape != q.shape or v.shape[:3] != (b, h, s)
            or i_gate.shape != (b, h, s) or f_gate.shape != (b, h, s)
            or s == 0 or dk == 0 or dv == 0 or chunk < 1):
        raise ValueError(
            f"mlstm_chunkwise_fwd: bad arguments q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, gates "
            f"{tuple(i_gate.shape)}/{tuple(f_gate.shape)}, chunk {chunk} "
            "(q, k (B, H, S, dk); v (B, H, S, dv); gates (B, H, S); S, dk, "
            "dv and chunk at least 1)")


def workspace_floats(b: int, h: int, s: int, dk: int, dv: int,
                     chunk: int) -> int:
    """float32 values of the bfloat16 kernel's workspace: the state (C, n)
    before each of the ceil(S / chunk) chunks of every (b, h), and each
    chunk's gate record.  xlstm-125m's training shape (B=8, H=4, S=2048,
    dk=dv=384, chunk 128): 76,023,808 floats, 304 MB."""
    n = b * h * -(-s // chunk)
    return n * (dk * dv + dk + GATE_FLOATS)


def mlstm_chunkwise_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                        chunk: int = 128):
    """Chunkwise stabilised mLSTM forward.

    q, k: (B, H, S, dk); v: (B, H, S, dv) (float32 or bfloat16, any
    strides over B, H and S, a contiguous last dimension -- the model
    passes (B, S, H, D) projections transposed, read in place); gates
    (B, H, S), taken as float32.  ``chunk`` is the intra-chunk length
    (``min(chunk, S)``, at most 128 on the card).  Returns
    (h (B, H, S, dv) in q's dtype and q's layout,
    (C (B, H, dk, dv), n (B, H, dk), m (B, H)) float32).

    On the card, bfloat16 runs the tensor-core kernels, which need dk, dv
    and q/k/v's strides to be multiples of 8 and a workspace of
    ``workspace_floats(B, H, S, dk, dv, chunk)`` float32 values (304 MB at
    xlstm-125m's training shape), allocated here per call; float32 runs
    the FMA kernel and takes none.
    """
    _check(q, k, v, i_gate, f_gate, chunk)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if q.device.type == "cpu":
        out, state = ref.mlstm_chunkwise(q, k, v, i_gate, f_gate,
                                         chunk=chunk, return_state=True)
        return out.to(q.dtype), state
    if chunk > MAX_CHUNK:
        raise ValueError(f"mlstm_chunkwise_fwd: chunk {chunk} above the "
                         f"kernel's {MAX_CHUNK}")
    if q.dtype not in L.DTYPE_CODES:
        raise ValueError(f"mlstm_chunkwise_fwd: dtype {q.dtype} not "
                         "supported (float32 or bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"mlstm_chunkwise_fwd: {name} is {t.dtype} on "
                             f"{t.device}, expected {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"mlstm_chunkwise_fwd: {name}'s last dimension "
                             "must be contiguous")
        if q.dtype == torch.bfloat16 and (
                dk % 8 or dv % 8 or t.data_ptr() % 16
                or any(x % 8 for x in t.stride()[:3])):
            raise ValueError(
                f"mlstm_chunkwise_fwd: bfloat16 needs dk ({dk}), dv ({dv}) "
                f"and {name}'s strides {t.stride()} to be multiples of 8 and "
                "16-byte aligned rows")
    for name, t in (("i_gate", i_gate), ("f_gate", f_gate)):
        if t.device != q.device:
            raise ValueError(f"mlstm_chunkwise_fwd: {name} must be on "
                             f"{q.device}, got {t.device}")
    ig = i_gate.float().contiguous()
    fg = f_gate.float().contiguous()
    # h in q's layout: (B, S, H, dv) memory when q's heads are inner
    if q.stride(1) < q.stride(2):
        out = torch.empty((b, s, h, dv), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    else:
        out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.empty((b, h, dk, dv), **f32)
    n = torch.empty((b, h, dk), **f32)
    m = torch.empty((b, h), **f32)
    if b == 0 or h == 0:
        return out, (C, n, m)
    ws = (torch.empty(workspace_floats(b, h, s, dk, dv, chunk), **f32)
          if q.dtype == torch.bfloat16 else None)
    lib = build.library("mlstm_chunkwise", _ARGTYPES)
    status = lib.mlstm_chunkwise(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
        fg.data_ptr(), out.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), None if ws is None else ws.data_ptr(),
        b, h, s, dk, dv, chunk, float(dk ** -0.5),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], L.DTYPE_CODES[q.dtype], L.stream_ptr(q.device))
    if status == NO_FIT:
        raise ValueError(f"mlstm_chunkwise_fwd: dk {dk} does not fit the "
                         "kernel's shared memory")
    L.check_status("mlstm_chunkwise_fwd", status)
    mlstm_chunkwise_fwd.launches += 1
    return out, (C, n, m)


mlstm_chunkwise_fwd.launches = 0


class _MLSTMChunkwise(torch.autograd.Function):
    """Forward through ``mlstm_chunkwise_fwd``; backward recomputes the
    plain ``ref.mlstm_chunkwise`` on the saved inputs and differentiates
    it (the JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, chunk):
        ctx.save_for_backward(q, k, v, i_gate, f_gate)
        ctx.chunk = chunk
        h, _ = mlstm_chunkwise_fwd(q, k, v, i_gate, f_gate, chunk=chunk)
        return h

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in saved]
            out = ref.mlstm_chunkwise(*leaves, chunk=ctx.chunk)
            grads = torch.autograd.grad(out, leaves, g.float())
        return (*grads, None)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor,
                    chunk: int = 128,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Chunkwise mLSTM with a gradient: h (B, H, S, dv) only.

    impl "kernel" (alias "pallas") runs ``mlstm_chunkwise_fwd`` in the
    forward (h in q's dtype; the plain version for CPU tensors) and the
    plain recompute in the backward; "reference" differentiates
    ``ref.mlstm_chunkwise`` directly (h float32).  None or "auto": the
    kernel for CUDA tensors, the plain version for CPU.
    """
    if L.resolve_impl(impl, q, "mlstm") == "reference":
        return ref.mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk=chunk)
    return _MLSTMChunkwise.apply(q, k, v, i_gate, f_gate, chunk)
