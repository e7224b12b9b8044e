"""Plain PyTorch versions of the mLSTM cell (xLSTM, arXiv:2405.04517).

Copies of the JAX package's ``kernels/mlstm/ref.py`` oracles.  Stabilized
matrix-LSTM:

    logf_t = logsigmoid(ftilde_t)
    m_t    = max(logf_t + m_{t-1}, itilde_t)
    f'_t   = exp(logf_t + m_{t-1} - m_t);   i'_t = exp(itilde_t - m_t)
    C_t    = f'_t C_{t-1} + i'_t k_t v_t^T          (d_k x d_v)
    n_t    = f'_t n_{t-1} + i'_t k_t
    h_t    = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))     q scaled d_k^-1/2

Three equivalent forms: ``mlstm_recurrent`` (a loop over time; the decode
path), ``mlstm_parallel`` (quadratic masked; short-sequence oracle) and
``mlstm_chunkwise`` (linear in S; the algorithm of the CUDA kernel in
``csrc/mlstm_chunkwise.cu``, and what its wrapper runs for CPU tensors).
All compute in float32 and return float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.logsigmoid(x)


def _zero_state(b: int, h: int, dk: int, dv: int,
                device: torch.device) -> State:
    return (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.full((b, h), NEG_INF, dtype=torch.float32, device=device))


def mlstm_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor,
                    initial_state: Optional[State] = None):
    """Sequential oracle.

    q, k: (B, H, S, dk); v: (B, H, S, dv); gates: (B, H, S).
    Returns (h, state): h (B, H, S, dv);
    state = (C (B, H, dk, dv), n (B, H, dk), m (B, H)).
    """
    b, h, _, dk = q.shape
    dv = v.shape[-1]
    q = q.float() * dk ** -0.5
    k = k.float()
    v = v.float()
    logf = _logsigmoid(f_gate.float())
    i_gate = i_gate.float()
    C, n, m = (_zero_state(b, h, dk, dv, q.device) if initial_state is None
               else initial_state)
    hs = []
    for qt, kt, vt, it, lft in zip(q.unbind(2), k.unbind(2), v.unbind(2),
                                   i_gate.unbind(2), logf.unbind(2)):
        m_new = torch.maximum(lft + m, it)
        fp = torch.exp(lft + m - m_new)
        ip = torch.exp(it - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, C)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qt, n)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2), (C, n, m)


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_gate: torch.Tensor, f_gate: torch.Tensor
                   ) -> torch.Tensor:
    """Quadratic masked oracle (no chunking)."""
    b, h, s, dk = q.shape
    q = q.float() * dk ** -0.5
    k = k.float()
    v = v.float()
    logf = _logsigmoid(f_gate.float())
    i_gate = i_gate.float()
    bsum = torch.cumsum(logf, dim=-1)                      # (B, H, S)
    # D[i, j] = b_i - b_j + itilde_j  for j <= i
    D = bsum[..., :, None] - bsum[..., None, :] + i_gate[..., None, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    D = torch.where(mask, D, torch.full_like(D, NEG_INF))
    m = torch.amax(D, dim=-1)                              # (B, H, S)
    w = torch.exp(D - m[..., None])
    scores = torch.einsum("bhid,bhjd->bhij", q, k) * w
    num = torch.einsum("bhij,bhjv->bhiv", scores, v)
    nvec = torch.einsum("bhij,bhjd->bhid", w, k)
    den = torch.maximum(torch.abs(torch.einsum("bhid,bhid->bhi", q, nvec)),
                        torch.exp(-m))
    return num / den[..., None]


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                    chunk: int = 128, initial_state: Optional[State] = None,
                    return_state: bool = False):
    """Chunk-parallel form: intra-chunk quadratic + inter-chunk recurrence.

    q, k: (B, H, S, dk); v: (B, H, S, dv); gates: (B, H, S).  A ragged
    tail is padded to whole chunks with i_gate = -1e30 and f_gate = 30
    (logf ~ 0), as the JAX oracle does.  Returns h (B, H, S, dv) float32,
    and with ``return_state`` also (C, n, m).
    """
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        i_gate = F.pad(i_gate, (0, pad), value=NEG_INF)
        f_gate = F.pad(f_gate, (0, pad), value=30.0)   # logf ~ 0
    sp = s + pad
    n_chunks = sp // chunk

    # per-chunk views by unbind (its backward stacks the chunks' gradients
    # once; a slice per chunk would add a full-size gradient per chunk)
    qc = (q.float() * dk ** -0.5).reshape(b, h, n_chunks, chunk,
                                          dk).unbind(2)
    kc = k.float().reshape(b, h, n_chunks, chunk, dk).unbind(2)
    vc = v.float().reshape(b, h, n_chunks, chunk, dv).unbind(2)
    igc = i_gate.float().reshape(b, h, n_chunks, chunk).unbind(2)
    lfc = _logsigmoid(f_gate.float()).reshape(b, h, n_chunks,
                                              chunk).unbind(2)

    C, n, m = (_zero_state(b, h, dk, dv, q.device) if initial_state is None
               else initial_state)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    outs = []
    for qi, ki, vi, ii, lf in zip(qc, kc, vc, igc, lfc):
        bsum = torch.cumsum(lf, dim=-1)                    # (B, H, L)
        btot = bsum[..., -1]                               # (B, H)
        # ---- per-row stabilizer -----------------------------------------
        Dt = bsum[..., :, None] - bsum[..., None, :] + ii[..., None, :]
        Dt = torch.where(tri, Dt, torch.full_like(Dt, NEG_INF))
        m_intra = torch.amax(Dt, dim=-1)                   # (B, H, L)
        m_inter = m[..., None] + bsum                      # (B, H, L)
        m_row = torch.maximum(m_intra, m_inter)
        # ---- intra-chunk -------------------------------------------------
        w = torch.exp(Dt - m_row[..., None])
        scores = torch.einsum("bhid,bhjd->bhij", qi, ki) * w
        num = torch.einsum("bhij,bhjv->bhiv", scores, vi)
        nrow = torch.einsum("bhij,bhjd->bhid", w, ki)
        # ---- inter-chunk (state) -----------------------------------------
        wi = torch.exp(m_inter - m_row)                    # (B, H, L)
        num = num + wi[..., None] * torch.einsum("bhid,bhdv->bhiv", qi, C)
        nrow = nrow + wi[..., None] * n[..., None, :]
        den = torch.maximum(
            torch.abs(torch.einsum("bhid,bhid->bhi", qi, nrow)),
            torch.exp(-m_row))
        outs.append(num / den[..., None])
        # ---- state update ------------------------------------------------
        m_new = torch.maximum(
            m + btot, torch.amax(btot[..., None] - bsum + ii, dim=-1))
        wC = torch.exp(m + btot - m_new)                   # (B, H)
        wk = torch.exp(btot[..., None] - bsum + ii - m_new[..., None])
        C = wC[..., None, None] * C + torch.einsum(
            "bhj,bhjd,bhjv->bhdv", wk, ki, vi)
        n = wC[..., None] * n + torch.einsum("bhj,bhjd->bhd", wk, ki)
        m = m_new
    out = torch.cat(outs, dim=2)[:, :, :s]
    if return_state:
        return out, (C, n, m)
    return out
