"""Paper §4.4: the fine-grained CPU-GPU cooperative strategy (T4).

The port's copy of the JAX package's ``core/offload.py``.  The paper's
closed-form layer split (Eq. 15-20): the first ``L_CPU`` layers keep their
KV cache in host memory and run decode attention ON THE HOST (moving
compute to the data); the remaining ``L_GPU`` layers keep KV on the card.
Only the fixed-size Q and attention output cross PCIe each decode step --
never the KV cache, which is what made it 1.27-1.48x faster than
classical offloading in the paper's Table 3 (8 V100s and their host).

The planner and the latency model are the JAX package's formulas, with
hardware constants as parameters (``tests/test_torch_offload.py`` holds
them equal); the defaults are the H100's and those ``chip_smoke.py``
phase 5 measured on the machine that carries one.  ``HostOffloadEngine``
keeps the host KV in pinned CPU memory, fills it from the card on a side
stream and computes host attention with the plain ``decode_reference``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from repro_torch.analysis.flops import param_count
from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_decode.ref import decode_reference


@dataclass(frozen=True)
class OffloadPlan:
    l_gpu: int                  # layers with on-device KV
    l_cpu: int                  # layers with host KV + host attention
    bytes_weights: int          # M_w   (total model weights)
    bytes_kv_layer: int         # M_kv  (per layer, per device)
    bytes_mid: int              # M_mid (intermediate, per device)
    bytes_vocab: int            # M_vocab
    device_budget: int          # M_GPU
    needs_offload: bool

    def summary(self) -> str:
        return (f"L_GPU={self.l_gpu} L_CPU={self.l_cpu} "
                f"(weights={self.bytes_weights/2**30:.2f}GiB "
                f"kv/layer/dev={self.bytes_kv_layer/2**20:.1f}MiB "
                f"mid={self.bytes_mid/2**20:.1f}MiB "
                f"offload={'yes' if self.needs_offload else 'no'})")


def plan_offload(cfg: ModelConfig, *, batch: int, seq_len: int,
                 gen_len: int, n_devices: int,
                 device_memory_gb: float = 80.0,
                 dtype_bytes: int = 2) -> OffloadPlan:
    """Paper Eq. 15-20 generalized to arbitrary architectures.

      L_GPU = (M_GPU - M_w/n - M_mid - M_vocab) / M_kv ;  L_CPU = L - L_GPU

    M_w uses the real per-layer parameter model (incl. GQA/MoE) instead of
    the paper's 8H1^2 + 4H1H2 (which assumes MHA + 2-matrix FFN); for MHA
    dense models the two coincide.  ``device_memory_gb`` defaults to one
    H100 SXM's 80 GB.
    """
    n = n_devices
    L = cfg.num_layers
    h1 = cfg.d_model
    m_vocab = cfg.vocab_size * h1 * dtype_bytes
    n_embed_mats = 1 if cfg.tie_embeddings else 2
    m_w = (param_count(cfg) - n_embed_mats * cfg.vocab_size * h1) * dtype_bytes
    # per-layer KV on ONE device (paper Eq. 18; kv heads, not H1, for GQA)
    m_kv = 2 * dtype_bytes * batch * cfg.kv_dim * (seq_len + gen_len) / n
    # intermediate activations (paper Eq. 19)
    m_mid = 3 * dtype_bytes * batch * seq_len * h1 / n
    m_gpu = device_memory_gb * 2 ** 30

    total_kv = m_kv * L
    fits = m_w / n + m_mid + m_vocab + total_kv <= m_gpu
    if fits:
        l_gpu = L
    else:
        l_gpu = int((m_gpu - m_w / n - m_mid - m_vocab) / m_kv)
        l_gpu = max(0, min(L, l_gpu))
    return OffloadPlan(
        l_gpu=l_gpu, l_cpu=L - l_gpu,
        bytes_weights=int(m_w), bytes_kv_layer=int(m_kv),
        bytes_mid=int(m_mid), bytes_vocab=int(m_vocab),
        device_budget=int(m_gpu), needs_offload=not fits)


@dataclass(frozen=True)
class OffloadLatencyModel:
    """Analytic latency model for the Table-3 comparison.

    The device constants are the H100 SXM's data-sheet peaks.  The host
    constants are what ``chip_smoke.py`` phase 5 measured on a machine
    with one NVIDIA H100 80GB HBM3 at 700.00 W and 8 host CPU cores, at
    llama2-7b's layer shape, B=1, S=65536.
    """
    # pinned host->device copy of one layer's bf16 KV (1.07 GB), measured
    # on NVIDIA H100 80GB HBM3, 700.00 W
    pcie_gbps: float = 47.9
    # host float32 decode_reference over that layer's f32 KV (8 cores),
    # measured beside NVIDIA H100 80GB HBM3, 700.00 W
    host_gflops: float = 10.5
    device_tflops: float = 989.0     # H100 SXM bf16 dense peak
    device_gbps: float = 3350.0      # H100 SXM HBM3

    def classical_upload_s(self, kv_bytes_layer: float) -> float:
        """Classical offloading: upload the layer's KV cache, then compute."""
        return kv_bytes_layer / (self.pcie_gbps * 1e9)

    def coop_offupload_s(self, batch: int, q_dim: int,
                         dtype_bytes: int = 2) -> float:
        """Cooperative: ship QKV (new token) down + result up -- O(B*H)."""
        qkv = 3 * batch * q_dim * dtype_bytes
        out = batch * q_dim * dtype_bytes
        return (qkv + out) / (self.pcie_gbps * 1e9)

    def host_attention_s(self, batch: int, kv_len: int, q_dim: int) -> float:
        flops = 2 * 2 * batch * kv_len * q_dim          # QK^T + PV
        return flops / (self.host_gflops * 1e9)

    def device_attention_s(self, batch: int, kv_len: int, q_dim: int) -> float:
        flops = 2 * 2 * batch * kv_len * q_dim
        # decode attention is HBM-bound; charge bytes instead of flops
        bytes_ = 2 * batch * kv_len * q_dim * 2
        return max(flops / (self.device_tflops * 1e12),
                   bytes_ / (self.device_gbps * 1e9))


def kv_page_bytes(cfg: ModelConfig, page_size: int,
                  dtype_bytes: int = 2) -> int:
    """Bytes of ONE KV page across all layers (K+V) -- the unit the
    page-pressure subsystem moves over PCIe when it swaps a preempted
    sequence's pages to the host pool."""
    return 2 * dtype_bytes * cfg.num_layers * cfg.kv_dim * page_size


def preempt_cost_model(cfg: ModelConfig, *, n_pages: int, n_tokens: int,
                       page_size: int,
                       model: OffloadLatencyModel = OffloadLatencyModel(),
                       dtype_bytes: int = 2,
                       swap_latency_s: float = 5e-4):
    """(swap_s, recompute_s) for evicting a sequence with ``n_pages``
    materialised pages covering ``n_tokens`` tokens.

    Swap is a PCIe round trip (device->host now, host->device on resume)
    at the model's bandwidth plus a fixed per-transfer latency, so small
    victims favour recompute; recompute charges the full re-prefill FLOPs
    (~2 * params per token) at device peak, so long-context victims favour
    swap.
    """
    bytes_ = n_pages * kv_page_bytes(cfg, page_size, dtype_bytes)
    swap_s = 2 * (swap_latency_s + bytes_ / (model.pcie_gbps * 1e9))
    recompute_s = (2 * param_count(cfg) * n_tokens
                   / (model.device_tflops * 1e12))
    return swap_s, recompute_s


def table3_row(cfg: ModelConfig, seq_len: int, *, batch: int = 1,
               n_devices: int = 8,
               model: OffloadLatencyModel = OffloadLatencyModel(),
               device_memory_gb: float = 80.0):
    """One row of the paper's Table 3 (per-layer attention latency)."""
    plan = plan_offload(cfg, batch=batch, seq_len=seq_len, gen_len=64,
                        n_devices=n_devices,
                        device_memory_gb=device_memory_gb)
    gpu_calc = model.device_attention_s(batch, seq_len, cfg.q_dim)
    if not plan.needs_offload:
        return dict(seq=seq_len, offload=False, gpu_calc_s=gpu_calc,
                    classical_total_s=gpu_calc, coop_total_s=gpu_calc,
                    l_cpu=0, l_gpu=plan.l_gpu)
    upload = model.classical_upload_s(plan.bytes_kv_layer)
    cpu_calc = model.host_attention_s(batch, seq_len, cfg.q_dim)
    off_up = model.coop_offupload_s(batch, cfg.q_dim)
    return dict(seq=seq_len, offload=True,
                classical_upload_s=upload,
                gpu_calc_s=gpu_calc,
                classical_total_s=upload + gpu_calc,
                coop_cpu_calc_s=cpu_calc,
                coop_offupload_s=off_up,
                coop_total_s=cpu_calc + off_up,
                speedup=(upload + gpu_calc) / (cpu_calc + off_up),
                l_cpu=plan.l_cpu, l_gpu=plan.l_gpu)


def max_context_length(cfg: ModelConfig, *, batch: int, n_devices: int,
                       device_memory_gb: float, host_memory_gb: float,
                       dtype_bytes: int = 2, gen_len: int = 64) -> dict:
    """Max supported S without vs with the cooperative strategy (the
    paper's 16K -> 256K headline on 8 V100s)."""
    def plan(s):
        return plan_offload(cfg, batch=batch, seq_len=s, gen_len=gen_len,
                            n_devices=n_devices,
                            device_memory_gb=device_memory_gb,
                            dtype_bytes=dtype_bytes)

    def fits_device_only(s):
        return not plan(s).needs_offload

    def fits_coop(s):
        p = plan(s)
        host_kv = p.bytes_kv_layer * p.l_cpu * n_devices
        return (p.l_gpu >= 0 and
                host_kv <= host_memory_gb * 2 ** 30)

    def bisect(pred, lo=1024, hi=1 << 24):
        if not pred(lo):
            return 0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if pred(mid):
                lo = mid
            else:
                hi = mid - 1
        return lo

    return dict(device_only=bisect(fits_device_only),
                cooperative=bisect(fits_coop))


# ---------------------------------------------------------------------------
# Execution engine: host-resident KV + host attention
# ---------------------------------------------------------------------------

class HostOffloadEngine:
    """Runtime for T4.  Layers < l_cpu keep KV on the host and compute
    decode attention there; the rest stay on the card.

    Host KV is (max_batch, max_seq, Hkv, D) float32 per layer, as in the
    JAX package, in pinned memory when a CUDA device exists (so the
    device->host copies are asynchronous DMA).  ``prefill_offload`` and
    ``decode_append`` convert on the card and copy on a side stream, then
    record an event; ``decode_attention`` waits on that event, copies Q
    down, runs ``decode_reference`` on the host and copies the output up
    (the paper's step 4).  With CPU tensors the copies are plain
    synchronous copies.
    """

    def __init__(self, cfg: ModelConfig, plan: OffloadPlan, *,
                 max_batch: int, max_seq: int,
                 host_device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.plan = plan
        self.host = torch.device("cpu" if host_device is None
                                 else host_device)
        pin = torch.cuda.is_available()
        kvshape = (max_batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        self._host_kv = {
            li: (torch.zeros(kvshape, dtype=torch.float32, device=self.host,
                             pin_memory=pin),
                 torch.zeros(kvshape, dtype=torch.float32, device=self.host,
                             pin_memory=pin))
            for li in range(plan.l_cpu)
        }
        self._stream: Optional[torch.cuda.Stream] = None
        # layer -> event recorded after its last device->host copy
        self._ready: Dict[int, torch.cuda.Event] = {}

    def is_host_layer(self, layer_idx: int) -> bool:
        return layer_idx < self.plan.l_cpu

    def _store(self, layer_idx: int, pos: int, k: torch.Tensor,
               v: torch.Tensor) -> None:
        """Copy (B, S, Hkv, D) K/V into the layer's host KV at token
        ``pos``; from the card asynchronously, on the side stream."""
        kh, vh = self._host_kv[layer_idx]
        b, s = k.shape[0], k.shape[1]
        if not k.is_cuda:
            kh[:b, pos:pos + s] = k.to(kh.dtype)
            vh[:b, pos:pos + s] = v.to(vh.dtype)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(k.device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(k.device))
        with torch.cuda.stream(stream):
            for src, dst in ((k, kh), (v, vh)):
                src.record_stream(stream)      # read on the side stream
                f = src.to(dst.dtype)
                for i in range(b):             # each row is contiguous
                    dst[i, pos:pos + s].copy_(f[i], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        self._ready[layer_idx] = ev

    def prefill_offload(self, layer_idx: int, k: torch.Tensor,
                        v: torch.Tensor) -> None:
        """Async KV offload after the prefill KV projection (paper step
        3).  k, v: (B, S, Hkv, D)."""
        if not self.is_host_layer(layer_idx):
            return
        self._store(layer_idx, 0, k, v)

    def decode_append(self, layer_idx: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, pos: int) -> None:
        """Append one decode step's K/V rows (B, 1, Hkv, D) at ``pos``."""
        self._store(layer_idx, pos, k_new, v_new)

    def host_attention(self, layer_idx: int, q_host: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
        """Decode attention on the host: q_host (B, 1, Hq, D) on the host
        against the layer's host KV.  Returns (B, 1, Hq, D) in q's dtype."""
        ev = self._ready.pop(layer_idx, None)
        if ev is not None:
            ev.synchronize()
        kh, vh = self._host_kv[layer_idx]
        b = q_host.shape[0]
        out = decode_reference(q_host.transpose(1, 2), kh[:b], vh[:b],
                               kv_len, layout="bshd")
        return out.transpose(1, 2)

    def decode_attention(self, layer_idx: int, q: torch.Tensor,
                         kv_len) -> torch.Tensor:
        """Offload Q, compute attention on the host, upload the result
        (paper step 4: 'uses CPUs to finish the attention calculation ...
        results will be uploaded to GPUs').  q: (B, 1, Hq, D)."""
        lens = torch.as_tensor(kv_len, dtype=torch.int32)
        out = self.host_attention(layer_idx, q.to(self.host), lens)
        return out.to(q.device)
