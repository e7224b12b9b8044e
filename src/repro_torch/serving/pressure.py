"""Page-pressure manager: preemption with KV swap-to-host or recompute.

The port of the JAX package's ``serving/pressure.py``.  Optimistic
admission (``scheduler.admit``) reserves no worst-case pages, so
``PagedKVCache.append`` can hit ``OutOfPages`` mid-step.  The engine then
calls ``PressureManager.relieve``, which reclaims an idle prefix-cache
leaf or evicts the newest-admitted sequence
(``scheduler.preemption_victim``) and disposes of its materialised KV one
of two ways:

* **swap** -- the victim's pages are gathered off the device pools into a
  ``HostPagePool`` stash (device->host copy); on resume the scheduler
  re-materialises pages (``adopt_pages``) and the engine scatters the
  stash back.  The round trip is bit-exact, so greedy tokens equal an
  unpressured run's.
* **recompute** -- nothing is copied; on resume the sequence re-prefills
  ``prompt + generated[:-1]`` through the chunked paged prefill.

``preempt_policy="auto"`` chooses per victim with
``core/offload.py:preempt_cost_model``.

The pools are the model's per-layer ``KVCache(k, v)`` page pools, each
(Hkv, P, page_size, D): the page axis is 1.  Every copy here runs between
engine steps and writes the pools in place (``index_copy_``), as the
model's own prefill and decode do: an out-of-place write would hold a
second copy of every layer's pool.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch

from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.core.offload import OffloadLatencyModel, preempt_cost_model
from repro_torch.device import torch_dtype
from repro_torch.serving.faults import InjectedFault, SwapRestoreFailed
from repro_torch.serving.paged_cache import OutOfPages, PagedKVCache
from repro_torch.serving.scheduler import (PREFILLING, ContinuousBatchScheduler,
                                           Request)

PAGE_AXIS = 1       # pools are (Hkv, P, page_size, D)


def _index(pools, pages: Sequence[int]) -> torch.Tensor:
    return torch.as_tensor(list(pages), dtype=torch.long,
                           device=pools[0][0].device)


def gather_pages(pools, pages: Sequence[int]) -> List[tuple]:
    """Device->host copy of the given physical pages from every pool.
    Returns one tuple of host tensors a layer, shaped like the pools with
    the page axis narrowed to ``len(pages)``.  From a CUDA pool the copies
    land in pinned memory and are waited for before this returns, so a
    later restore never reads a stash not yet written."""
    idx = _index(pools, pages)
    on_card = idx.device.type == "cuda"

    def take(a: torch.Tensor) -> torch.Tensor:
        sel = a.index_select(PAGE_AXIS, idx)
        if not on_card:
            return sel                  # index_select already copied
        host = torch.empty(sel.shape, dtype=sel.dtype, pin_memory=True)
        host.copy_(sel, non_blocking=True)
        return host

    out = [tuple(take(a) for a in layer) for layer in pools]
    if on_card:
        torch.cuda.current_stream(idx.device).synchronize()
    return out


def scatter_pages(pools, pages: Sequence[int], host_data):
    """Host->device copy-back: write ``host_data`` (a ``gather_pages``
    result) into the -- possibly different -- physical ``pages`` of every
    pool, in place.  Same dtype both ways, so the swap round trip is
    exact.  Returns the pools."""
    idx = _index(pools, pages)
    for layer, hosts in zip(pools, host_data):
        for a, h in zip(layer, hosts):
            a.index_copy_(PAGE_AXIS, idx,
                          h.to(a.device, a.dtype, non_blocking=True))
    return pools


def copy_pages(pools, srcs: Sequence[int], dsts: Sequence[int]):
    """Device-side page copy (``dst[i] <- src[i]`` in every pool): the data
    half of copy-on-write -- the host manager moved a slot off a shared
    tail page, this replays the contents onto the fresh copy before the
    next launch writes it.  Every source is read before any destination
    is written (parallel-copy semantics).  Returns the pools."""
    src, dst = _index(pools, srcs), _index(pools, dsts)
    for layer in pools:
        for a in layer:
            a.index_copy_(PAGE_AXIS, dst, a.index_select(PAGE_AXIS, src))
    return pools


def _nbytes(host_data) -> int:
    return sum(t.nbytes for layer in host_data for t in layer)


class HostPagePool:
    """Host-side stash for swapped-out KV pages, keyed by request id.

    ``capacity_pages == 0`` means unbounded (host RAM is the real bound).
    The stash holds what ``gather_pages`` returned: pinned tensors when
    the pools are on the card, plain ones on the CPU."""

    def __init__(self, capacity_pages: int = 0):
        self.capacity_pages = capacity_pages
        self.used_pages = 0
        self.peak_pages = 0
        self._stash: dict = {}          # request id -> (host_data, n_pages)

    def has_room(self, n_pages: int) -> bool:
        return (not self.capacity_pages
                or self.used_pages + n_pages <= self.capacity_pages)

    def put(self, request_id: int, host_data, n_pages: int) -> None:
        if request_id in self._stash:
            raise ValueError(f"request {request_id} already stashed")
        if not self.has_room(n_pages):
            raise OutOfPages(
                f"host page pool full: {self.used_pages}+{n_pages} > "
                f"{self.capacity_pages}")
        self._stash[request_id] = (host_data, n_pages)
        self.used_pages += n_pages
        self.peak_pages = max(self.peak_pages, self.used_pages)

    def peek(self, request_id: int):
        """Read a stash without consuming it -- restore() scatters from a
        peek and only pops after the copy-back succeeded, so a failed
        swap-in never loses the only copy of the KV."""
        return self._stash[request_id][0]

    def pop(self, request_id: int):
        host_data, n_pages = self._stash.pop(request_id)
        self.used_pages -= n_pages
        return host_data

    def __contains__(self, request_id: int) -> bool:
        return request_id in self._stash

    def __len__(self) -> int:
        return len(self._stash)


class PressureManager:
    """Relieves ``OutOfPages`` by evicting sequences, and restores them on
    re-admission.  Owns the host page pool, the swap/recompute policy and
    the pressure statistics."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig,
                 cache: PagedKVCache, sched: ContinuousBatchScheduler, *,
                 latency_model: Optional[OffloadLatencyModel] = None,
                 swap_latency_s: float = 5e-4, prefix_cache=None,
                 injector=None, metrics=None, tracer=None):
        if serve.preempt_policy not in ("swap", "recompute", "auto"):
            raise ValueError(
                f"unknown preempt_policy {serve.preempt_policy!r}")
        self.cfg = cfg
        self.cache = cache
        self.sched = sched
        self.policy = serve.preempt_policy
        self.host_pool = HostPagePool(serve.host_pool_pages)
        self.lat = latency_model or OffloadLatencyModel()
        self.swap_latency_s = swap_latency_s
        self.dtype_bytes = torch_dtype(cfg.dtype).itemsize
        # swap bytes are reported for the whole KV, as the JAX engine's
        # host copy of a sharded pool is the whole array: under tensor
        # parallelism each rank stashes 1/tp of it
        self.tp = serve.tp
        self.prefix_cache = prefix_cache    # RadixPrefixIndex or None
        self.injector = injector            # FaultInjector or None
        self.swap_retries = serve.swap_retries
        self.swap_retry_backoff_s = serve.swap_retry_backoff_s
        self.stats = {"preemptions": 0, "swaps": 0, "recomputes": 0,
                      "swap_bytes_out": 0, "swap_bytes_in": 0,
                      "cache_evictions": 0, "swap_drops": 0,
                      "abort_drops": 0, "fail_drops": 0,
                      "swap_retries": 0, "swap_fail_downgrades": 0}
        # the stats dict is what stats() exposes; the registry mirrors
        # every key as a cumulative ``pressure_<key>_total`` counter, and
        # the tracer sees swap-out/in/drop
        self.metrics = metrics
        self.tracer = tracer
        self._counters = ({k: metrics.counter(f"pressure_{k}_total")
                           for k in self.stats}
                          if metrics is not None else None)

    def _bump(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        if self._counters is not None:
            self._counters[key].inc(n)

    # -- transient-fault retry --------------------------------------------
    def _swap_op(self, site: str, fn):
        """Run a swap copy under the transient-fault retry budget:
        ``swap_retries`` retries with bounded exponential backoff.  The
        injector site fires BEFORE the copy, so an injected fault never
        leaves a half-done copy.  Returns the copy's result, or None when
        the budget is exhausted -- the caller downgrades to recompute
        (swap-out) or raises SwapRestoreFailed (swap-in).  Only an
        injected fault is retried: a CUDA error is not transient (it
        poisons the context) and propagates."""
        for attempt in range(self.swap_retries + 1):
            try:
                if self.injector is not None:
                    self.injector.fire(site)
            except InjectedFault:
                self._bump("swap_retries")
                if attempt < self.swap_retries \
                        and self.swap_retry_backoff_s > 0:
                    time.sleep(min(self.swap_retry_backoff_s * 2 ** attempt,
                                   0.1))
                continue
            return fn()
        return None

    # -- policy ----------------------------------------------------------
    def choose_policy(self, n_pages: int, n_tokens: int) -> str:
        """Swap vs recompute for a victim with ``n_pages`` materialised
        pages / ``n_tokens`` tokens (before the host-pool room check)."""
        if n_tokens == 0 or self.policy == "recompute":
            return "recompute"
        if self.policy == "swap":
            return "swap"
        swap_s, rec_s = preempt_cost_model(
            self.cfg, n_pages=n_pages, n_tokens=n_tokens,
            page_size=self.cache.page_size, model=self.lat,
            dtype_bytes=self.dtype_bytes,
            swap_latency_s=self.swap_latency_s)
        return "swap" if swap_s < rec_s else "recompute"

    # -- evict -----------------------------------------------------------
    def relieve(self, pools, protect: Optional[int] = None
                ) -> Optional[Request]:
        """Free at least one page: first reclaim an LRU leaf from the
        prefix index (cached-but-idle KV goes before live sequences), else
        evict the newest-admitted sequence other than ``protect``.
        Returns the preempted request, or None when index eviction
        sufficed.  Raises OutOfPages when nothing is reclaimable."""
        if self.prefix_cache is not None and self.prefix_cache.evict(1):
            self._bump("cache_evictions")
            return None
        victim = self.sched.preemption_victim(protect)
        if victim is None:
            raise OutOfPages(
                "page pressure with no preemptible sequence -- pool too "
                "small for a single request (submit-time validation "
                "should have rejected it)")
        return self.preempt_slot(pools, victim)

    def preempt_slot(self, pools, slot: int) -> Request:
        """Evict a specific slot: decide swap/recompute over its
        *exclusive* pages, copy those off the device if swapping, then
        hand the slot back to the scheduler.  Pages shared with other
        slots or the prefix index (always a contiguous page-list prefix)
        are only decref'd and re-shared at resume."""
        req = self.sched.slots[slot]
        # KV actually written to the pools: a PREFILLING victim has its
        # completed chunks; a decoding victim has prompt + all generated
        # tokens but the last (whose KV its next decode step writes)
        written = req.prefilled if req.state == PREFILLING \
            else req.prefill_total
        ps = self.cache.page_size
        n_pages = -(-written // ps)
        owned = self.cache.owned_pages(slot)[:n_pages]
        shared = 0
        while shared < len(owned) \
                and self.cache.refcount(owned[shared]) > 1:
            shared += 1
        shared_len = min(shared * ps, written)
        kind = self.choose_policy(n_pages - shared, written - shared_len)
        if kind == "swap" and not self.host_pool.has_room(n_pages - shared):
            kind = "recompute"
        if kind == "swap":
            host_data = self._swap_op(
                "swap_d2h", lambda: gather_pages(pools, owned[shared:]))
            if host_data is None:
                # the D2H kept failing past the retry budget: fall back to
                # recompute -- strictly slower, never incorrect
                kind = "recompute"
                self._bump("swap_fail_downgrades")
        if kind == "swap":
            self.host_pool.put(req.id, host_data, n_pages - shared)
            self._bump("swaps")
            self._bump("swap_bytes_out", _nbytes(host_data) * self.tp)
            req.resume_shared_len = shared_len
            if self.tracer is not None:
                self.tracer.on_swap_out(req)
        else:
            self._bump("recomputes")
            req.resume_shared_len = 0
        req.resume_kind = kind
        req.resume_len = written
        self.sched.preempt(slot)
        self._bump("preemptions")
        return req

    # -- restore ---------------------------------------------------------
    def holds(self, request_id: int) -> bool:
        return request_id in self.host_pool

    def restore(self, pools, slot: int, req: Request):
        """Copy a swap-resumed request's stashed KV back into the pages
        admission just materialised for it -- the exclusive suffix only;
        the shared prefix was re-shared straight from the index.  Returns
        the pools.  The scatter reads a ``peek`` of the stash and pops it
        only once the copy-back succeeded; past the retry budget this
        raises ``SwapRestoreFailed`` with the stash intact, and the engine
        downgrades the resume to recompute."""
        host_data = self.host_pool.peek(req.id)
        ps = self.cache.page_size
        n_pages = -(-req.resume_len // ps)
        k = req.resume_shared_len // ps
        pages = self.cache.owned_pages(slot)[k:n_pages]
        assert len(pages) == n_pages - k, (slot, pages, n_pages, k)
        new_pools = self._swap_op(
            "swap_h2d", lambda: scatter_pages(pools, pages, host_data))
        if new_pools is None:
            raise SwapRestoreFailed(
                f"request {req.id}: swap-in failed past "
                f"{self.swap_retries} retries")
        self.host_pool.pop(req.id)
        self._bump("swap_bytes_in", _nbytes(host_data) * self.tp)
        req.resume_kind = None
        req.resume_shared_len = 0
        if self.tracer is not None:
            self.tracer.on_swap_in(req)
        return new_pools

    def drop(self, request_id: int, *, reason: str = "downgrade") -> None:
        """Discard a stash: its owner was downgraded to recompute while
        waiting, aborted while swap-preempted (``reason="abort"``), or
        quarantined after a request-level failure (``reason="fail"``)."""
        self.host_pool.pop(request_id)
        self._bump({"abort": "abort_drops",
                    "fail": "fail_drops"}.get(reason, "swap_drops"))
        if self.tracer is not None:
            self.tracer.on_swap_drop(request_id)
