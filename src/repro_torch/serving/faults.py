"""Fault taxonomy and deterministic fault injection for the serving stack.

Production attention engines treat the serving runtime, not just the
kernel, as the deliverable: a transient swap DMA error, NaN logits from
one degenerate request, or a full waiting queue must degrade to a
*per-request* outcome -- never strand the page pool, refcounts, COW
debts or swap stashes of the co-tenants.  This module defines the two
halves of that contract:

**The error taxonomy.**  ``RequestError`` (and its subclasses) marks a
failure attributable to exactly one request; ``EngineCore.step()``
quarantines the offending request -- pages freed, shared-prefix pages
decref'd, stash dropped -- and keeps serving everyone else.
``EngineError`` marks a failure of the engine itself (an invariant
breach, an unrecoverable device error): the core surfaces it and stops,
because continuing would corrupt co-tenant state.  ``RequestRejected``
doubles as a ``ValueError`` so pre-existing callers catching submit
validation errors keep working.

**The fault injector.**  A seeded, deterministic chaos harness: named
*sites* are threaded through ``PagedKVCache`` (``page_alloc``),
``PressureManager`` (``swap_d2h``/``swap_h2d``) and ``EngineCore``
(``cow_copy``, ``prefill_launch``, ``decode_launch``, ``sample``)
behind a no-op default -- ``injector is None`` costs nothing and, since
every site fires on the host between device launches, an *armed*
injector never changes what gets traced either.  Each site carries an
independent schedule (nth-call, every-k, seeded probability, burst) so
a soak test can replay the exact same fault pattern from a seed and
assert the engine's invariants hold under it.

    inj = FaultInjector(seed=7)
    inj.arm("swap_d2h", prob=0.2)           # seeded coin per call
    inj.arm("page_alloc", nth=(3, 9))       # exactly calls 3 and 9
    inj.arm("decode_launch", burst=(5, 2))  # calls 5 and 6
    core = EngineCore(model, params, cfg, serve, injector=inj)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------


class EngineError(RuntimeError):
    """The engine itself failed (invariant breach, unrecoverable device
    error): co-tenant state can no longer be trusted, so this propagates
    out of ``step()`` instead of being absorbed per request."""


class RequestError(RuntimeError):
    """A failure attributable to a single request.  ``step()`` turns it
    into a quarantine: the request reaches the terminal FAILED state
    with a structured error event; everything else keeps serving."""

    code = "internal"

    def __init__(self, message: str, *, request_id: Optional[int] = None):
        super().__init__(message)
        self.request_id = request_id

    @property
    def detail(self) -> str:
        return f"{self.code}: {self}"


class RequestRejected(RequestError, ValueError):
    """Submit-time rejection: the request can never fit the pool, or the
    bounded waiting queue is full under ``queue_policy="reject"``.
    Subclasses ValueError so existing submit-validation callers keep
    catching it."""

    code = "rejected"


class RequestTimeout(RequestError):
    """The request's ``deadline_ms`` expired -- shed from the queue or
    aborted mid-flight, depending on where the deadline caught it."""

    code = "timeout"


class LogitError(RequestError):
    """The request's logits came back non-finite (NaN/Inf) under
    ``ServeConfig.logit_guard="fail"``: only the offending request
    fails; co-batched rows are unaffected."""

    code = "logits"


class InjectedFault(RuntimeError):
    """Raised by an armed ``FaultInjector`` site.  Models a *transient*
    hardware/runtime fault: swap sites retry it with backoff, launch
    sites skip the launch and retry next step, per-request sites
    (page_alloc, cow_copy, sample) quarantine the request."""

    def __init__(self, site: str, call: int):
        super().__init__(f"injected fault at {site} (call {call})")
        self.site = site
        self.call = call


class SwapRestoreFailed(RuntimeError):
    """A swap-in (host->device restore) failed past its retry budget.
    The engine downgrades the resume to recompute instead of failing
    the request."""


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

SITES: Tuple[str, ...] = (
    "page_alloc",      # PagedKVCache.append about to take free pages / COW
    "swap_d2h",        # PressureManager gather_pages (swap-out DMA)
    "swap_h2d",        # PressureManager scatter_pages (swap-in DMA)
    "cow_copy",        # EngineCore copy-on-write replay on the device pools
    "prefill_launch",  # one chunked/scan prefill launch group
    "decode_launch",   # the fused decode step for all running slots
    "sample",          # per-request token sampling
    "spec_verify",     # speculative draft+verify step (falls back to K=0)
)


@dataclass
class _SiteSchedule:
    """When a site fires, as a pure function of its call counter (and a
    per-site seeded RNG for ``prob``) -- replaying the same calls under
    the same seed reproduces the same fire pattern exactly."""

    nth: frozenset = frozenset()          # 1-based call numbers that fire
    every: int = 0                        # fire every k-th call (k > 0)
    prob: float = 0.0                     # per-call seeded coin
    burst: Optional[Tuple[int, int]] = None   # (first_call, n_calls)
    times: int = -1                       # max total fires (-1 = unlimited)
    calls: int = 0
    fired: int = 0
    rng: Optional[np.random.Generator] = field(default=None, repr=False)

    def should_fire(self) -> bool:
        self.calls += 1
        if 0 <= self.times <= self.fired:
            return False
        hit = (self.calls in self.nth
               or (self.every and self.calls % self.every == 0)
               or (self.burst is not None
                   and self.burst[0] <= self.calls
                   < self.burst[0] + self.burst[1]))
        # the coin is tossed on every call (not just misses) so the fire
        # pattern depends only on the call count, never on which other
        # trigger matched first
        if self.prob > 0.0 and self.rng is not None:
            hit = bool(self.rng.random() < self.prob) or hit
        if hit:
            self.fired += 1
        return hit


class FaultInjector:
    """Seeded, deterministic fault injector over the named ``SITES``.

    ``fire(site)`` increments the site's call counter and raises
    ``InjectedFault`` when the site's schedule says so.  An un-armed
    site never fires, so a default-constructed injector is a pure
    counter (the zero-overhead / trace-neutrality contract is tested).
    ``fired_log`` records every (site, call#) that fired -- two
    injectors with equal seeds and schedules replaying the same call
    sequence produce equal logs.
    """

    SITES = SITES

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._sched: Dict[str, _SiteSchedule] = {}
        self._calls: Dict[str, int] = {s: 0 for s in SITES}
        self.fired_log: List[Tuple[str, int]] = []

    @staticmethod
    def _check_site(site: str) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; sites: {', '.join(SITES)}")

    def arm(self, site: str, *, nth: Tuple[int, ...] = (), every: int = 0,
            prob: float = 0.0, burst: Optional[Tuple[int, int]] = None,
            times: int = -1) -> "FaultInjector":
        """Arm ``site`` with a schedule.  Triggers compose (a call fires
        when any matches); ``times`` caps total fires.  Returns self so
        arms chain.  The per-site RNG seed folds the site name into the
        injector seed, so distinct sites draw independent streams and
        the whole pattern is reproducible from ``seed`` alone."""
        self._check_site(site)
        if every < 0 or prob < 0.0 or prob > 1.0:
            raise ValueError(f"bad schedule for {site}: every={every} "
                             f"prob={prob}")
        if burst is not None and (burst[0] < 1 or burst[1] < 1):
            raise ValueError(f"burst must be (first_call>=1, n>=1), "
                             f"got {burst}")
        rng = (np.random.default_rng(
            (self.seed & 0xFFFFFFFF) ^ zlib.crc32(site.encode()))
            if prob > 0.0 else None)
        self._sched[site] = _SiteSchedule(
            nth=frozenset(int(n) for n in nth), every=every, prob=prob,
            burst=burst, times=times, rng=rng)
        return self

    def fire(self, site: str) -> None:
        """Count a pass through ``site``; raise InjectedFault when its
        schedule triggers.  Sites are host-side only -- this must never
        be called from inside a traced function."""
        self._check_site(site)
        self._calls[site] += 1
        sched = self._sched.get(site)
        if sched is None:
            return
        if sched.should_fire():
            self.fired_log.append((site, self._calls[site]))
            raise InjectedFault(site, self._calls[site])

    def calls(self, site: str) -> int:
        self._check_site(site)
        return self._calls[site]

    @property
    def total_fired(self) -> int:
        return len(self.fired_log)

    def stats(self) -> dict:
        return {"calls": dict(self._calls),
                "fired": len(self.fired_log),
                "armed": sorted(self._sched)}
