"""Continuous-batching scheduler over the paged KV cache.

FlashInfer/vLLM-style iteration-level scheduling: a fixed grid of decode
slots (``max_batch``) is refilled from a FIFO waiting queue every step --
sequences retire individually the moment they finish, their pages go back
to the free list, and the freed slot admits the next waiting request.
The whole batch never waits for its slowest member.

Admission is *optimistic* by default: a request is admitted as soon as
its prompt fits beside a small ``watermark_pages`` reserve -- worst-case
decode growth is NOT reserved up front (a slot that will generate 10
tokens no longer pins pages for ``max_new_tokens``).  When the pool does
run dry mid-step, the page-pressure subsystem (``serving/pressure.py``)
preempts the newest-admitted sequence(s): their pages are released and
their KV is either swapped to a host page pool or recomputed on resume.
Preempted requests wait in a ``resuming`` queue that ``admit`` serves
ahead of fresh arrivals, oldest arrival first (FIFO fairness).  The PR 1
worst-case-reservation policy survives as ``admission="reserved"`` --
deadlock-free without preemption, but chronically under-subscribed; the
over-subscription bench reports both.

Prefill is a first-class scheduler state (Sarathi-style chunked prefill):
an admitted request is PREFILLING until its whole prompt has been pushed
through the model in ``prefill_chunk``-token chunks; ``prefill_schedule``
plans each engine step's chunk work under a token budget so a long
newcomer prompt never stalls the decode latency of running sequences.
After a preemption the prefill source is the prompt *plus* every already
generated token except the last (``Request.prefill_tokens``), so a
recompute-resumed sequence rebuilds exactly the KV it lost.

With a ``RadixPrefixIndex`` attached (``ServeConfig.prefix_cache``),
admission first matches the request's tokens against the index: the
longest page-aligned cached prefix is *shared* -- the slot's page-table
row points at the already-resident physical pages
(``PagedKVCache.share_pages``) and chunked prefill starts at
``pos_start = matched_len``, skipping the matched prefix's attention
launches entirely.  A full-prompt hit keeps every page shared and
recomputes exactly one token (the last, whose logits seed sampling);
its write copy-on-writes the shared tail page.  ``retire`` closes the
loop by publishing the finished sequence's full prefix blocks back into
the index, so the pages outlive the slot until LRU eviction reclaims
them under pool pressure.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.faults import InjectedFault, RequestRejected
from repro_torch.serving.paged_cache import (OutOfPages, PagedKVCache,
                                       pages_needed)

WAITING, PREFILLING, RUNNING, PREEMPTED, FINISHED, ABORTED, FAILED = (
    "WAITING", "PREFILLING", "RUNNING", "PREEMPTED", "FINISHED", "ABORTED",
    "FAILED")


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls, carried on the ``Request``.

    Frozen/hashable so a request's sampling behaviour is fixed at submit
    time.  ``seed`` feeds a counter-based RNG stream: the key for the
    request's n-th sampled token is ``fold_in(PRNGKey(seed), n)``, so
    sampled tokens are invariant to batch composition, co-tenants,
    preemption and admission order.  The default is greedy
    (``temperature == 0``) -- the sane serving default; pass a positive
    temperature (and usually a distinct seed) to sample.
    """
    temperature: float = 0.0
    top_k: int = 0                     # 0 = no truncation
    seed: int = 0
    max_new_tokens: int = 16
    # generation stops the step after any of these token ids is emitted
    # (the stop token itself is the request's last token, like eos was)
    stop_token_ids: Tuple[int, ...] = ()
    # generation stops when any of these strings appears in the decoded
    # text of the generated tokens; the matched suffix is trimmed from
    # the emitted stream (tokens that could extend into a stop string
    # are held back until disambiguated).  Requires the engine to have a
    # ``detokenize`` callable.
    stop_strings: Tuple[str, ...] = ()
    # wall-clock deadline relative to submit time, in milliseconds.
    # Expired waiting requests are shed (structured timeout error);
    # expired running requests are aborted cleanly.  None = no deadline.
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens} "
                "(prefill always emits one token)")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {self.deadline_ms}")
        # normalise any iterable (set, list, ndarray) to a sorted tuple
        # so params stay hashable and comparisons are order-independent
        object.__setattr__(
            self, "stop_token_ids",
            tuple(sorted({int(t) for t in self.stop_token_ids})))
        strings = tuple(dict.fromkeys(str(s) for s in self.stop_strings))
        if any(not s for s in strings):
            raise ValueError("stop_strings must be non-empty strings")
        object.__setattr__(self, "stop_strings", strings)

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0 or self.top_k == 1

    def with_stop(self, eos_id: int) -> "SamplingParams":
        if eos_id in self.stop_token_ids:
            return self
        return dataclasses.replace(
            self, stop_token_ids=self.stop_token_ids + (int(eos_id),))


@dataclass
class Request:
    """One generation request flowing through the engine.

    ``sampling`` is the authority for generation length, stop tokens and
    the sampling distribution.  ``max_new_tokens=`` / ``eos_id=`` remain
    as constructor aliases: without an explicit ``SamplingParams`` they
    build one at resolve time (the engine core fills temperature/top_k
    from the deprecated engine-global ``ServeConfig`` knobs); alongside
    one they override/extend it.
    """
    id: int
    prompt: np.ndarray                 # (S,) int32 token ids
    max_new_tokens: Optional[int] = None
    eos_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    state: str = WAITING
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    prefilled: int = 0                 # prefill tokens already in the cache
    # -- page-pressure bookkeeping -------------------------------------
    arrival: int = -1                  # submit order (scheduler-assigned)
    resume_kind: Optional[str] = None  # "swap" | "recompute" after preempt
    resume_len: int = 0                # materialised KV tokens at preempt
    preemptions: int = 0               # times this request was evicted
    # -- prefix-cache bookkeeping --------------------------------------
    matched_len: int = 0               # cached tokens shared at admission
    resume_shared_len: int = 0         # shared-prefix tokens at swap-preempt
    # -- fault-tolerance bookkeeping -----------------------------------
    submit_t: float = 0.0              # engine clock at submit (deadlines)
    error: Optional[str] = None        # structured detail when FAILED
    # -- stop-string bookkeeping ---------------------------------------
    emitted: int = 0                   # generated tokens already streamed
    stop_matched: bool = False         # a stop string fired (terminal)
    # -- telemetry (serving/metrics.py) --------------------------------
    # timestamped lifecycle events on the engine clock, appended by the
    # LifecycleTracer at every state transition: ("submitted", t),
    # ("prefilling", t), ("first-token", t), ("preempted:swap", t), ...
    trace: List[Tuple[str, float]] = field(default_factory=list)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if self.sampling is not None:
            # fold the constructor aliases into the params: an explicit
            # max_new_tokens= wins, an eos_id= joins the stop set
            sp = self.sampling
            if self.max_new_tokens is not None \
                    and self.max_new_tokens != sp.max_new_tokens:
                sp = dataclasses.replace(
                    sp, max_new_tokens=self.max_new_tokens)
            if self.eos_id is not None:
                sp = sp.with_stop(self.eos_id)
            self.sampling = sp
            self.max_new_tokens = sp.max_new_tokens
        elif self.max_new_tokens is None:
            raise ValueError(
                f"request {self.id}: pass max_new_tokens= or sampling=")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens} "
                "(prefill always emits one token)")

    @property
    def stop_token_ids(self) -> Tuple[int, ...]:
        """Stop set: the sampling params' when resolved, else the legacy
        eos alias (a pre-resolution ``done`` check still honours it)."""
        if self.sampling is not None:
            return self.sampling.stop_token_ids
        return (self.eos_id,) if self.eos_id is not None else ()

    @property
    def target_len(self) -> int:
        """Worst-case cache length: prompt + every new token's KV."""
        return len(self.prompt) + self.max_new_tokens

    @property
    def prefill_tokens(self) -> np.ndarray:
        """Token source for (re)prefill: the prompt, plus -- after a
        preemption of a decoding sequence -- every generated token except
        the last, whose KV is rebuilt by its own next decode step."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated[:-1], np.int32)])

    @property
    def prefill_total(self) -> int:
        """Tokens (re)prefill must materialise before decode resumes.
        Only meaningful while PREFILLING/PREEMPTED -- for a sequence that
        is decoding it grows with ``generated`` and must not be read."""
        return len(self.prompt) + max(0, len(self.generated) - 1)

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prefill_total

    @property
    def done(self) -> bool:
        if self.stop_matched:
            return True
        if len(self.generated) >= self.max_new_tokens:
            return True
        stop = self.stop_token_ids
        return bool(stop and self.generated
                    and self.generated[-1] in stop)

    def deadline_expired(self, now: float) -> bool:
        """True when the request carries a deadline and ``now`` (engine
        clock, same units as ``submit_t``) is past it."""
        dl = self.sampling.deadline_ms if self.sampling is not None else None
        return dl is not None and (now - self.submit_t) * 1e3 > dl


class ContinuousBatchScheduler:
    """Admits waiting/resuming requests into free decode slots, schedules
    chunked prefill under a token budget, retires finished sequences,
    reclaims their pages, and picks preemption victims under pressure."""

    def __init__(self, cache: PagedKVCache, max_slots: Optional[int] = None,
                 *, admission: str = "optimistic", watermark_pages: int = 1,
                 prefix_cache=None, tracer=None):
        if admission not in ("optimistic", "reserved"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.cache = cache
        # LifecycleTracer (serving/metrics.py) or None: the scheduler
        # owns the admit/preempt/retire transitions, so it reports them;
        # terminal abort/fail spans are the engine core's to close (it
        # alone can tell an abort from a quarantine)
        self.tracer = tracer
        self.max_slots = max_slots or cache.max_slots
        assert self.max_slots <= cache.max_slots
        self.admission = admission
        self.watermark_pages = watermark_pages
        self.prefix_cache = prefix_cache    # RadixPrefixIndex or None
        self.waiting: deque = deque()
        self.resuming: deque = deque()      # preempted, FIFO by arrival
        self.slots: List[Optional[Request]] = [None] * self.max_slots
        # recently retired requests, for introspection.  Bounded: the
        # scheduler now lives on a persistent core, so an unbounded list
        # would grow with every request ever served; ``finished_count``
        # is the monotonic total.
        self.finished: deque = deque(maxlen=4096)  # repro-lint: disable=silent-drop (debug log; finished_count is the monotonic total)
        self.finished_count = 0
        self.preempt_count = 0
        self._admit_seq = 0
        self._admitted_at: dict = {}        # id -> admission sequence no.
        self._arrival_seq = 0

    # -- queue ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Validate and enqueue.  A request that can never fit -- its
        worst case exceeds max_seq_len or the whole pool -- is rejected
        *here*, with a structured ``RequestRejected`` (a ValueError
        subclass), instead of poisoning a later ``step()``."""
        if req.state != WAITING:
            raise ValueError(f"request {req.id} already {req.state}")
        worst = pages_needed(0, req.target_len, self.cache.page_size)
        if worst > self.cache.max_pages_per_seq:
            raise RequestRejected(
                f"request {req.id}: target_len {req.target_len} exceeds "
                f"max_seq_len "
                f"{self.cache.max_pages_per_seq * self.cache.page_size}",
                request_id=req.id)
        if worst > self.cache.num_pages - 1:
            raise RequestRejected(
                f"request {req.id}: needs {worst} pages, pool has "
                f"{self.cache.num_pages - 1}", request_id=req.id)
        req.arrival = self._arrival_seq
        self._arrival_seq += 1
        self.waiting.append(req)

    # -- step phases -----------------------------------------------------
    def _reserved_pages(self) -> int:
        """Worst-case future page demand of everything running (only the
        ``admission="reserved"`` baseline gates on this)."""
        return sum(
            pages_needed(self.cache.seq_len(req.slot), req.target_len,
                         self.cache.page_size)
            for req in self.slots if req is not None)

    def _publish_prefix(self, slot: int, req: Request) -> None:
        """Insert a retiring sequence's full prefix blocks into the
        prefix index so its pages stay resident for future requests.
        Materialised KV covers ``prompt + generated[:-1]`` (the last
        sampled token's KV was never written)."""
        toks = req.prefill_tokens
        n = min(len(toks), self.cache.seq_len(slot))
        blocks = n // self.cache.page_size
        if blocks:
            self.prefix_cache.insert(
                toks[:blocks * self.cache.page_size],
                self.cache.owned_pages(slot)[:blocks])

    def retire(self) -> List[Request]:
        """Retire finished sequences: free their pages and slots (full
        prefix blocks are first published into the prefix index when one
        is attached)."""
        retired = []
        for slot, req in enumerate(self.slots):
            if req is not None and req.done:
                if self.prefix_cache is not None:
                    self._publish_prefix(slot, req)
                self.cache.free(slot)
                req.state = FINISHED
                req.slot = None
                self.slots[slot] = None
                self._admitted_at.pop(req.id, None)
                self.finished.append(req)
                self.finished_count += 1
                if self.tracer is not None:
                    self.tracer.on_retire(req)
                retired.append(req)
        return retired

    def _match_prefix(self, req: Request) -> Tuple[List[int], int]:
        """Longest usable cached prefix for a (re)prefill: whole pages
        only, capped so at least one token is left to compute -- the
        final chunk's logits seed the first sampled token.  A full
        page-aligned hit keeps *all* its pages shared and recomputes
        exactly the last token (whose write copy-on-writes the shared
        tail page)."""
        pages, m = self.prefix_cache.match(req.prefill_tokens,
                                           record=False)
        total = req.prefill_total
        if m >= total:            # full hit (match never exceeds total)
            return pages, total - 1
        return pages[:m // self.cache.page_size], m

    def _resolve_sharing(self, req: Request, resumed: bool):
        """Plan a candidate admission's page sharing: returns
        ``(shared_pages, shared_len, swap_resume)``.  A swap-resumed
        request must re-find its exact preemption-time shared prefix
        (the host stash only covers the exclusive suffix); if the index
        evicted it meanwhile, the resume downgrades to recompute --
        which then prefix-matches like any fresh request."""
        swap_resume = bool(resumed and req.resume_kind == "swap"
                           and req.resume_len)
        if swap_resume and req.resume_shared_len:
            pages, m = self.prefix_cache.match(req.prefill_tokens,
                                               record=False)
            k = req.resume_shared_len
            if m >= k:
                return pages[:k // self.cache.page_size], k, True
            req.resume_kind = "recompute"
            req.resume_shared_len = 0
            swap_resume = False
        if swap_resume or self.prefix_cache is None:
            return [], 0, swap_resume
        pages, m = self._match_prefix(req)
        return pages, m, False

    def _admission_need(self, req: Request, swap_resume: bool,
                        shared_len: int) -> int:
        """Free pages admission must see available, net of the shared
        prefix.  Optimistic: what the (re)prefill will materialise --
        decode growth is preemption's problem.  Reserved: the full worst
        case.  A shared partial tail page (full-prompt hit) costs one
        extra page for its copy-on-write copy."""
        ps = self.cache.page_size
        if self.admission == "reserved":
            shared = -(-shared_len // ps) if shared_len else 0
            need = max(0, pages_needed(0, req.target_len, ps) - shared)
        else:
            n = req.resume_len if swap_resume else req.prefill_total
            need = pages_needed(shared_len, n, ps)
        if shared_len % ps:
            need += 1
        return need

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots, resuming queue first (a preempted request
        goes ahead of every fresh arrival), then waiting -- both FIFO, no
        skipping: a large head-of-line request blocks rather than
        starves.  Fresh and recompute-resumed requests enter PREFILLING
        -- with the longest cached page-aligned prefix shared into their
        page-table row and ``prefilled`` advanced past it; a swap-resumed
        request re-shares its preemption-time prefix and gets its
        exclusive pages re-materialised here, rejoining in its
        pre-preemption state once the engine copies its host KV back.
        When free pages run short, LRU leaves of the prefix index are
        evicted (and the match re-planned) before giving up."""
        admitted: List[Tuple[int, Request]] = []
        promised = 0                 # pages admitted but not yet allocated
        # snapshot BEFORE admitting: requests admitted this round land in
        # self.slots and would otherwise be counted again via promised
        reserved0 = (self._reserved_pages()
                     if self.admission == "reserved" else 0)
        for slot in range(self.max_slots):
            if self.slots[slot] is not None:
                continue
            if self.resuming:
                req, resumed = self.resuming[0], True
            elif self.waiting:
                req, resumed = self.waiting[0], False
            else:
                break
            while True:
                shared_pages, shared_len, swap_resume = \
                    self._resolve_sharing(req, resumed)
                need = self._admission_need(req, swap_resume, shared_len)
                if self.admission == "reserved":
                    headroom = self.cache.free_pages - reserved0 - promised
                else:
                    # watermark reserve -- waived while the grid is empty
                    # so a lone request can always make progress
                    occupied = promised or admitted or any(
                        r is not None for r in self.slots)
                    water = self.watermark_pages if occupied else 0
                    headroom = self.cache.free_pages - promised - water
                if need <= headroom or self.prefix_cache is None:
                    break
                # free list short: reclaim LRU leaves from the prefix
                # index, then re-plan (the evicted pages may have been
                # part of this very match)
                if self.prefix_cache.evict(need - headroom) == 0:
                    break
            if need > headroom:
                break
            (self.resuming if resumed else self.waiting).popleft()
            if swap_resume:
                # swap-in: re-share the surviving prefix, materialise
                # pages for the exclusive suffix; the engine scatters the
                # host-stashed KV into them right after admit()
                self.cache.alloc(slot)
                if shared_len:
                    self.cache.share_pages(slot, shared_pages, shared_len)
                try:
                    self.cache.append(slot, req.resume_len - shared_len)
                except OutOfPages:
                    self.cache.free(slot)
                    raise
                except InjectedFault:
                    # transient allocation fault: unwind this admission
                    # completely (slot freed, request back at the head of
                    # the resuming queue, still PREEMPTED with its stash
                    # intact) and stop admitting this step -- the resume
                    # simply retries next step
                    self.cache.free(slot)
                    self.resuming.appendleft(req)
                    break
                req.prefilled = req.resume_len
                req.state = RUNNING if (req.generated and req.prefill_done) \
                    else PREFILLING
            else:
                self.cache.alloc(slot)
                if shared_len:
                    self.cache.share_pages(slot, shared_pages, shared_len)
                if self.prefix_cache is not None:
                    self.prefix_cache.record_match(shared_len)
                req.prefilled = shared_len
                req.matched_len = shared_len
                req.state = PREFILLING
                promised += need
            req.slot = slot
            self.slots[slot] = req
            self._admitted_at[req.id] = self._admit_seq
            self._admit_seq += 1
            admitted.append((slot, req))
            if self.tracer is not None:
                self.tracer.on_admit(req, resumed)
        return admitted

    # -- preemption (page pressure) --------------------------------------
    def preemption_victim(self, protect: Optional[int] = None
                          ) -> Optional[int]:
        """Newest-admitted occupied slot, excluding ``protect`` (the slot
        whose growth triggered the pressure).  Newest-first keeps the
        oldest sequence always progressing -- the liveness argument."""
        cands = [(self._admitted_at[r.id], s)
                 for s, r in enumerate(self.slots)
                 if r is not None and s != protect]
        return max(cands)[1] if cands else None

    def preempt(self, slot: int) -> Request:
        """Evict the sequence in ``slot``: release its pages and park it
        on the resuming queue (kept sorted by arrival so the earliest
        submitted victim resumes first).  The caller (PressureManager)
        must have copied any KV worth keeping off the device and set
        ``resume_kind``/``resume_len`` BEFORE this call."""
        req = self.slots[slot]
        if req is None or req.state not in (PREFILLING, RUNNING):
            raise ValueError(f"slot {slot} not preemptible")
        self.cache.release_pages(slot)
        req.state = PREEMPTED
        req.slot = None
        req.preemptions += 1
        self.slots[slot] = None
        self._admitted_at.pop(req.id, None)
        idx = sum(1 for r in self.resuming if r.arrival < req.arrival)
        self.resuming.insert(idx, req)
        self.preempt_count += 1
        if self.tracer is not None:
            # resume_kind was set by the PressureManager before this call,
            # so the trace event carries the real resume strategy
            self.tracer.on_preempt(req)
        return req

    # -- abort ------------------------------------------------------------
    def abort(self, request_id: int) -> Optional[Request]:
        """Cancel a request wherever it currently lives.  Queued requests
        are simply removed; an occupied slot is freed -- shared pages
        drop one reference (never freed from under a sharer or the
        prefix index), exclusive pages return to the free list, and any
        pending copy-on-write debt whose destination page just became
        free is cancelled (the copy target may be reallocated to another
        sequence at any moment).  Returns the request, or None when the
        id is unknown/already finished.  A host-side swap stash is the
        PressureManager's to drop -- the engine core handles that."""
        for q in (self.waiting, self.resuming):
            for req in q:
                if req.id == request_id:
                    q.remove(req)
                    req.state = ABORTED
                    return req
        for slot, req in enumerate(self.slots):
            if req is None or req.id != request_id:
                continue
            pages = self.cache.owned_pages(slot)
            self.cache.free(slot)
            freed = {p for p in pages if self.cache.refcount(p) == 0}
            if freed and self.cache.cow_pending:
                self.cache.cow_pending = [
                    (s, d) for s, d in self.cache.cow_pending
                    if d not in freed]
            req.state = ABORTED
            req.slot = None
            self.slots[slot] = None
            self._admitted_at.pop(req.id, None)
            return req
        return None

    def prefill_schedule(self, budget: int,
                         chunk: int) -> List[Tuple[int, Request, int, int]]:
        """Plan this step's chunked-prefill work: ``(slot, req, start,
        n_tokens)`` jobs in admission order.  ``budget`` is a soft cap
        rounded up to whole chunks (chunks are fixed-cost launches, so
        sub-chunk budgeting buys nothing): planning stops at the first
        chunk boundary at or past it, overshooting by at most
        ``chunk - 1`` tokens.  Always emits at least one chunk when
        anything is PREFILLING (a zero/tiny budget must not starve
        prefill), and completes oldest prompts first so their first
        token streams out as early as possible."""
        jobs: List[Tuple[int, Request, int, int]] = []
        spent = 0
        for slot, req in self.prefilling():
            start = req.prefilled
            total = req.prefill_total
            while start < total:
                if jobs and spent >= budget:
                    return jobs
                n = min(chunk, total - start)
                jobs.append((slot, req, start, n))
                start += n
                spent += n
        return jobs

    # -- introspection ----------------------------------------------------
    def running(self) -> List[Tuple[int, Request]]:
        """All occupied slots (prefilling or decoding)."""
        return [(s, r) for s, r in enumerate(self.slots) if r is not None]

    def prefilling(self) -> List[Tuple[int, Request]]:
        """Slots still pushing prompt chunks, oldest admission first."""
        return sorted(
            ((s, r) for s, r in enumerate(self.slots)
             if r is not None and r.state == PREFILLING),
            key=lambda sr: self._admitted_at.get(sr[1].id, 0))

    def decoding(self) -> List[Tuple[int, Request]]:
        """Slots with a fully-prefilled sequence producing tokens."""
        return [(s, r) for s, r in enumerate(self.slots)
                if r is not None and r.state == RUNNING]

    @property
    def has_work(self) -> bool:
        return (bool(self.waiting) or bool(self.resuming)
                or any(r is not None for r in self.slots))
