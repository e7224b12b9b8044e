"""EngineCore: the persistent, iteration-level serving engine (PyTorch).

A port of the JAX package's ``serving/core.py``.  The core owns the page
manager, the scheduler, the device page pools and the model, and advances
the whole system one iteration per ``step()`` call:

    core = EngineCore(model, params, cfg, serve)      # device="cuda"
    rid = core.add_request(prompt, SamplingParams(max_new_tokens=32))
    while core.has_work:
        for ev in core.step():          # list[StreamEvent], may be empty
            ...
    core.abort(rid)                     # any time: frees pages, no leaks

One step = deadline sweep, retire finished sequences, admit waiting
requests, spend the prefill token budget on chunked prompt prefill
(``LM.prefill_chunk_paged``, jobs of distinct sequences batched into one
launch), then one fused decode step (``LM.decode_step_paged``) for every
running slot.

Sampling is per request (``SamplingParams``) with a counter-based RNG: the
n-th sampled token of a request draws from a ``torch.Generator`` seeded by
a hash of ``(seed, n)``, so sampled tokens are invariant to batch
composition and admission order (the JAX engine's ``fold_in(PRNGKey(seed),
n)`` stream cannot be replayed in PyTorch; the invariants can).

Not ported yet, and refused by the constructor with NotImplementedError:
speculative decoding, tensor parallelism, the prefix cache, the scan
prefill oracle, the fault injector, and a pool smaller than the auto size
(oversubscription needs the preemption/swap subsystem).
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.device import resolve_device
from repro_torch.serving.faults import (EngineError, LogitError,
                                        RequestError, RequestRejected,
                                        RequestTimeout)
from repro_torch.serving.metrics import (FlightRecorder, LifecycleTracer,
                                         MetricsRegistry)
from repro_torch.serving.paged_cache import OutOfPages, PagedKVCache
from repro_torch.serving.scheduler import (ABORTED, FAILED, FINISHED,
                                           PREFILLING, RUNNING,
                                           ContinuousBatchScheduler,
                                           Request, SamplingParams)

_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, n: int) -> int:
    """Seed of a request's n-th sampled token: a splitmix64 hash of
    (seed, n), so neighbouring counters give unrelated streams."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(n) + 1) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator], *,
                 temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """logits (..., V) -> int64 token ids (...)."""
    if temperature == 0.0 or top_k == 1:
        return torch.argmax(logits, dim=-1)
    lf = logits.float() / max(temperature, 1e-6)
    if top_k > 1:
        # oversized k means "no truncation" instead of a crash
        k = min(top_k, lf.shape[-1])
        thresh = torch.topk(lf, k, dim=-1).values[..., -1:]
        lf = torch.where(lf < thresh, -1e30, lf)
    probs = torch.softmax(lf, dim=-1).reshape(-1, lf.shape[-1])
    tok = torch.multinomial(probs, 1, generator=gen)
    return tok.reshape(lf.shape[:-1])


class StreamEvent(NamedTuple):
    """One stream event.  ``kind="token"`` carries one generated token,
    emitted the step it exists.  ``kind="stop"`` terminates a stop-string
    request whose matched suffix was trimmed (token is -1).
    ``kind="error"`` terminates a FAILED/timed-out request with the
    structured ``detail`` ("code: message") and token -1."""
    request_id: int
    token: int
    index: int            # position within the request's generation
    finished: bool        # True on the request's last event
    kind: str = "token"
    detail: str = ""


class _CountingDeque(deque):
    """Bounded deque that counts evictions instead of losing them
    silently: a full ``append`` still drops the oldest entry (the bound
    is the point), but ``dropped`` records how many orphaned events were
    lost so ``stats()`` can surface the loss."""

    def __init__(self, maxlen: int):
        super().__init__(maxlen=maxlen)
        self.dropped = 0

    def append(self, item) -> None:
        if self.maxlen is not None and len(self) == self.maxlen:
            self.dropped += 1
        super().append(item)


class EngineCore:
    """Persistent iteration-level engine over the paged KV cache."""

    def __init__(self, model, params: dict, cfg: ModelConfig,
                 serve: Optional[ServeConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 injector=None, detokenize=None, clock=None, metrics=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.serve = serve = serve or ServeConfig()
        self._check_supported(serve, injector)
        # None lets the attention facade pick by device (kernel on CUDA)
        self._impl = None if serve.paged_impl == "auto" else serve.paged_impl
        # token ids -> text, required only by SamplingParams.stop_strings
        self.detokenize = detokenize
        # engine clock (seconds, monotonic) for deadlines and all engine
        # timing; injectable so fake-clock tests see every timing path
        self._clock = clock or time.monotonic
        # -- telemetry (serving/metrics.py): the registry backs stats();
        # tracer and flight recorder gate on serve.metrics
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_steps = m.counter("engine_steps_total",
                                  help="engine step() iterations")
        self._c_events = m.counter("engine_events_total",
                                   help="stream events emitted")
        self._c_aborts = m.counter("engine_requests_aborted_total",
                                   help="caller aborts")
        self._c_failed = m.counter("engine_requests_failed_total",
                                   help="requests quarantined "
                                        "(internal/logits)")
        self._c_shed = m.counter("engine_requests_shed_total",
                                 help="requests shed from the bounded "
                                      "waiting queue")
        self._c_timeout = m.counter("engine_requests_timed_out_total",
                                    help="deadline_ms expiries")
        self._h_step = m.histogram("engine_step_seconds",
                                   help="step() wall-clock on the "
                                        "engine clock")
        self._g_pages = m.gauge("kv_pages_used",
                                help="physical KV pages in use")
        self._g_pages_hw = m.gauge("kv_pages_peak", high_water=True,
                                   help="peak KV pages in use "
                                        "(current window)")
        self.tracer = (LifecycleTracer(m, self._clock)
                       if serve.metrics else None)
        self.flight = (FlightRecorder(serve.flight_recorder_steps)
                       if serve.metrics else None)
        self.last_flight_dump: Optional[List[dict]] = None
        self._step_rec: Optional[dict] = None
        self._dump_pending = False
        # prefill chunk launches (calls of LM.prefill_chunk_paged)
        self.prefill_launches = 0
        self.decode_launches = 0
        self._warned_legacy_sampling = False
        self._next_id = 0
        self.reset()

    @staticmethod
    def _check_supported(serve: ServeConfig, injector) -> None:
        if serve.logit_guard not in ("fail", "ignore"):
            raise ValueError(f"unknown logit_guard {serve.logit_guard!r}")
        if serve.queue_policy not in ("reject", "shed_oldest"):
            raise ValueError(f"unknown queue_policy {serve.queue_policy!r}")
        if serve.paged_impl not in ("auto", "paged", "paged_reference"):
            raise ValueError(f"unknown paged_impl {serve.paged_impl!r}")
        if serve.prefill_mode not in ("chunked", "scan"):
            raise ValueError(f"unknown prefill_mode {serve.prefill_mode!r}")
        later = []
        if serve.spec_mode != "off":
            later.append(f"spec_mode={serve.spec_mode!r} (speculative "
                         "decoding slice)")
        if serve.tp > 1:
            later.append(f"tp={serve.tp} (tensor-parallel slice)")
        if serve.prefix_cache:
            later.append("prefix_cache=True (prefix-cache slice)")
        if serve.prefill_mode == "scan":
            later.append("prefill_mode='scan' (scan-prefill oracle)")
        if injector is not None:
            later.append("a fault injector (fault-injection slice)")
        auto = serve.max_batch * serve.max_pages_per_seq + 1
        if serve.num_pages and serve.num_pages < auto:
            later.append(f"num_pages={serve.num_pages} below the auto size "
                         f"{auto} (oversubscription needs the "
                         "preemption/swap slice)")
        if later:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(later))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Drop every request and page and rebuild the serving state from
        ``self.serve``.  Launch counters and the metrics registry survive
        -- use ``reset_metrics_window()`` to open a fresh window."""
        serve = self.serve
        self.mgr = PagedKVCache(serve.pool_pages(), serve.page_size,
                                serve.max_batch, serve.max_pages_per_seq,
                                metrics=self.metrics)
        self.sched = ContinuousBatchScheduler(
            self.mgr, serve.max_batch, admission=serve.admission,
            watermark_pages=serve.watermark, tracer=self.tracer)
        if self.tracer is not None:
            self.tracer.reset()
        self.pools = None              # device pools, materialised lazily
        self.next_tok = np.zeros((serve.max_batch,), np.int32)
        self.requests: Dict[int, Request] = {}     # live (unfinished) only
        # events a ServeEngine.generate_stream drain stepped out for
        # requests no drain owns (direct add_request users): step() hands
        # each event to exactly one caller, so mixed-mode users recover
        # them here (drops past the bound are counted, see stats())
        self.orphan_events: _CountingDeque = _CountingDeque(maxlen=4096)
        # terminal error events produced outside a step() (queue
        # shedding at submit time): the next step() returns them first
        self._pending_events: List[StreamEvent] = []
        # per-request incremental detokenisation state for stop_strings
        self._stop_state: Dict[int, dict] = {}
        self.last_error: Optional[str] = None

    # ------------------------------------------------------------------
    # registry-backed counters
    # ------------------------------------------------------------------
    @property
    def steps(self) -> int:
        return self._c_steps.window

    @property
    def events_emitted(self) -> int:
        return self._c_events.window

    @property
    def aborts(self) -> int:
        return self._c_aborts.window

    @property
    def failed_count(self) -> int:
        return self._c_failed.window

    @property
    def shed_count(self) -> int:
        return self._c_shed.window

    @property
    def timed_out_count(self) -> int:
        return self._c_timeout.window

    @property
    def step_s_high_water(self) -> float:
        return self._h_step.window_max

    def reset_metrics_window(self) -> None:
        """Open a fresh measurement window (cumulative totals survive)."""
        self.metrics.reset_window()
        if self.tracer is not None:
            self.tracer.clear_completed()
        if self.flight is not None:
            self.flight.records.clear()
        self.mgr.reset_peak()

    def export_prometheus(self) -> str:
        """Prometheus text-format (0.0.4) exposition of the registry."""
        return self.metrics.to_prometheus()

    def chrome_trace(self, records: Optional[List[dict]] = None) -> dict:
        """Chrome ``trace_event`` JSON for the flight recorder's current
        ring (or a prior ``dump()``): load the result into
        chrome://tracing or Perfetto for a step/phase timeline."""
        if self.flight is None:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        return self.flight.to_chrome_trace(records)

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    def stats(self) -> dict:
        """Point-in-time engine statistics (live objects, not a log)."""
        mgr, sched = self.mgr, self.sched
        return {
            "steps": self.steps,
            "events_emitted": self.events_emitted,
            "aborts": self.aborts,
            "waiting": len(sched.waiting),
            "active_slots": sum(1 for r in sched.slots if r is not None),
            "finished": sched.finished_count,
            "pages_used": mgr.used_pages,
            "pages_free": mgr.free_pages,
            "pages_peak": mgr.peak_used_pages,
            "peak_utilization": mgr.peak_utilization,
            "prefill_launches": self.prefill_launches,
            "decode_launches": self.decode_launches,
            "orphan_events_pending": len(self.orphan_events),
            "orphans_dropped": self.orphan_events.dropped,
            "health": {
                "failed": self.failed_count,
                "shed": self.shed_count,
                "timed_out": self.timed_out_count,
                "last_error": self.last_error,
                "step_s_high_water": self.step_s_high_water,
            },
        }

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def _resolve_sampling(self, req: Request) -> None:
        """Give a params-less request its SamplingParams from the
        deprecated engine-global knobs (warning once per core when they
        were changed from their defaults)."""
        if req.sampling is not None:
            return
        serve = self.serve
        if serve.sampling_overridden and not self._warned_legacy_sampling:
            self._warned_legacy_sampling = True
            warnings.warn(
                "engine-global ServeConfig.temperature/top_k are "
                "deprecated: pass SamplingParams per request",
                DeprecationWarning, stacklevel=4)
        req.sampling = SamplingParams(
            temperature=serve.temperature, top_k=serve.top_k,
            seed=serve.seed + int(req.id),
            max_new_tokens=req.max_new_tokens,
            stop_token_ids=(req.eos_id,) if req.eos_id is not None else ())

    def submit_request(self, req: Request) -> Request:
        """Validate and enqueue a pre-built ``Request``.  Raises
        ``RequestRejected`` (a ValueError) when the request can never fit
        the pool, needs a missing detokenizer for its stop_strings, or the
        bounded waiting queue is full under ``queue_policy="reject"``."""
        live = self.requests.get(req.id)
        if live is not None and live.state not in (FINISHED, ABORTED,
                                                   FAILED):
            raise ValueError(f"request id {req.id} is already live")
        self._resolve_sampling(req)
        if req.sampling.stop_strings and self.detokenize is None:
            raise RequestRejected(
                f"request {req.id}: stop_strings need a detokenize= "
                "callable on the engine", request_id=req.id)
        mw = self.serve.max_waiting
        if mw and len(self.sched.waiting) >= mw:
            if self.serve.queue_policy == "reject":
                raise RequestRejected(
                    f"request {req.id}: waiting queue full "
                    f"({mw} requests)", request_id=req.id)
            victim = self.sched.waiting[0]   # shed_oldest
            self._quarantine(victim, RequestRejected(
                f"request {victim.id}: shed from full waiting queue "
                f"({mw} requests) by newer arrival",
                request_id=victim.id))
        req.submit_t = self._clock()
        self.sched.submit(req)          # validates against the pool
        self.requests[req.id] = req
        if self.tracer is not None:
            self.tracer.on_submit(req)
        return req

    def add_request(self, prompt, sampling: Optional[SamplingParams] = None,
                    *, request_id: Optional[int] = None,
                    max_new_tokens: Optional[int] = None,
                    eos_id: Optional[int] = None) -> int:
        """Submit a new generation request; returns its id.  ``prompt``
        is a 1-D sequence of token ids.  Without ``sampling`` the default
        greedy ``SamplingParams()`` applies.  The request queues FIFO and
        is admitted by a later ``step()``."""
        if sampling is None:
            sampling = SamplingParams()
        rid = request_id
        if rid is None:
            while self._next_id in self.requests:
                self._next_id += 1
            rid = self._next_id
            self._next_id += 1
        req = Request(id=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_id=eos_id, sampling=sampling)
        self.submit_request(req)
        return rid

    def get_request(self, request_id: int) -> Optional[Request]:
        return self.requests.get(request_id)

    def abort(self, request_id: int) -> bool:
        """Cancel a request anywhere in its lifecycle (waiting,
        mid-prefill or mid-decode -- its slot's pages are freed).
        Returns False for an unknown or already-finished id.
        Idempotent."""
        req = self.sched.abort(request_id)
        if req is None:
            return False
        self.requests.pop(request_id, None)
        self._stop_state.pop(request_id, None)
        self._c_aborts.inc()
        if self.tracer is not None:
            self.tracer.on_abort(req)
        return True

    # ------------------------------------------------------------------
    # fault isolation
    # ------------------------------------------------------------------
    def _quarantine(self, req: Request, exc: RequestError,
                    events: Optional[List[StreamEvent]] = None) -> None:
        """Fail exactly one request in place: its slot's pages are freed
        and a terminal ``kind="error"`` event emitted -- co-tenants keep
        serving.  ``events=None`` queues the event for the next
        ``step()`` (submit-time shedding has no step underway)."""
        detail = exc.detail
        self.sched.abort(req.id)        # frees slot/pages wherever it is
        req.state = FAILED
        req.error = detail
        req.slot = None
        self.requests.pop(req.id, None)
        self._stop_state.pop(req.id, None)
        if isinstance(exc, RequestTimeout):
            self._c_timeout.inc()
            code = "timed_out"
        elif isinstance(exc, RequestRejected):
            self._c_shed.inc()
            code = "shed"
        else:
            self._c_failed.inc()
            code = "failed"
        self.last_error = f"request {req.id}: {detail}"
        if self.tracer is not None:
            self.tracer.on_fail(req, code)
        if self._step_rec is not None:
            self._step_rec["quarantined"].append(
                {"request_id": req.id, "code": code, "detail": detail})
            self._dump_pending = True
        elif self.flight is not None:
            self.last_flight_dump = self.flight.dump()
        ev = StreamEvent(req.id, -1, len(req.generated), True,
                         kind="error", detail=detail)
        (events if events is not None else self._pending_events).append(ev)

    # ------------------------------------------------------------------
    # device calls
    # ------------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill(self, buf: np.ndarray, table: np.ndarray, pos0: np.ndarray,
                 nval: np.ndarray) -> torch.Tensor:
        """One chunked-prefill launch; returns the logits of every row's
        last *valid* chunk token, (rows, V) -- padding rows attended
        through the scratch page and are garbage."""
        self.prefill_launches += 1
        logits, self.pools = self.model.prefill_chunk_paged(
            self.params, self._to_device(buf), self.pools,
            self._to_device(table), self._to_device(pos0),
            self._to_device(nval), impl=self._impl)
        last = torch.from_numpy(np.maximum(nval - 1, 0)).to(self.device)
        rows = torch.arange(len(nval), device=self.device)
        return logits[rows, last.long()]

    def _decode(self, table: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        self.decode_launches += 1
        logits, self.pools = self.model.decode_step_paged(
            self.params, self._to_device(self.next_tok), self.pools,
            self._to_device(table), self._to_device(pos), impl=self._impl)
        return logits

    # ------------------------------------------------------------------
    # sampling (per-request counter-based RNG)
    # ------------------------------------------------------------------
    def _sample(self, req: Request, logits_row: torch.Tensor) -> int:
        """Sample the request's next token from its own RNG stream:
        generator seed = stream_seed(seed, token_index).  Greedy requests
        take the argmax (no generator), so greedy output is identical
        whatever else shares the batch."""
        sp = req.sampling
        if sp.greedy:
            return int(torch.argmax(logits_row.reshape(-1)))
        gen = torch.Generator(device=logits_row.device)
        gen.manual_seed(stream_seed(sp.seed, len(req.generated)))
        tok = sample_token(logits_row.reshape(1, -1), gen,
                           temperature=sp.temperature, top_k=sp.top_k)
        return int(tok.reshape(-1)[0])

    def _guard_logits(self, req: Request, row: torch.Tensor) -> None:
        """NaN/Inf guard on one request's logits row: under
        ``logit_guard="fail"`` a non-finite row fails only the offending
        request (LogitError -> quarantine)."""
        if self.serve.logit_guard != "fail":
            return
        if not bool(torch.isfinite(row).all()):
            raise LogitError(
                f"request {req.id}: non-finite logits at token "
                f"{len(req.generated)}", request_id=req.id)

    def _first_token(self, req: Request, slot: int,
                     last_logits: torch.Tensor,
                     events: List[StreamEvent]) -> None:
        """Sample a freshly-prefilled sequence's first token and flip the
        request into the decoding state."""
        try:
            self._guard_logits(req, last_logits)
            tok = self._sample(req, last_logits)
        except RequestError as e:
            self._quarantine(req, e, events)
            return
        req.state = RUNNING
        req.generated.append(tok)
        self.next_tok[slot] = tok
        if self.tracer is not None:
            self.tracer.on_first_token(req)
            self.tracer.on_token(req)
        self._stream(req, events)

    # ------------------------------------------------------------------
    # event emission (stop-string holdback)
    # ------------------------------------------------------------------
    def _stream(self, req: Request, events: List[StreamEvent]) -> None:
        """Emit the request's not-yet-streamed generated tokens.

        Without stop_strings every new token streams immediately.  With
        stop_strings the generation is detokenised incrementally; a match
        ends the request with the matched suffix trimmed from the stream,
        and while no match exists the longest text suffix that is a
        prefix of some stop string is held back.  Held tokens flush when
        the request finishes for another reason."""
        gen = req.generated
        sp = req.sampling
        if not sp.stop_strings:
            while req.emitted < len(gen):
                i = req.emitted
                fin = req.done and i == len(gen) - 1
                events.append(StreamEvent(req.id, gen[i], i, fin))
                req.emitted += 1
            return
        st = self._stop_state.setdefault(req.id, {"text": "", "ends": []})
        for i in range(len(st["ends"]), len(gen)):
            # cumulative-prefix decode: piece i is whatever text the
            # i-th token added (robust to multi-token glyphs)
            st["text"] = self.detokenize(gen[:i + 1])
            st["ends"].append(len(st["text"]))
        text, ends = st["text"], st["ends"]
        match = -1
        for s in sp.stop_strings:
            p = text.find(s)
            if p != -1 and (match == -1 or p < match):
                match = p
        if match != -1:
            # emit tokens wholly before the match; the token containing
            # the match start is trimmed with the rest of the suffix
            safe = sum(1 for e in ends if e <= match)
            while req.emitted < safe:
                i = req.emitted
                events.append(StreamEvent(req.id, gen[i], i, False))
                req.emitted += 1
            req.stop_matched = True     # terminal: done is now True
            matched = max((s for s in sp.stop_strings
                           if text.startswith(s, match)), key=len)
            events.append(StreamEvent(req.id, -1, req.emitted, True,
                                      kind="stop", detail=matched))
            self._stop_state.pop(req.id, None)
            return
        if req.done:                    # stop token / length: flush all
            while req.emitted < len(gen):
                i = req.emitted
                events.append(StreamEvent(req.id, gen[i], i,
                                          i == len(gen) - 1))
                req.emitted += 1
            self._stop_state.pop(req.id, None)
            return
        hold = 0
        for s in sp.stop_strings:
            for k in range(min(len(s) - 1, len(text)), 0, -1):
                if text.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        safe_chars = len(text) - hold
        safe = sum(1 for e in ends if e <= safe_chars)
        while req.emitted < safe:
            i = req.emitted
            events.append(StreamEvent(req.id, gen[i], i, False))
            req.emitted += 1

    # ------------------------------------------------------------------
    # page plumbing
    # ------------------------------------------------------------------
    def _ensure_pools(self) -> None:
        if self.pools is None:
            self.pools = self.model.init_paged_cache(self.mgr.num_pages,
                                                     self.mgr.page_size)

    def _grow(self, slot: int, n: int) -> None:
        """``mgr.append(slot, n)``.  The pool has the auto size (enforced
        at construction), so every admitted sequence fits at its worst
        case and this cannot run out; reaching OutOfPages means engine
        state is inconsistent."""
        try:
            self.mgr.append(slot, n)
        except OutOfPages as e:
            raise EngineError(f"page pool exhausted growing slot {slot}: "
                              f"{e}") from e

    @staticmethod
    def _prefill_groups(jobs, width: int):
        """Pack this step's prefill jobs into batched launches: first-fit
        into the earliest group that has room and no job for the same
        slot yet (a slot's chunk k+1 must launch after its chunk k)."""
        groups: list = []
        for job in jobs:
            slot = job[0]
            for g in groups:
                if len(g) < width and all(j[0] != slot for j in g):
                    g.append(job)
                    break
            else:
                groups.append([job])
        return groups

    def _check_invariants(self) -> None:
        self.mgr.check_invariants()

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def step(self) -> List[StreamEvent]:
        """Advance the engine one iteration and return the events it
        produced (possibly none).  Event order within a step: terminal
        events queued since the last step, deadline expiries, first
        tokens of sequences whose prefill completed, then one decode
        token per running slot.  Per-request failures (non-finite logits)
        quarantine the offending request only; an ``EngineError``
        propagates out carrying the flight-recorder dump as ``.flight``."""
        t0 = self._clock()
        if self.flight is not None:
            self._step_rec = {
                "step": self._c_steps.value, "t_start": t0,
                "phases": {}, "events": 0, "quarantined": [],
            }
        err: Optional[EngineError] = None
        try:
            events = self._step()
            if self._step_rec is not None:
                self._step_rec["events"] = len(events)
            return events
        except EngineError as e:
            err = e
            raise
        finally:
            dt = self._clock() - t0
            self._h_step.observe(dt)
            self._g_pages.set(self.mgr.used_pages)
            self._g_pages_hw.set(self.mgr.used_pages)
            rec, self._step_rec = self._step_rec, None
            if rec is not None:
                rec["dur_s"] = dt
                rec["pages_used"] = self.mgr.used_pages
                if err is not None:
                    rec["error"] = str(err)
                self.flight.record(rec)
                for phase, pdt in rec["phases"].items():
                    self.metrics.observe(
                        f"engine_phase_{phase}_seconds", pdt)
                if err is not None or self._dump_pending:
                    self._dump_pending = False
                    self.last_flight_dump = self.flight.dump()
                    if err is not None:
                        err.flight = self.last_flight_dump

    def _step(self) -> List[StreamEvent]:
        events: List[StreamEvent] = self._pending_events
        self._pending_events = []
        sched, mgr, serve = self.sched, self.mgr, self.serve
        if not sched.has_work:
            return events
        self._c_steps.inc()
        rec = self._step_rec
        if rec is not None:
            # phase marks: elapsed engine-clock time since the previous
            # mark (device work is asynchronous: a phase that launches
            # kernels is charged when a later phase waits for them)
            clock = self._clock
            last_t = [clock()]

            def mark(phase: str) -> None:
                t = clock()
                ph = rec["phases"]
                ph[phase] = ph.get(phase, 0.0) + (t - last_t[0])
                last_t[0] = t
        else:
            def mark(phase: str) -> None:
                pass
        ps = mgr.page_size
        self._ensure_pools()

        # ---- deadline sweep ------------------------------------------
        now = self._clock()
        expired = [r for r in sched.waiting if r.deadline_expired(now)]
        expired += [r for _, r in sched.running()
                    if r.deadline_expired(now) and not r.done]
        for req in expired:
            self._quarantine(req, RequestTimeout(
                f"request {req.id}: deadline "
                f"{req.sampling.deadline_ms:g}ms exceeded",
                request_id=req.id), events)
        mark("deadline_sweep")

        for req in sched.retire():
            self.requests.pop(req.id, None)
        admitted = sched.admit()
        mark("schedule")
        if rec is not None:
            rec["waiting"] = len(sched.waiting)
            rec["prefilling"] = len(sched.prefilling())
            rec["decoding"] = len(sched.decoding())
        if not admitted and not sched.running():
            if not sched.waiting:
                return events           # everything retired
            # submit-time validation guarantees the head of the queue fits
            # an empty pool; reaching this means engine state is
            # inconsistent, not that one request is bad
            req = sched.waiting[0]
            raise EngineError(
                f"pool too small for request {req.id}: needs "
                f"{-(-req.target_len // ps)} pages, pool has "
                f"{mgr.num_pages - 1}")
        if serve.debug_invariants:
            self._check_invariants()

        # ---- prefill phase -------------------------------------------
        # fixed-size chunks through the full forward, jobs for distinct
        # sequences batched into one launch, padded to the next
        # power-of-two row count (padding rows: scratch table, n_valid 0)
        chunk = serve.prefill_chunk_tokens
        budget = serve.prefill_budget_tokens
        width = serve.max_batch
        for group in self._prefill_groups(
                sched.prefill_schedule(budget, chunk), width):
            live = []
            for slot, req, start, n in group:
                if sched.slots[slot] is not req or req.state != PREFILLING:
                    continue
                self._grow(slot, n)
                live.append((slot, req, start, n))
            if not live:
                continue
            bw = 1
            while bw < len(live):
                bw *= 2
            bw = min(bw, width)
            buf = np.zeros((bw, chunk), np.int32)
            table = np.full((bw, mgr.max_pages_per_seq), mgr.SCRATCH,
                            np.int32)
            pos0 = np.zeros((bw,), np.int32)
            nval = np.zeros((bw,), np.int32)
            for i, (slot, req, start, n) in enumerate(live):
                buf[i, :n] = req.prefill_tokens[start:start + n]
                table[i] = mgr.table[slot]
                pos0[i] = start
                nval[i] = n
            last_logits = self._prefill(buf, table, pos0, nval)
            for i, (slot, req, start, n) in enumerate(live):
                req.prefilled = start + n
                if req.prefill_done:
                    self._first_token(req, slot, last_logits[i:i + 1],
                                      events)
        mark("prefill")

        # ---- decode phase --------------------------------------------
        # materialise the page every running sequence's next token is
        # written to, THEN snapshot the table for the device step
        running = [(s, r) for s, r in sched.decoding() if not r.done]
        for slot, _ in running:
            self._grow(slot, 1)
        if serve.debug_invariants:
            self._check_invariants()
        if not running:
            mark("decode")
            self._c_events.inc(len(events))
            return events
        pos_np = np.zeros((serve.max_batch,), np.int32)
        for slot, _ in running:
            pos_np[slot] = mgr.seq_len(slot) - 1
        table = mgr.device_table()
        for slot, _ in sched.prefilling():
            # mid-prefill slots sit out the decode step: scratch-page
            # table row + pos 0, like idle slots (their real pages must
            # not see the decode step's writes)
            table[slot, :] = mgr.SCRATCH
        logits = self._decode(table, pos_np)
        mark("decode")
        rowok = None
        if serve.logit_guard == "fail":
            # one device-side reduction + a max_batch-bool transfer
            rowok = torch.isfinite(logits).all(dim=-1).cpu().numpy()
        if all(r.sampling.greedy for _, r in running):
            # one batched argmax for the common all-greedy step
            toks = torch.argmax(logits, dim=-1).cpu().numpy()
            picked = {slot: int(toks[slot]) for slot, _ in running}
        else:
            picked = {slot: self._sample(req, logits[slot])
                      for slot, req in running}
        mark("sample")
        for slot, req in running:
            if rowok is not None and not rowok[slot]:
                self._quarantine(req, LogitError(
                    f"request {req.id}: non-finite logits at token "
                    f"{len(req.generated)}", request_id=req.id), events)
                continue
            tok = picked[slot]
            req.generated.append(tok)
            self.next_tok[slot] = tok
            if self.tracer is not None:
                self.tracer.on_token(req)
            self._stream(req, events)
        mark("detok")
        self._c_events.inc(len(events))
        return events
