"""Engine telemetry: metrics registry, lifecycle tracing, flight recorder.

Production serving engines treat observability as a subsystem, not a
stats dict: vLLM exports Prometheus counters and per-request latency
histograms, FlashInfer feeds per-kernel attention telemetry back into
its scheduler, and the source FastAttention paper motivates both its
tiling-AllReduce and its CPU-GPU cooperative strategy with exactly the
per-phase time/bandwidth breakdowns an uninstrumented engine cannot
produce.  This module is that subsystem for the EngineCore stack --
dependency-free, host-side only (nothing here is ever traced by jit, so
telemetry can never change trace counts), and O(1) on the hot path:

* :class:`MetricsRegistry` -- named :class:`Counter`/:class:`Gauge`/
  fixed-bucket :class:`Histogram` metrics with *windowed* reads:
  cumulative totals survive for Prometheus exposition
  (:meth:`~MetricsRegistry.to_prometheus`), while ``snapshot(reset=True)``
  / :meth:`~MetricsRegistry.reset_window` give bench-style "cover only
  the timed region" semantics.  ``EngineCore.stats()`` keeps its shape
  but reads these windows.

* :class:`LifecycleTracer` -- per-request span events on the engine's
  injectable clock (submitted -> queued -> prefilling -> first-token ->
  running -> preempted/swapped/resumed -> finished/failed/shed), turning
  TTFT, TPOT, queue delay and preemption stalls into engine-native
  histograms instead of bench-side arithmetic.  Every opened span is
  closed by a terminal event (finish/fail/abort), asserted under the
  chaos soak; ``completed`` keeps a bounded log of per-request latency
  records for exact engine-vs-bench comparisons.

* :class:`FlightRecorder` -- a bounded ring buffer of per-step records
  (phase timings, batch composition, pages used, faults fired) the
  engine dumps on ``EngineError``/quarantine and exports as a Chrome
  ``trace_event`` JSON timeline (chrome://tracing / Perfetto) for
  postmortems.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LifecycleTracer", "FlightRecorder", "DEFAULT_TIME_BUCKETS"]

# Upper bucket bounds (seconds, ``le``-inclusive like Prometheus) for
# the latency histograms: 100us .. 60s, roughly log-spaced.  Chosen to
# straddle both the smoke model's ~1ms steps and real-hardware TTFTs.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _fmt(v) -> str:
    """Prometheus sample formatting: integers stay integral."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".10g")


class Counter:
    """Monotonic counter with a windowed view.  ``value`` is the
    cumulative total (Prometheus semantics: only resets with the
    registry); ``window`` counts since the last window reset -- what
    ``stats()`` and the benches report."""

    __slots__ = ("name", "help", "total", "_base")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.total = 0
        self._base = 0

    def inc(self, n: int = 1) -> None:
        self.total += n

    @property
    def value(self):
        return self.total

    @property
    def window(self):
        return self.total - self._base

    def reset_window(self) -> None:
        self._base = self.total

    def snapshot(self) -> dict:
        return {"type": "counter", "total": self.total,
                "window": self.window}


class Gauge:
    """Point-in-time value.  ``high_water=True`` makes ``set`` keep the
    window maximum instead of the last value (peak pages, slowest
    step); a window reset re-arms it at 0."""

    __slots__ = ("name", "help", "high_water", "value")

    def __init__(self, name: str, help: str = "", *,
                 high_water: bool = False):
        self.name = name
        self.help = help
        self.high_water = high_water
        self.value = 0.0

    def set(self, v) -> None:
        self.value = max(self.value, v) if self.high_water else v

    def reset_window(self) -> None:
        if self.high_water:
            self.value = 0.0

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with O(1) (``O(log n_buckets)``)
    recording.  ``buckets`` are upper bounds, ``le``-inclusive exactly
    like Prometheus (an observation equal to an edge lands in that
    edge's bucket); everything above the last edge lands in ``+Inf``.
    The whole histogram is windowed -- ``reset_window`` clears it -- and
    the cumulative total is kept separately for exposition."""

    __slots__ = ("name", "help", "edges", "counts", "count", "sum",
                 "window_min", "window_max", "total_count", "total_sum")

    def __init__(self, name: str, buckets=DEFAULT_TIME_BUCKETS,
                 help: str = ""):
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError(f"histogram {name}: need >= 1 bucket edge")
        self.name = name
        self.help = help
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)     # last = +Inf
        self.count = 0
        self.sum = 0.0
        self.window_min = float("inf")
        self.window_max = 0.0
        self.total_count = 0
        self.total_sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        self.total_count += 1
        self.total_sum += v
        if v < self.window_min:
            self.window_min = v
        if v > self.window_max:
            self.window_max = v

    def reset_window(self) -> None:
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.window_min = float("inf")
        self.window_max = 0.0

    def percentile(self, q: float) -> float:
        """Bucketed quantile over the window: the smallest bucket edge
        whose cumulative count covers ``q`` (0..100).  Coarse by design
        -- exact per-request latencies live on ``LifecycleTracer.
        completed``; this answers "which latency band" questions."""
        if not self.count:
            return 0.0
        target = (q / 100.0) * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return (self.edges[i] if i < len(self.edges)
                        else self.window_max)
        return self.window_max

    def snapshot(self) -> dict:
        buckets = {}
        cum = 0
        for i, edge in enumerate(self.edges):
            cum += self.counts[i]
            buckets[edge] = cum
        return {"type": "histogram", "count": self.count,
                "sum": self.sum, "max": self.window_max,
                "min": 0.0 if self.count == 0 else self.window_min,
                "buckets": buckets}


class MetricsRegistry:
    """Named metrics with get-or-create accessors, windowed snapshots
    and Prometheus/JSON exposition.  Creation validates the kind: one
    name is forever one metric type."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "", *,
              high_water: bool = False) -> Gauge:
        return self._get(name, Gauge, help=help, high_water=high_water)

    def histogram(self, name: str, buckets=DEFAULT_TIME_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(name, Histogram, buckets=buckets, help=help)

    # -- hot-path conveniences (resolve by name once, then hold the
    # returned object: the bound-attribute path is the O(1) contract) --
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- windows -------------------------------------------------------
    def reset_window(self) -> None:
        """Open a fresh measurement window: counters keep their
        cumulative totals but ``window`` restarts at 0, histograms and
        high-water gauges clear.  The bench warmup calls this so the
        reported metrics cover only the timed workload."""
        for m in self._metrics.values():
            m.reset_window()

    def snapshot(self, reset: bool = False) -> dict:
        """Windowed view of every metric (plain dicts, JSON-safe).
        ``reset=True`` atomically opens the next window -- successive
        snapshots then partition time, Prometheus-scrape style."""
        out = {name: self._metrics[name].snapshot()
               for name in sorted(self._metrics)}
        if reset:
            self.reset_window()
        return out

    # -- exposition ----------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) over *cumulative*
        values -- scrapers do their own windowing via rate()."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.total)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for i, edge in enumerate(m.edges):
                    cum += m.counts[i]
                    lines.append(
                        f'{name}_bucket{{le="{_fmt(edge)}"}} {cum}')
                # window counts roll into the totals at reset, so +Inf
                # must come from the cumulative track to stay monotonic
                lines.append(
                    f'{name}_bucket{{le="+Inf"}} {m.total_count}')
                lines.append(f"{name}_sum {_fmt(m.total_sum)}")
                lines.append(f"{name}_count {m.total_count}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        return self.snapshot()


# ---------------------------------------------------------------------------
# per-request lifecycle tracing
# ---------------------------------------------------------------------------

class LifecycleTracer:
    """Span accounting for every request on the engine's injectable
    clock.  The engine/scheduler/pressure hooks call the ``on_*``
    methods at state transitions; each appends a timestamped event to
    ``Request.trace`` and maintains *open spans* per request:

    ``queued``    submit -> first admission          (queue delay)
    ``prefill``   admission -> first token           (prefill residency)
    ``running``   first token -> terminal            (decode residency)
    ``preempted`` eviction -> re-admission           (preemption stall)
    ``swapped``   swap-out -> restore/drop           (host-stash residency)

    A terminal transition (finished/failed/shed/timed-out/aborted)
    closes every open span, so ``open_span_count() == 0`` after drain is
    an invariant the chaos soak asserts.  Closed spans feed the
    engine-native latency histograms; ``completed`` keeps a bounded log
    of exact per-request records (submit/first/last token timestamps)
    so benches can compare engine-native TTFT/TPOT against their own
    arithmetic without bucket quantisation."""

    COMPLETED_LOG = 4096

    def __init__(self, registry: MetricsRegistry, clock):
        self.m = registry
        self.clock = clock
        self.open: Dict[int, Dict[str, float]] = {}   # rid -> span -> t0
        self._live: Dict[int, dict] = {}              # rid -> record
        self.completed: deque = deque(maxlen=self.COMPLETED_LOG)  # repro-lint: disable=silent-drop (bounded span log; histograms keep the totals)
        h = registry.histogram
        self._h_queue = h("engine_queue_delay_seconds",
                          help="submit to first admission")
        self._h_ttft = h("engine_ttft_seconds",
                         help="submit to first streamed token")
        self._h_tpot = h("engine_tpot_seconds",
                         help="mean gap between a request's tokens")
        self._h_e2e = h("engine_e2e_seconds",
                        help="submit to terminal event")
        self._h_stall = h("engine_preempt_stall_seconds",
                          help="eviction to re-admission")

    # -- bookkeeping helpers -------------------------------------------
    def _mark(self, req, event: str, t: float) -> None:
        req.trace.append((event, t))

    def _open(self, rid: int, span: str, t: float) -> None:
        self.open.setdefault(rid, {}).setdefault(span, t)

    def _close(self, rid: int, span: str, t: float) -> Optional[float]:
        spans = self.open.get(rid)
        if spans is None or span not in spans:
            return None
        dt = t - spans.pop(span)
        if not spans:
            del self.open[rid]
        return dt

    def open_span_count(self) -> int:
        return sum(len(s) for s in self.open.values())

    def reset(self) -> None:
        """Engine state reset: every request is gone, so open spans and
        live records go with it; the completed log and the histograms
        persist (clear those with the registry window)."""
        self.open.clear()
        self._live.clear()

    def clear_completed(self) -> None:
        self.completed.clear()

    # -- transitions ---------------------------------------------------
    def on_submit(self, req) -> None:
        t = self.clock()
        self._mark(req, "submitted", t)
        self._open(req.id, "queued", t)
        self._live[req.id] = {"id": req.id, "submit_t": t,
                              "first_token_t": None, "last_token_t": None,
                              "n_tokens": 0, "preemptions": 0}
        self.m.inc("engine_requests_submitted_total")

    def on_admit(self, req, resumed: bool) -> None:
        t = self.clock()
        rec = self._live.get(req.id)
        if resumed:
            self._mark(req, "resumed", t)
            dt = self._close(req.id, "preempted", t)
            if dt is not None:
                self._h_stall.observe(dt)
        else:
            self._mark(req, "prefilling", t)
            dt = self._close(req.id, "queued", t)
            if dt is not None:
                self._h_queue.observe(dt)
        # a decode-resumed sequence goes straight back to running; a
        # fresh or recompute-resumed one re-enters the prefill span
        if rec is None or rec["first_token_t"] is None or not resumed:
            self._open(req.id, "prefill", t)

    def on_first_token(self, req) -> None:
        t = self.clock()
        self._mark(req, "first-token", t)
        self._close(req.id, "prefill", t)
        self._open(req.id, "running", t)
        rec = self._live.get(req.id)
        if rec is not None and rec["first_token_t"] is None:
            rec["first_token_t"] = t
            self._h_ttft.observe(t - rec["submit_t"])

    def on_token(self, req) -> None:
        rec = self._live.get(req.id)
        if rec is not None:
            rec["last_token_t"] = self.clock()
            rec["n_tokens"] += 1

    def on_preempt(self, req) -> None:
        t = self.clock()
        self._mark(req, f"preempted:{req.resume_kind}", t)
        # whichever residency span was open pauses here; the preempted
        # span measures the stall until re-admission
        self._close(req.id, "prefill", t)
        self._close(req.id, "running", t)
        self._open(req.id, "preempted", t)
        rec = self._live.get(req.id)
        if rec is not None:
            rec["preemptions"] += 1

    def on_swap_out(self, req) -> None:
        self._open(req.id, "swapped", self.clock())

    def on_swap_in(self, req) -> None:
        self._close(req.id, "swapped", self.clock())

    def on_swap_drop(self, rid: int) -> None:
        self._close(rid, "swapped", self.clock())

    # -- terminals (close everything, always) --------------------------
    def _finish(self, req, reason: str) -> None:
        t = self.clock()
        self._mark(req, reason, t)
        self.open.pop(req.id, None)
        rec = self._live.pop(req.id, None)
        if rec is None:
            return
        rec["end_t"] = t
        rec["reason"] = reason
        self._h_e2e.observe(t - rec["submit_t"])
        if reason == "finished" and rec["n_tokens"] > 1:
            rec["tpot_s"] = ((rec["last_token_t"] - rec["first_token_t"])
                             / (rec["n_tokens"] - 1))
            self._h_tpot.observe(rec["tpot_s"])
        self.completed.append(rec)

    def on_retire(self, req) -> None:
        self._finish(req, "finished")
        self.m.inc("engine_requests_finished_total")

    def on_fail(self, req, code: str) -> None:
        self._finish(req, code)          # "failed" | "shed" | "timed_out"

    def on_abort(self, req) -> None:
        self._finish(req, "aborted")


# ---------------------------------------------------------------------------
# step flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring buffer of per-step records for postmortems: what
    was the engine doing in the N steps before the EngineError?  Each
    record is a plain dict (step index, engine-clock start, duration,
    per-phase seconds, batch composition, pages used, faults fired,
    quarantines) so a dump is directly JSON-serialisable, and
    :meth:`to_chrome_trace` renders a dump as a Chrome ``trace_event``
    timeline (load in chrome://tracing or https://ui.perfetto.dev)."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"flight recorder needs capacity >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self.records: deque = deque(maxlen=capacity)  # repro-lint: disable=silent-drop (flight ring: overwrite-oldest is the point)
        self.dumps = 0

    def record(self, rec: dict) -> None:
        self.records.append(rec)

    def dump(self) -> List[dict]:
        self.dumps += 1
        return list(self.records)

    def to_chrome_trace(self, records: Optional[List[dict]] = None) -> dict:
        """Chrome ``trace_event`` JSON for a dump (default: the live
        buffer, without counting a dump).  Steps are complete ("X")
        events on tid 0, their phase breakdown laid out sequentially on
        tid 1 (phase *durations* are exact; their offsets within the
        step are reconstructed in recorded order), and quarantines /
        errors are instant ("i") events."""
        if records is None:
            records = list(self.records)
        events: List[dict] = []
        pid = 0
        for rec in records:
            ts = rec["t_start"] * 1e6            # trace_event wants us
            dur = max(rec.get("dur_s", 0.0), 0.0) * 1e6
            args = {k: rec[k] for k in
                    ("waiting", "resuming", "prefilling", "decoding",
                     "pages_used", "events", "faults_fired")
                    if k in rec}
            events.append({"name": f"step {rec['step']}", "ph": "X",
                           "ts": ts, "dur": dur, "pid": pid, "tid": 0,
                           "cat": "step", "args": args})
            off = ts
            for phase, dt in rec.get("phases", {}).items():
                pdur = max(dt, 0.0) * 1e6
                events.append({"name": phase, "ph": "X", "ts": off,
                               "dur": pdur, "pid": pid, "tid": 1,
                               "cat": "phase"})
                off += pdur
            for detail in rec.get("quarantined", ()):
                events.append({"name": "quarantine", "ph": "i", "ts": ts,
                               "pid": pid, "tid": 0, "s": "t",
                               "cat": "fault", "args": {"detail": detail}})
            if rec.get("error"):
                events.append({"name": "engine-error", "ph": "i",
                               "ts": ts + dur, "pid": pid, "tid": 0,
                               "s": "t", "cat": "fault",
                               "args": {"detail": rec["error"]}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}
