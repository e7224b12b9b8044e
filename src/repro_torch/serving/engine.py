"""Serving engine: dense prefill+decode, and the paged streaming shim.

The port of the JAX package's ``serving/engine.py``.  The dense path
(``prefill``/``generate``) teacher-forces the prompt through
``LM.decode_step`` one position at a time, against dense per-layer KV
caches written in place (the decode attention is the CUDA ``flash_decode``
kernel on the card); it is the oracle the paged path is tested against.

``generate_stream`` is the compatibility wrapper over the persistent
paged ``EngineCore`` (``ServeEngine.core``): it submits a batch of
requests, drains ``step()`` while any of them is live and aborts the
leftovers when the caller abandons the stream.  New code should drive
``ServeEngine.core`` (or an ``EngineCore`` directly) and pass
``SamplingParams`` per request.

Differences from the JAX engine: its jit artefacts (``_paged_fn_cache``,
``prefill_trace_count``) have no counterpart in eager PyTorch and are
dropped; ``generate`` draws from a ``torch.Generator`` seeded with
``serve.seed`` (greedy tokens equal JAX's, sampled ones cannot) and
``generate_stream`` takes no JAX key.  ``offload`` must be None: the JAX
engine stores it and never reads it, so the dense path here would keep
every layer's KV on the device whatever engine is passed, and the port
refuses it rather than ignore it.  ``injector`` must be None: the port's
``EngineCore`` refuses a fault injector.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

import torch

from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.core.offload import HostOffloadEngine
from repro_torch.device import synchronize
from repro_torch.serving.core import EngineCore, sample_token
from repro_torch.serving.scheduler import ABORTED, FAILED, FINISHED, Request

_TERMINAL = (FINISHED, ABORTED, FAILED)


class _StreamDrain:
    """Iterator over one generate_stream call's events.  A plain
    generator's ``finally`` never runs when the generator is dropped
    before its first ``next()`` -- but this call's requests are already
    queued on the persistent core and its routing entry registered, so
    cleanup (unregister, abort leftovers) must run regardless.  This
    wrapper guarantees it via ``close()``/``__del__``."""

    def __init__(self, gen, cleanup):
        self._gen = gen
        self._cleanup = cleanup

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        try:
            self._gen.close()
        finally:
            self._cleanup()

    def __del__(self):
        self.close()


@dataclass
class ServeEngine:
    model: object
    params: dict
    cfg: ModelConfig
    serve: ServeConfig = field(default_factory=ServeConfig)
    # must stay None: no decode path reads host KV yet
    offload: Optional[HostOffloadEngine] = None
    # token-ids -> text callable, forwarded to the core; required only
    # when requests carry SamplingParams.stop_strings
    detokenize: Optional[object] = None
    # must stay None: the port's EngineCore refuses a fault injector
    injector: Optional[object] = None
    _core: Optional[EngineCore] = field(default=None, repr=False)
    # live generate_stream drains: (id set, event buffer) per call, so
    # interleaved streams on the one shared core route -- not drop --
    # each other's tokens
    _stream_subs: list = field(default_factory=list, repr=False)
    # injectable clock shared with the core: both the wrapper's measured
    # durations (throughput_tokens_per_s) and EngineCore._clock read it
    clock: Optional[object] = None

    def __post_init__(self):
        if self.offload is not None:
            raise NotImplementedError(
                "ServeEngine(offload=...): the dense decode path keeps every "
                "layer's KV on the device; drive the HostOffloadEngine "
                "directly")
        self._clock = self.clock or time.monotonic
        self.device = self.model.device

    # ------------------------------------------------------------------
    # the persistent core (paged serving state lives there)
    # ------------------------------------------------------------------
    @property
    def core(self) -> EngineCore:
        """The engine's persistent ``EngineCore`` (created on first use),
        on the model's device."""
        if self._core is None:
            self._core = EngineCore(self.model, self.params, self.cfg,
                                    self.serve, device=self.device,
                                    detokenize=self.detokenize,
                                    injector=self.injector,
                                    clock=self._clock)
        return self._core

    # observability aliases of the JAX engine that exist on the port's
    # core (the pressure manager and prefix index are not ported)
    @property
    def last_cache(self):
        return self.core.mgr

    @property
    def last_scheduler(self):
        return self.core.sched

    @property
    def metrics(self):
        """The core's MetricsRegistry (serving/metrics.py)."""
        return self.core.metrics

    @property
    def prefill_launches(self) -> int:
        return self.core.prefill_launches

    @prefill_launches.setter
    def prefill_launches(self, value: int) -> None:
        self.core.prefill_launches = value

    # ------------------------------------------------------------------
    # dense (static-batch) path
    # ------------------------------------------------------------------
    def _decode(self, tok: torch.Tensor, cache, pos: int):
        return self.model.decode_step(self.params, tok, cache, pos)

    def prefill(self, tokens):
        """tokens: (B, S_prompt) ints (tensor or array).  Teacher-forces
        the prompt one position at a time.  Returns (cache, last_logits)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        cache = self.model.init_cache(b, self.serve.max_seq_len)
        logits = None
        for t in range(s):
            logits, cache = self._decode(tokens[:, t], cache, t)
        return cache, logits

    def generate(self, tokens, n_new: int,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy/top-k generation.  Returns (B, n_new) int64 tokens.
        Sampling draws from ``gen`` (default: a generator on the model's
        device seeded with ``serve.seed``)."""
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.serve.seed)
        tokens = torch.as_tensor(tokens, device=self.device)
        s = tokens.shape[1]
        cache, logits = self.prefill(tokens)
        kw = dict(temperature=self.serve.temperature, top_k=self.serve.top_k)
        tok = sample_token(logits, gen, **kw)
        out = [tok]
        for i in range(1, n_new):
            logits, cache = self._decode(tok, cache, s + i - 1)
            tok = sample_token(logits, gen, **kw)
            out.append(tok)
        return torch.stack(out, dim=1)

    # ------------------------------------------------------------------
    # paged KV + continuous batching (compatibility shim over EngineCore)
    # ------------------------------------------------------------------
    def generate_stream(self, requests: Iterable[Request]):
        """Continuous-batching generation over the persistent core.

        Submits ``requests`` (scheduler.Request objects -- any number,
        they queue) to ``self.core`` and yields
        StreamEvent(request_id, token, index, finished) as ``step()``
        produces tokens, until every submitted request finished or
        aborted.  Abandoning the stream aborts this call's live requests
        -- their pages are freed and the core keeps serving.
        """
        core = self.core
        # submit (and validate) eagerly, at the call site: the drain loop
        # is a generator and would otherwise defer errors to first next().
        # On a mid-batch failure, un-queue this call's earlier submissions
        # -- the core persists, a rejected batch must not leave strays.
        submitted = []
        try:
            for r in requests:
                submitted.append(core.submit_request(r))
        except Exception:
            for r in submitted:
                core.abort(r.id)
            raise

        buf: deque = deque()
        sub = ({r.id for r in submitted}, buf)
        subs = self._stream_subs
        # register eagerly: interleaved drains on the one shared core may
        # step out this call's tokens before its generator is first
        # advanced -- they must land in this buffer, in production order
        subs.append(sub)

        def dispatch(events):
            # route every stepped event to its call's buffer; events of
            # requests no drain owns (direct add_request users) are
            # recoverable from core.orphan_events
            for ev in events:
                for other_ids, other_buf in subs:
                    if ev.request_id in other_ids:
                        other_buf.append(ev)
                        break
                else:
                    core.orphan_events.append(ev)

        cleaned = False

        def cleanup():
            nonlocal cleaned
            if cleaned:
                return
            cleaned = True
            subs.remove(sub)
            for r in submitted:
                if r.state not in _TERMINAL:
                    core.abort(r.id)

        def drain():
            try:
                while True:
                    while buf:          # may refill while we yield
                        yield buf.popleft()
                    if all(r.state in _TERMINAL for r in submitted):
                        break
                    dispatch(core.step())
                while buf:
                    yield buf.popleft()
            finally:
                cleanup()

        return _StreamDrain(drain(), cleanup)

    def throughput_tokens_per_s(self, batch: int, prompt_len: int,
                                n_new: int = 8) -> float:
        """Measured dense decode throughput (benchmark helper): ``n_new``
        decode steps of ``batch`` rows after a prompt of zeros and one
        warm-up step.  Durations are read off the engine's injectable
        clock, with the device synchronised at both ends."""
        tokens = torch.zeros((batch, prompt_len), dtype=torch.int32,
                             device=self.device)
        cache, logits = self.prefill(tokens)
        tok = torch.argmax(logits, -1)
        logits, cache = self._decode(tok, cache, prompt_len)
        synchronize(self.device)
        t0 = self._clock()
        for i in range(n_new):
            logits, cache = self._decode(tok, cache, prompt_len + 1 + i)
        synchronize(self.device)
        dt = self._clock() - t0
        return batch * n_new / dt
