"""Speculative decoding: prompt-lookup drafting + multi-token verify.

The port of the JAX package's ``serving/spec.py``.  A *drafter* guesses
the next K tokens of each running request from its own text
(prompt-lookup n-gram matching: no second model), the engine appends the
guesses to the paged KV and scores all K+1 positions in ONE chunked
paged-prefill launch (``paged_prefill.cu`` on the card: a chunk of K+1
rows per slot at its own ``pos_start``/``n_valid``), and an acceptance
rule keeps the longest valid prefix:

    drafter      d1 .. dK          = continuation after the last match
    verify row   [t0, d1 .. dK]    -> logits L0 .. LK  (one launch)
    accept       greedy: keep di while di == argmax(L[i-1]);
                 sampled: keep di with prob p(di), else residual-sample
    emit         accepted drafts + one correction/bonus token
    rollback     PagedKVCache.truncate() drops the rejected rows' KV

Greedy streams equal the plain decode path's: the emitted token at every
position is the target argmax whether or not the draft matched.  At
``temperature > 0`` the accept/residual draws come from the engine's
counter-based generator (``core.stream_seed``): token index ``n`` draws
only from generators seeded by ``stream_seed(seed, n)`` and values derived
from it, so sampled acceptance replays from (seed, token index), is
invariant to batch composition, and K=0 is ``core.sample_token`` bit for
bit.  (The JAX package's threefry ``fold_in`` stream cannot be replayed in
PyTorch; these invariants can.)
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.serving.faults import LogitError


class Drafter:
    """Protocol for speculation drafters: propose continuation tokens
    for a running request, learn from verification feedback, drop
    per-request state when the request leaves the engine."""

    def propose(self, req) -> List[int]:
        """Up to ``max_tokens`` guessed continuations of
        ``req.prompt + req.generated`` (may be empty)."""
        raise NotImplementedError

    def observe(self, request_id: int, proposed: int,
                accepted: int) -> None:
        """Verification feedback for one step: ``accepted`` of
        ``proposed`` drafts survived."""

    def forget(self, request_id: int) -> None:
        """Drop any state for a retired/aborted/failed request."""

    def reset(self) -> None:
        """Drop all per-request state."""


class PromptLookupDrafter(Drafter):
    """N-gram prompt-lookup drafter: no second model, no extra launch.

    Each request's ``prompt + generated`` text is indexed incrementally
    (suffix n-grams of length ``ngram_min..ngram_max`` -> their two most
    recent end positions).  To draft, the current suffix is matched
    longest-n-gram-first and the tokens that followed the previous
    occurrence are proposed verbatim.  A per-request accept-rate EMA
    adapts K: requests whose text never repeats stop paying for failed
    speculation (K shrinks toward 1), repetitive requests draft the full
    ``max_tokens``."""

    def __init__(self, *, max_tokens: int, ngram_max: int = 3,
                 ngram_min: int = 1, ema_alpha: float = 0.5):
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{ngram_min}, {ngram_max}]")
        if not 0.0 <= ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in [0, 1], got {ema_alpha}")
        self.max_tokens = max_tokens
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self.ema_alpha = ema_alpha
        # request id -> {ngram tuple: (latest end pos, previous end pos)}
        self._index: Dict[int, Dict[Tuple[int, ...], Tuple[int, int]]] = {}
        self._indexed: Dict[int, int] = {}      # tokens indexed so far
        self._ema: Dict[int, float] = {}        # accept-rate estimate

    def budget(self, request_id: int) -> int:
        """Adaptive K: scale ``max_tokens`` by the request's accept-rate
        EMA (optimistic full K before any feedback; never below 1 --
        a 1-token draft is how a cold estimate recovers)."""
        if self.ema_alpha == 0.0:
            return self.max_tokens
        ema = self._ema.get(request_id)
        if ema is None:
            return self.max_tokens
        return max(1, int(round(ema * self.max_tokens)))

    def propose(self, req) -> List[int]:
        ctx = [int(t) for t in req.prompt] + [int(t) for t in req.generated]
        rid = req.id
        idx = self._index.setdefault(rid, {})
        length = len(ctx)
        # incremental indexing: only n-grams ending past the last call's
        # high-water mark are new (generation is append-only; KV rollback
        # never shrinks ``generated``)
        for end in range(self._indexed.get(rid, 0) + 1, length + 1):
            for n in range(self.ngram_min, min(self.ngram_max, end) + 1):
                key = tuple(ctx[end - n:end])
                prev = idx.get(key)
                idx[key] = (end, prev[0] if prev is not None else -1)
        self._indexed[rid] = length
        k = self.budget(rid)
        # longest suffix match first; the suffix's own occurrence ends at
        # ``length`` (empty continuation), so the two-deep index lets the
        # previous occurrence supply the draft
        for n in range(min(self.ngram_max, length), self.ngram_min - 1, -1):
            hit = idx.get(tuple(ctx[length - n:length]))
            if hit is None:
                continue
            for end in hit:
                if 0 <= end < length:
                    return ctx[end:end + min(k, length - end)]
        return []

    def observe(self, request_id: int, proposed: int,
                accepted: int) -> None:
        if proposed <= 0 or self.ema_alpha == 0.0:
            return
        rate = accepted / proposed
        prev = self._ema.get(request_id)
        self._ema[request_id] = rate if prev is None else (
            self.ema_alpha * rate + (1.0 - self.ema_alpha) * prev)

    def forget(self, request_id: int) -> None:
        self._index.pop(request_id, None)
        self._indexed.pop(request_id, None)
        self._ema.pop(request_id, None)

    def reset(self) -> None:
        self._index.clear()
        self._indexed.clear()
        self._ema.clear()


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------
# Both verifiers consume the logits of one request's verify row
# [t0, d1 .. dK]: row i is the target distribution for generated token
# index n0+i (row 0 is exactly what the plain decode step would have
# produced).  They return (tokens, accepted): ``tokens`` is everything
# the request emits this step -- accepted drafts plus one correction or
# bonus token -- and ``accepted`` counts surviving drafts (drives the
# drafter's EMA and the accept-rate metrics).  ``row_ok`` is the
# engine's per-row finite-logits guard; a row is only checked when its
# logits are actually consumed, so K=0 behaves exactly like the plain
# path.


def _guard_row(row_ok, i: int, request_id: int, token_index: int) -> None:
    if row_ok is not None and not bool(row_ok[i]):
        raise LogitError(
            f"request {request_id}: non-finite logits at token "
            f"{token_index}", request_id=request_id)


def verify_greedy(drafts: Sequence[int], argmax_rows, *,
                  stop_ids: Sequence[int] = (), budget: int,
                  row_ok=None, request_id: int = -1, n0: int = 0
                  ) -> Tuple[List[int], int]:
    """Greedy acceptance: the emitted token at every position IS the
    target argmax, so the stream is bit-identical to plain decode; a
    draft merely decides whether the next row's logits were conditioned
    on the right token and may be consumed.  Acceptance stops at a stop
    token or the request's remaining-token ``budget``; a full match
    earns the bonus token from the last row."""
    out: List[int] = []
    accepted = 0
    stop = frozenset(int(s) for s in stop_ids)
    for i, d in enumerate(drafts):
        _guard_row(row_ok, i, request_id, n0 + i)
        t = int(argmax_rows[i])
        out.append(t)
        if t != int(d):
            return out, accepted        # correction token; rest rejected
        accepted += 1
        if t in stop or len(out) >= budget:
            return out, accepted
    _guard_row(row_ok, len(drafts), request_id, n0 + len(drafts))
    out.append(int(argmax_rows[len(drafts)]))
    return out, accepted


def _processed_logits(row: torch.Tensor, temperature: float,
                      top_k: int) -> torch.Tensor:
    """Temperature/top-k processing identical to ``core.sample_token``:
    the acceptance coin must measure exactly the distribution the plain
    sampler would have drawn from."""
    lf = row.float() / max(temperature, 1e-6)
    if top_k > 1:
        k = min(top_k, lf.shape[-1])
        thresh = torch.topk(lf, k, dim=-1).values[..., -1:]
        lf = torch.where(lf < thresh, -1e30, lf)
    return lf


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def verify_residual(drafts: Sequence[int], logits_rows: torch.Tensor, *,
                    seed: int, n0: int, temperature: float, top_k: int = 0,
                    stop_ids: Sequence[int] = (), budget: int,
                    row_ok=None, request_id: int = -1
                    ) -> Tuple[List[int], int]:
    """Leftover/residual rejection sampling against a deterministic
    drafter (q is a point mass, so the accept probability for draft d is
    p(d) under the processed target distribution; the rejection residual
    is p with d removed, renormalised -- the emitted marginal at every
    position is exactly p).  ``logits_rows``: (K+1, V) on any device.

    RNG discipline: token index n draws from generators seeded by
    ``stream_seed(stream_seed(seed, n), 1)`` for the accept coin and
    ``..., 2)`` for the residual draw; the bonus/K=0 token goes through
    ``core.sample_token`` with ``stream_seed(seed, n)``, exactly as
    ``EngineCore._sample`` draws it, so a draft-less step equals plain
    decode bit for bit."""
    from repro_torch.serving.core import sample_token, stream_seed
    dev = logits_rows.device
    out: List[int] = []
    accepted = 0
    stop = frozenset(int(s) for s in stop_ids)
    for i, d in enumerate(drafts):
        _guard_row(row_ok, i, request_id, n0 + i)
        d = int(d)
        key = stream_seed(seed, n0 + i)
        lf = _processed_logits(logits_rows[i], temperature, top_k)
        p_d = float(torch.softmax(lf, dim=-1)[d])
        u = float(torch.rand((), generator=_generator(
            dev, stream_seed(key, 1)), device=dev))
        if u < p_d:
            out.append(d)
            accepted += 1
            if d in stop or len(out) >= budget:
                return out, accepted
            continue
        resid = lf.clone()
        resid[d] = -1e30                # p with d zeroed, renormalised
        tok = torch.multinomial(torch.softmax(resid, dim=-1), 1,
                                generator=_generator(
                                    dev, stream_seed(key, 2)))
        out.append(int(tok))
        return out, accepted
    i = len(drafts)
    _guard_row(row_ok, i, request_id, n0 + i)
    tok = sample_token(logits_rows[i].reshape(1, -1),
                       _generator(dev, stream_seed(seed, n0 + i)),
                       temperature=temperature, top_k=top_k)
    out.append(int(tok.reshape(-1)[0]))
    return out, accepted
