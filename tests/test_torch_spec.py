"""The port's speculative decoding against the JAX package's, on the CPU.

Unit level: the prompt-lookup drafter proposes what JAX's proposes on the
same histories, its adaptive K and accept-rate EMA follow; greedy
acceptance keeps the same prefix.  Sampled acceptance draws from the
port's counter-based generator (``core.stream_seed``), not threefry, so
it is held to the port's own invariants: seeded replay, the target
marginal, and K=0 equal to ``core.sample_token`` bit for bit.

System level (reduced gemma2-2b, the JAX model's own weights,
tiled-motif prompts): with ``spec_mode="lookup"`` the greedy streams
equal spec-off within the port and the JAX spec-on engine, with JAX's
verify launches, drafted and accepted counts and fewer steps than
spec-off -- also under a pressured pool, over a shared prefix, and with
``spec_verify`` armed every step (K = 0).  Spec-off never verifies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_pair import (drive, host_state,  # noqa: E402
                                injectors, pair_on_one_thread,
                                streams_match)
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import SamplingParams as JParams  # noqa: E402
from repro.serving.spec import PromptLookupDrafter as JDrafter  # noqa: E402
from repro.serving.spec import verify_greedy as j_verify_greedy  # noqa: E402
from repro_torch.serving.core import (EngineCore, sample_token,  # noqa: E402
                                      stream_seed)
from repro_torch.serving.faults import LogitError  # noqa: E402
from repro_torch.serving.scheduler import Request, SamplingParams  # noqa: E402
from repro_torch.serving.spec import (PromptLookupDrafter,  # noqa: E402
                                      verify_greedy, verify_residual)

KW = dict(max_batch=3, max_seq_len=96, page_size=16, prefill_chunk=16,
          debug_invariants=True)
SPEC = dict(spec_mode="lookup", spec_tokens=4)


@pytest.fixture(scope="module")
def pair():
    with pair_on_one_thread() as p:
        yield p


# ---------------------------------------------------------------------------
# unit: the drafter and greedy acceptance against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_drafter_follows_jax(seed):
    """Histories grown a few tokens at a time, with accept feedback, on
    both drafters: the same proposals, budgets and EMAs; forget drops
    the same state."""
    rng = np.random.default_rng(seed)
    kw = dict(max_tokens=int(rng.integers(1, 6)),
              ngram_max=int(rng.integers(1, 4)), ngram_min=1,
              ema_alpha=float(rng.choice([0.0, 0.3, 0.5])))
    jd, td = JDrafter(**kw), PromptLookupDrafter(**kw)
    for rid in range(3):
        prompt = rng.integers(0, 5, size=int(rng.integers(3, 20)))
        jr = JRequest(id=rid, prompt=prompt,
                      sampling=JParams(max_new_tokens=64))
        tr = Request(id=rid, prompt=prompt,
                     sampling=SamplingParams(max_new_tokens=64))
        for _ in range(8):
            more = rng.integers(0, 5, size=int(rng.integers(1, 4))).tolist()
            jr.generated += more
            tr.generated += more
            got, want = td.propose(tr), jd.propose(jr)
            assert got == want
            acc = int(rng.integers(0, len(got) + 1))
            td.observe(rid, len(got), acc)
            jd.observe(rid, len(want), acc)
            assert td.budget(rid) == jd.budget(rid)
            assert td._ema == jd._ema and td._indexed == jd._indexed
        td.forget(rid)
        jd.forget(rid)
        assert td.budget(rid) == jd.budget(rid) == kw["max_tokens"]


@pytest.mark.parametrize("seed", range(6))
def test_verify_greedy_follows_jax(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(0, 6))
    argm = rng.integers(0, 4, size=k + 1)
    drafts = rng.integers(0, 4, size=k)
    for kw in (dict(budget=64), dict(budget=2), dict(budget=64,
                                                       stop_ids=(2,))):
        assert verify_greedy(drafts, argm, **kw) == \
            j_verify_greedy(drafts, argm, **kw)


def test_verify_guard_checks_only_consumed_rows():
    """On the card the rows past a slot's n_valid may be non-finite: only
    the rows acceptance consumes are guarded."""
    argm = [7, 8, 9]
    ok = np.array([True, False, True])
    assert verify_greedy([1, 8], argm, budget=64, row_ok=ok) == ([7], 0)
    with pytest.raises(LogitError):
        verify_greedy([7, 8], argm, budget=64, row_ok=ok)
    rows = torch.zeros((3, 4))
    rows[2] = float("nan")
    out = verify_residual([], rows, seed=0, n0=0, temperature=1.0,
                          budget=64, row_ok=np.array([True, False, False]))
    assert out[1] == 0 and len(out[0]) == 1
    with pytest.raises(LogitError):
        verify_residual([1], rows, seed=0, n0=0, temperature=1.0,
                        budget=64, row_ok=np.array([False, True, True]))


# ---------------------------------------------------------------------------
# unit: sampled acceptance on the port's counter-based generator
# ---------------------------------------------------------------------------

def test_verify_residual_replays_from_seed_and_index():
    rows = torch.randn((5, 16), generator=torch.Generator().manual_seed(0))
    drafts = [3, 11, 7, 2]
    kw = dict(seed=9, temperature=0.7, top_k=8, budget=64)
    a = verify_residual(drafts, rows, n0=4, **kw)
    assert a == verify_residual(drafts, rows, n0=4, **kw)
    assert 1 <= len(a[0]) <= 5 and 0 <= a[1] <= 4
    outs = {tuple(verify_residual(drafts, rows, n0=n, **kw)[0])
            for n in range(30)}
    assert len(outs) > 1                # other indices draw other coins


@pytest.mark.parametrize("n0,seed,temp,top_k", [
    (0, 0, 1.0, 0), (7, 3, 0.6, 5), (2, 11, 1.3, 0)])
def test_verify_residual_k0_equals_sample_token(n0, seed, temp, top_k):
    """A draft-less verify step samples exactly as the plain decode path
    does: the generator seeded by stream_seed(seed, n), the same
    processing, the same bits."""
    row = torch.randn((1, 32), generator=torch.Generator().manual_seed(1))
    toks, acc = verify_residual([], row, seed=seed, n0=n0,
                                temperature=temp, top_k=top_k, budget=64)
    gen = torch.Generator().manual_seed(stream_seed(seed, n0))
    want = int(sample_token(row, gen, temperature=temp, top_k=top_k)[0])
    assert (toks, acc) == ([want], 0)
    req = Request(id=0, prompt=[1], sampling=SamplingParams(
        temperature=temp, top_k=top_k, seed=seed, max_new_tokens=64))
    req.generated = [0] * n0
    assert EngineCore._sample(None, req, row[0]) == want


def test_verify_residual_marginal_matches_target():
    """Accept-or-residual over a point-mass drafter emits each token with
    its target probability -- including the drafted one."""
    logits = torch.tensor([1.5, 0.5, -0.5, 0.0])
    p = torch.softmax(logits, -1).numpy()
    rows = torch.stack([logits, logits])
    counts = np.zeros(4)
    trials = 1200
    for n in range(trials):
        toks, _ = verify_residual([1], rows, seed=5, n0=n, temperature=1.0,
                                  budget=64)
        counts[toks[0]] += 1
    np.testing.assert_allclose(counts / trials, p, atol=0.06)


# ---------------------------------------------------------------------------
# system: the engine's draft and verify phase
# ---------------------------------------------------------------------------

def _motif_prompts(vocab, n=3, seed=0):
    """Lookup-friendly prompts: a 5-token motif tiled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(1, vocab, size=5).tolist()
        out.append(np.array((motif * 8)[:20 + 4 * i], np.int32))
    return out


def _wave(prompts, max_new=16, temps=None, seed=11, base=0):
    return [(base + i, p, dict(max_new_tokens=max_new, seed=seed + i,
                               temperature=0.0 if temps is None
                               else temps[i]))
            for i, p in enumerate(prompts)]


def _pair_run(pair, waves, kw, injector_arms=None):
    """The same traffic on the JAX and the port's engine; returns the
    port's tokens and core after holding both to each other."""
    ji, ti = injectors(0, **injector_arms) if injector_arms else (None,
                                                                   None)
    jcore = pair.jax_core(injector=ji, **kw)
    want, jerr = drive(jcore, waves)
    core = pair.torch_core(injector=ti, **kw)
    got, err = drive(core, waves)
    assert err == jerr
    prompts = {r: p for w in waves for r, p, _ in w}
    exact = streams_match(pair, prompts, got, want)
    assert host_state(core, tokens_equal=exact) == \
        host_state(jcore, tokens_equal=exact)
    core.mgr.check_invariants(
        extern_refs=core.prefix.page_refs() if core.prefix else None)
    return got, core


@pytest.fixture(scope="module")
def spec_off(pair):
    waves = [_wave(_motif_prompts(pair.vocab))]
    core = pair.torch_core(**KW)
    return drive(core, waves)[0], core


def test_spec_streams_equal_off_and_jax_with_fewer_steps(pair, spec_off):
    off, core_off = spec_off
    on, core = _pair_run(pair, [_wave(_motif_prompts(pair.vocab))],
                         dict(KW, **SPEC))
    assert on == off                    # greedy stream invariant to spec
    st = core.stats()["spec"]
    assert st["drafted"] > 0 and st["accept_rate"] > 0.3
    assert st["verify_launches"] == core.spec_launches > 0
    assert core.stats()["steps"] < core_off.stats()["steps"]
    # the off engine never touched the verify path
    assert core_off.spec_launches == 0 and "spec" not in core_off.stats()
    snap = core.metrics.snapshot()
    assert snap["engine_spec_drafted_total"]["window"] == st["drafted"]
    assert snap["engine_spec_accepted_total"]["window"] == st["accepted"]
    assert snap["engine_spec_run_length"]["count"] > 0
    assert any("verify" in r["phases"] for r in core.flight.records)


def test_spec_verify_fault_degrades_to_k0(pair, spec_off):
    """spec_verify armed every step: every verify launch carries zero
    drafts; the tokens are still spec-off's."""
    on, core = _pair_run(pair, [_wave(_motif_prompts(pair.vocab))],
                         dict(KW, **SPEC),
                         injector_arms={"spec_verify": dict(every=1)})
    assert on == spec_off[0]
    st = core.stats()["spec"]
    assert st["drafted"] == 0 and st["verify_launches"] > 0


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_spec_under_pressure(pair, spec_off, policy):
    on, core = _pair_run(pair, [_wave(_motif_prompts(pair.vocab))],
                         dict(KW, **SPEC, num_pages=8,
                              preempt_policy=policy))
    assert on == spec_off[0]
    st = core.stats()["pressure"]
    assert st["preemptions"] > 0
    assert st["swap_bytes_in"] == st["swap_bytes_out"]
    assert core.mgr.used_pages == 0


def test_spec_over_a_shared_prefix(pair):
    """Two waves over a shared system prompt: the warm wave speculates
    off prefix-cache hits, copying shared tail pages before the
    multi-token append writes them."""
    rng = np.random.default_rng(4)
    sysp = rng.integers(1, pair.vocab, size=32).tolist()
    motif = rng.integers(1, pair.vocab, size=5).tolist()
    prompts = [np.array(sysp + (motif * 5)[:14], np.int32),
               np.array(sysp + (motif * 4)[:10], np.int32)]
    waves = [_wave(prompts), _wave(prompts, base=2)]
    kw = dict(KW, prefix_cache=True)
    off, _ = drive(pair.torch_core(**kw), waves)
    on, core = _pair_run(pair, waves, dict(kw, **SPEC))
    assert on == off
    assert core.stats()["prefix"]["hits"] > 0
    assert core.stats()["spec"]["accepted"] > 0


def test_spec_sampled_replay_and_batch_invariance(pair):
    prompts = _motif_prompts(pair.vocab)
    temps = [0.8, 0.9, 0.7]
    kw = dict(KW, **SPEC)
    a, core = drive(pair.torch_core(**kw), [_wave(prompts, temps=temps)])
    b, _ = drive(pair.torch_core(**kw), [_wave(prompts, temps=temps)])
    assert a == b                       # counter-based RNG: replayable
    solo, _ = drive(pair.torch_core(**kw),
                    [_wave(prompts[:1], temps=temps[:1])])
    assert solo[0] == a[0]              # co-tenants change nothing
    assert all(len(t) == 16 for t in a.values())


def test_spec_stop_token_inside_an_accepted_run(pair):
    prompts = _motif_prompts(pair.vocab, n=1)
    base, _ = drive(pair.torch_core(**KW), [_wave(prompts)])
    stop = base[0][5]
    wave = [(0, prompts[0], dict(max_new_tokens=16,
                                 stop_token_ids=(stop,)))]
    off, _ = drive(pair.torch_core(**KW), [wave])
    on, core = _pair_run(pair, [wave], dict(KW, **SPEC))
    assert on == off and on[0][-1] == stop and len(on[0]) <= 6
    assert core.mgr.used_pages == 0


def test_spec_config_validation(pair):
    with pytest.raises(ValueError, match="spec_mode"):
        pair.torch_core(**KW, spec_mode="draft-model")
    with pytest.raises(ValueError, match="spec_tokens"):
        pair.torch_core(**KW, spec_mode="lookup", spec_tokens=0)
