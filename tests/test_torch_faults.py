"""The port's fault injection and request isolation against the JAX
package's, on the CPU.

Each fault site (``serving/faults.py:SITES``) is armed with the same seed
and schedule on both packages' engines over the same traffic (reduced
gemma2-2b, the JAX model's own weights): the same ``fired_log``, the same
failed request ids with the same error codes, and the survivors' greedy
streams equal the JAX engine's and the port's fault-free run.  An
un-armed injector is identical to none.  A swap fault within
``swap_retries`` is retried; past it the swap is downgraded to recompute
and no request fails.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_pair import (drive, host_state,  # noqa: E402
                                injectors, pair_on_one_thread,
                                streams_match)
from repro_torch.serving.faults import SITES, FaultInjector  # noqa: E402

KW = dict(max_batch=3, max_seq_len=96, page_size=16, prefill_chunk=16,
          debug_invariants=True)


@pytest.fixture(scope="module")
def pair():
    with pair_on_one_thread() as p:
        yield p


def _wave(vocab, lens, new, seed, base=0):
    rng = np.random.default_rng(seed)
    return [(base + i, rng.integers(0, vocab, size=s),
             dict(max_new_tokens=new)) for i, s in enumerate(lens)]


def _motif_wave(vocab, seed=2, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(1, vocab, size=5).tolist()
        out.append((i, np.array((motif * 8)[:20 + 4 * i], np.int32),
                    dict(max_new_tokens=12)))
    return out


def _pair_faults(pair, waves, kw, arms, seed=0):
    """The same armed traffic on both engines; the port's tokens, errors
    and core, after holding both engines to each other."""
    ji, ti = injectors(seed, **arms)
    jcore = pair.jax_core(injector=ji, **kw)
    want, jerr = drive(jcore, waves)
    core = pair.torch_core(injector=ti, **kw)
    got, err = drive(core, waves)
    assert err == jerr                          # same ids, codes, details
    assert ti.fired_log == ji.fired_log
    prompts = {r: p for w in waves for r, p, _ in w}
    survivors = {r: t for r, t in got.items() if r not in err}
    exact = streams_match(pair, prompts, survivors,
                          {r: want[r] for r in survivors})
    assert host_state(core, tokens_equal=exact) == \
        host_state(jcore, tokens_equal=exact)
    assert core.stats()["active_slots"] == 0
    assert core.mgr.used_pages == (core.prefix.cached_pages
                                   if core.prefix else 0)
    assert len(core.pressure.host_pool) == 0
    return got, err, core


_REFS: dict = {}


def _fault_free(pair, kw, waves, key):
    """The port's fault-free run of ``waves`` under ``kw``, once a module
    for each traffic ``key``."""
    if key not in _REFS:
        ref, err = drive(pair.torch_core(**kw), waves)
        assert not err
        _REFS[key] = ref
    return _REFS[key]


def _survivors_equal(got, err, ref):
    for rid, toks in got.items():
        if rid not in err:
            assert toks == ref[rid], rid


# the scenario that reaches each site, and its schedule
# (the engines share max_batch, so the JAX engines compile once a pool)
PRESSURED = dict(num_pages=7, preempt_policy="swap")
CASES = {
    "page_alloc": (dict(), dict(nth=(2,))),
    "swap_d2h": (PRESSURED, dict(every=1)),
    "swap_h2d": (PRESSURED, dict(every=1)),
    "cow_copy": (dict(prefix_cache=True), dict(nth=(1,))),
    "prefill_launch": (dict(), dict(every=3)),
    "decode_launch": (dict(), dict(every=4)),
    "sample": (dict(), dict(nth=(1, 5))),
    "spec_verify": (dict(spec_mode="lookup", spec_tokens=4),
                    dict(every=2)),
}


def _traffic_key(site):
    return ("swap" if site.startswith("swap") else site
            if site in ("cow_copy", "spec_verify") else "plain")


def _traffic(pair, site):
    if site.startswith("swap"):
        return [_wave(pair.vocab, (8, 8), 60, seed=21)]
    if site == "cow_copy":
        # a page-aligned prompt served twice: the second run's write to
        # its fully shared tail page copies it first
        prompt = np.random.default_rng(3).integers(0, pair.vocab, size=32)
        return [[(0, prompt, dict(max_new_tokens=6))],
                [(1, prompt, dict(max_new_tokens=6)),
                 (2, prompt, dict(max_new_tokens=6))]]
    if site == "spec_verify":
        return [_motif_wave(pair.vocab)]
    return [_wave(pair.vocab, (5, 40, 9), 6, seed=26)]


def test_every_site_has_a_case():
    assert set(CASES) == set(SITES)


@pytest.mark.parametrize("site", sorted(CASES))
def test_site_matches_jax_engine(pair, site):
    kw, arm = CASES[site]
    kw = dict(KW, **kw)
    waves = _traffic(pair, site)
    ref = _fault_free(pair, kw, waves, _traffic_key(site))
    got, err, core = _pair_faults(pair, waves, kw, {site: arm})
    inj = core.injector
    assert inj.total_fired > 0, f"{site} never fired"
    _survivors_equal(got, err, ref)
    st = core.stats()
    if site in ("page_alloc", "cow_copy", "sample"):
        # a per-request fault fails exactly the request it hit
        assert err and all(d.startswith("injected: ") for d in err.values())
        assert st["health"]["failed"] == len(err)
    else:
        # launch, swap and verify faults only delay or degrade
        assert not err and st["health"]["failed"] == 0
    if site.startswith("swap"):
        p = st["pressure"]
        assert p["swap_fail_downgrades"] > 0 and p["preemptions"] > 0
        assert p["swap_retries"] >= core.serve.swap_retries + 1
    if site == "spec_verify":
        assert st["spec"]["verify_launches"] > 0


def test_transient_swap_fault_retries_through(pair):
    """One D2H fault, inside the retry budget: retried, the swap still
    happens, nothing is downgraded or failed."""
    kw = dict(KW, **PRESSURED)
    waves = _traffic(pair, "swap_d2h")
    ref = _fault_free(pair, kw, waves, "swap")
    got, err, core = _pair_faults(pair, waves, kw,
                                  {"swap_d2h": dict(nth=(1,))}, seed=3)
    st = core.stats()["pressure"]
    assert st["swap_retries"] == 1 and st["swap_fail_downgrades"] == 0
    assert st["swaps"] > 0 and not err and got == ref


def test_unarmed_injector_is_identical_to_none(pair):
    kw = dict(KW)
    waves = [_wave(pair.vocab, (5, 40, 9), 5, seed=20)]
    bare = pair.torch_core(**kw)
    plain, _ = drive(bare, waves)
    inj = FaultInjector(seed=0)
    wired = pair.torch_core(injector=inj, **kw)
    toks, errs = drive(wired, waves)
    assert toks == plain and not errs
    assert wired.prefill_launches == bare.prefill_launches
    assert wired.decode_launches == bare.decode_launches
    assert wired.steps == bare.steps and inj.total_fired == 0
    for site in ("page_alloc", "prefill_launch", "decode_launch", "sample"):
        assert inj.calls(site) > 0, f"site {site} never threaded"


def test_chaos_every_site_at_once(pair):
    """Every site armed together, with seeded coins, on speculation,
    the prefix cache and a pressured pool: both engines fire, fail and
    serve alike, and every survivor equals the fault-free run."""
    kw = dict(KW, spec_mode="lookup", spec_tokens=4, prefix_cache=True,
              num_pages=7, preempt_policy="swap")
    waves = [_motif_wave(pair.vocab), _motif_wave(pair.vocab)]
    waves[1] = [(r + 10, p, s) for r, p, s in waves[1]]
    ref, _ = drive(pair.torch_core(**kw), waves)
    # rarer coins at the sites that fail a request, so most survive
    arms = {site: dict(prob=0.25) for site in SITES}
    arms.update(page_alloc=dict(prob=0.03), sample=dict(prob=0.03),
                cow_copy=dict(prob=0.5))
    got, err, core = _pair_faults(pair, waves, kw, arms, seed=6)
    fired = {site for site, _ in core.injector.fired_log}
    assert len(fired) >= 5 and 0 < len(err) < len(got)
    _survivors_equal(got, err, ref)
    st = core.stats()
    assert st["health"]["failed"] == len(err)
    assert st["pressure"]["preemptions"] > 0 and st["prefix"]["hits"] > 0
    assert st["spec"]["accepted"] > 0


def test_scan_prefill_launch_fault_retries_next_step(pair):
    """A prefill_launch fault in the scan oracle skips the sequence's
    scan this step; the port scans it on the next one, to the tokens of
    the fault-free run.  The JAX engine scans only the step's admissions,
    so there the sequence stays PREFILLING and the engine never goes
    idle (a fault of the reference)."""
    kw = dict(KW, prefill_mode="scan")
    waves = [_wave(pair.vocab, (10, 12), 4, seed=27)]
    ref, _ = drive(pair.torch_core(**kw), waves)
    ji, ti = injectors(0, prefill_launch=dict(nth=(1,)))
    core = pair.torch_core(injector=ti, **kw)
    got, err = drive(core, waves)
    assert got == ref and not err
    assert ti.fired_log == [("prefill_launch", 1)]
    assert core.mgr.used_pages == 0
    jcore = pair.jax_core(injector=ji, **kw)
    with pytest.raises(AssertionError, match="never went idle"):
        drive(jcore, waves, max_steps=50)
    assert [r.state for r in jcore.sched.slots if r is not None] == [
        "PREFILLING"]
