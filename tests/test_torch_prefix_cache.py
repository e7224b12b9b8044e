"""The port's prefix cache against the JAX package's, on the CPU.

Unit level: the same random trace of ``match``/``insert``/``evict``/share
driven through both packages' ``RadixPrefixIndex`` over their own
``PagedKVCache`` gives the same results, stats and invariants.  System
level (reduced gemma2-2b, the JAX model's own weights): two waves over a
shared system prompt give the JAX engine's greedy streams, prefix stats
and prefill launches, in chunked and scan prefill; a full-prompt hit
copies its shared tail page on write, and the copy lands on the device
pools.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_pair import (drive, host_state,  # noqa: E402
                                pair_on_one_thread, streams_match)
from repro.serving.paged_cache import OutOfPages as JOutOfPages  # noqa: E402
from repro.serving.paged_cache import PagedKVCache as JCache  # noqa: E402
from repro.serving.prefix_cache import RadixPrefixIndex as JIndex  # noqa: E402,E501
from repro_torch.serving import pressure  # noqa: E402
from repro_torch.serving.paged_cache import OutOfPages, PagedKVCache  # noqa: E402,E501
from repro_torch.serving.prefix_cache import RadixPrefixIndex  # noqa: E402
from repro_torch.serving.scheduler import SamplingParams  # noqa: E402

PS = 4
KW = dict(max_batch=2, max_seq_len=96, page_size=16, prefill_chunk=16,
          debug_invariants=True)


@pytest.fixture(scope="module")
def pair():
    with pair_on_one_thread() as p:
        yield p


# ---------------------------------------------------------------------------
# unit: the radix index on both packages
# ---------------------------------------------------------------------------

def _trace(cache_cls, index_cls, oop, seed: int, steps: int = 60):
    """A random trace of index operations; returns every observable
    result (match results, insert/evict counts, refcounts, stats)."""
    rng = np.random.default_rng(seed)
    c = cache_cls(num_pages=40, page_size=PS, max_slots=2,
                  max_pages_per_seq=8)
    idx = index_cls(c, capacity_pages=12 if seed % 2 else 0)
    inserted, log = [], []
    for _ in range(steps):
        op = ["insert", "match", "match_known", "evict", "share"][
            int(rng.integers(0, 5))]
        toks = rng.integers(0, 3, size=int(rng.integers(1, 5)) * PS
                            + int(rng.integers(0, PS))).astype(np.int32)
        if op == "insert":
            try:
                c.alloc(0)
                c.append(0, len(toks))
            except oop:
                c.free(0)
                log.append(("oop",))
                continue
            log.append(("insert", idx.insert(toks[:len(toks) // PS * PS],
                                             c.owned_pages(0)[
                                                 :len(toks) // PS])))
            c.free(0)
            inserted.append(toks)
        elif op in ("match", "match_known"):
            if op == "match_known" and inserted:
                toks = inserted[int(rng.integers(0, len(inserted)))]
            log.append(("match", idx.match(toks, record=bool(
                rng.integers(0, 2)))))
        elif op == "evict":
            log.append(("evict", idx.evict(int(rng.integers(1, 4)))))
        else:
            pages, m = idx.match(toks)
            if m:
                c.alloc(1)
                c.share_pages(1, pages, m)
                log.append(("share", [c.refcount(p) for p in pages]))
                c.free(1)
        c.check_invariants(extern_refs=idx.page_refs())
        log.append(("state", len(idx), idx.cached_pages, c.used_pages,
                    sorted(idx.page_refs().items())))
    log.append(("stats", dict(idx.stats)))
    log.append(("drain", idx.evict(10 ** 6), c.used_pages))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_index_trace_matches_jax(seed):
    want = _trace(JCache, JIndex, JOutOfPages, seed)
    got = _trace(PagedKVCache, RadixPrefixIndex, OutOfPages, seed)
    assert got == want
    assert got[-1][2] == 0                       # nothing leaks


# ---------------------------------------------------------------------------
# system: the engine over a shared system prompt
# ---------------------------------------------------------------------------

def _waves(vocab, sys_len=40):
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, vocab, size=sys_len)    # 2.5 pages

    def wave(seed, base):
        r = np.random.default_rng(seed)
        return [(base + i, np.concatenate(
            [sys_prompt, r.integers(0, vocab, size=4 + 3 * i)]),
            dict(max_new_tokens=6)) for i in range(3)]
    return [wave(9, 0), wave(1, 10)]


@pytest.fixture(scope="module")
def jax_two_waves(pair):
    """The JAX engine's chunked run of the two waves."""
    jcore = pair.jax_core(**KW, prefix_cache=True)
    want, jerr = drive(jcore, _waves(pair.vocab))
    assert not jerr
    return want, jcore


@pytest.mark.parametrize("mode", ["chunked", "scan"])
def test_two_waves_match_jax_engine(pair, jax_two_waves, mode):
    """Both prefill modes against the JAX engine's chunked run (the scan
    oracle's own JAX counterpart, which traces once a prompt length, is
    held in test_torch_pressure.py): the same streams and the same
    prefix and page counts; the chunked run also the same steps and
    prefill launches (the scan prefills a whole prompt in one step)."""
    waves = _waves(pair.vocab)
    prompts = {rid: p for w in waves for rid, p, _ in w}
    kw = dict(KW, prefix_cache=True, prefill_mode=mode)
    want, jcore = jax_two_waves
    core = pair.torch_core(**kw)
    got, err = drive(core, waves)
    assert not err
    exact = streams_match(pair, prompts, got, want)
    st, jst = (host_state(c, tokens_equal=exact) for c in (core, jcore))
    if mode == "scan":
        assert st.pop("prefill_launches") == 0
        for key in ("prefill_launches", "steps"):
            jst.pop(key)
        st.pop("steps")
    assert st == jst
    # the warm wave shared the page-aligned 32 of the 40 system tokens
    warm = [core.sched.finished[i] for i in range(3, 6)]
    assert all(r.matched_len == 32 for r in warm)
    st = core.stats()["prefix"]
    assert st["hits"] >= 3 and st["hit_tokens"] >= 3 * 32
    core.mgr.check_invariants(extern_refs=core.prefix.page_refs())
    assert core.mgr.used_pages == core.prefix.cached_pages > 0
    if mode == "chunked":
        # the cold engine gives the same tokens: shared pages hold
        # exactly the KV the prefix would recompute
        cold, _ = drive(pair.torch_core(**KW), waves)
        assert cold == got


def test_warm_wave_skips_the_matched_prefix_launches(pair):
    waves = _waves(pair.vocab)
    core = pair.torch_core(**KW, prefix_cache=True)
    drive(core, waves[:1])
    cold_launches = core.prefill_launches
    drive(core, waves[1:])
    warm_launches = core.prefill_launches - cold_launches
    # every warm tail fits one 16-token chunk, chunks of distinct
    # sequences batch; the cold wave needed >= 3 chunks a request
    assert 0 < warm_launches <= 3 < cold_launches


def test_full_prompt_hit_copies_the_shared_tail_page(pair, monkeypatch):
    """A fully cached two-page prompt recomputes only its last token,
    whose write copies the shared tail page first: every other row of
    the copy equals the cached page, in every layer's K and V, and the
    cached page is left as it was."""
    prompt = np.random.default_rng(3).integers(0, pair.vocab, size=32)
    core = pair.torch_core(**KW, prefix_cache=True)
    drive(core, [[(0, prompt, dict(max_new_tokens=6))]])
    copies = []
    real = pressure.copy_pages

    def spy(pools, srcs, dsts):
        before = [tuple(t.clone() for t in layer) for layer in pools]
        copies.append((list(srcs), list(dsts), before))
        return real(pools, srcs, dsts)

    monkeypatch.setattr("repro_torch.serving.core.copy_pages", spy)
    core.add_request(prompt, SamplingParams(max_new_tokens=6), request_id=1)
    core.step()                         # admit, COW, prefill one token
    assert len(copies) == 1
    (src,), (dst,), before = copies[0]
    req = core.sched.slots[0] or core.sched.slots[1]
    assert req.matched_len == 31
    for layer, old in zip(core.pools, before):
        for pool, was in zip(layer, old):
            # rows 0..14 copied (the fresh page held other data); row
            # 15 is the recomputed last token
            assert not torch.equal(was[:, dst, :15], was[:, src, :15])
            assert torch.equal(pool[:, dst, :15], was[:, src, :15])
            assert torch.equal(pool[:, src], was[:, src])
    while core.has_work:
        core.step()
    jcore = pair.jax_core(**KW, prefix_cache=True)
    want, _ = drive(jcore, [[(0, prompt, dict(max_new_tokens=6))],
                            [(1, prompt, dict(max_new_tokens=6))]])
    assert core.sched.finished[-1].generated == want[1]
    assert core.prefill_launches == jcore.prefill_launches
    core.mgr.check_invariants(extern_refs=core.prefix.page_refs())


def test_lru_eviction_under_pool_pressure_matches_jax(pair):
    """A pool too small to cache every retired prompt evicts LRU leaves
    at admission and under OutOfPages: the same evictions, preemptions
    and tokens as the JAX engine, and no leak."""
    rng = np.random.default_rng(6)
    wave = [(i, rng.integers(0, pair.vocab, size=40 + i),
             dict(max_new_tokens=12)) for i in range(4)]
    kw = dict(KW, prefix_cache=True, num_pages=10)
    jcore = pair.jax_core(**kw)
    want, _ = drive(jcore, [wave])
    core = pair.torch_core(**kw)
    got, _ = drive(core, [wave])
    exact = streams_match(pair, {r: p for r, p, _ in wave}, got, want)
    assert host_state(core, tokens_equal=exact) == \
        host_state(jcore, tokens_equal=exact)
    assert core.stats()["prefix"]["evicted_blocks"] > 0
    assert core.mgr.used_pages == core.prefix.cached_pages <= 9
