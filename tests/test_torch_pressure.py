"""The port's page-pressure subsystem against the JAX package's, on the
CPU.

Unit level: the swap copies (``gather_pages``/``scatter_pages``) round
trip exactly in float32 and bfloat16, into other physical pages;
``copy_pages`` reads every source before it writes a destination;
``HostPagePool`` keeps JAX's accounting; the swap/recompute choice is
JAX's under the same latency model.  System level (reduced gemma2-2b, the
JAX model's own weights): a pool at ~60% of the worst-case demand under
each ``preempt_policy`` and with a full host pool gives the port's own
unpressured streams and the JAX engine's pressured streams, preemption
counts and swap bytes, with no leak; the scan prefill oracle equals the
chunked prefill within the port and the JAX scan.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_pair import (drive, host_state,  # noqa: E402
                                pair_on_one_thread, streams_match)
from repro.config import get_model_config as j_get  # noqa: E402
from repro.core.offload import OffloadLatencyModel as JLatency  # noqa: E402
from repro.serving.paged_cache import OutOfPages as JOutOfPages  # noqa: E402
from repro.serving.pressure import HostPagePool as JHostPool  # noqa: E402
from repro.serving.pressure import PressureManager as JPressure  # noqa: E402
from repro.serving.paged_cache import PagedKVCache as JCache  # noqa: E402
from repro.config import ServeConfig as JServe  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.config import get_model_config  # noqa: E402
from repro_torch.core.offload import OffloadLatencyModel  # noqa: E402
from repro_torch.layers.attention import KVCache  # noqa: E402
from repro_torch.serving.paged_cache import OutOfPages, PagedKVCache  # noqa: E402,E501
from repro_torch.serving.pressure import (HostPagePool,  # noqa: E402
                                          PressureManager, copy_pages,
                                          gather_pages, scatter_pages)
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchScheduler, Request)

# mixed lengths, no eos: every sequence realises its worst case and the
# concurrent demand (4 slots x up to 4 pages) exceeds the pressured pool
PRESSURE_SPEC = [(8, 56), (5, 43), (20, 44), (4, 44), (30, 34), (6, 58)]
WORST_PAGES = sum(-(-(s + n) // 16) for s, n in PRESSURE_SPEC)   # 22
POOL = int(WORST_PAGES * 0.6) + 1                                # 14
KW = dict(max_batch=4, max_seq_len=64, page_size=16, debug_invariants=True)
# the JAX package's latency constants (the port's are the H100's): with
# them the auto policy must choose as the JAX engine does
JAX_LATENCY = dict(pcie_gbps=13.2, host_gflops=140.0, device_tflops=197.0)


@pytest.fixture(scope="module")
def pair():
    with pair_on_one_thread() as p:
        yield p


def _pools(num_pages, page_size, dtype, layers=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [KVCache(*(torch.randn((2, num_pages, page_size, 3),
                                  generator=gen).to(dtype)
                      for _ in range(2))) for _ in range(layers)]


def _clone(pools):
    return [tuple(t.clone() for t in layer) for layer in pools]


# ---------------------------------------------------------------------------
# unit: the copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_scatter_roundtrip_exact(dtype):
    """Pages out and back -- into DIFFERENT physical pages -- reproduce
    their contents bit for bit; the others are untouched; the pools are
    written in place."""
    pools = _pools(8, 4, dtype)
    before = _clone(pools)
    out_pages, in_pages = [5, 2, 7], [1, 6, 3]
    host = gather_pages(pools, out_pages)
    assert host[0][0].shape == (2, 3, 4, 3) and host[0][0].dtype == dtype
    ptrs = [t.data_ptr() for layer in pools for t in layer]
    assert scatter_pages(pools, in_pages, host) is pools
    assert ptrs == [t.data_ptr() for layer in pools for t in layer]
    for layer, old in zip(pools, before):
        for a, was in zip(layer, old):
            assert torch.equal(a[:, in_pages], was[:, out_pages])
            keep = [0, 2, 4, 5, 7]
            assert torch.equal(a[:, keep], was[:, keep])


def test_copy_pages_reads_every_source_first():
    pools = _pools(6, 4, torch.float32)
    before = _clone(pools)
    # a swap and a chain: 1<->2, then 3 <- 4 while 4 <- 5
    copy_pages(pools, [2, 1, 4, 5], [1, 2, 3, 4])
    for layer, old in zip(pools, before):
        for a, was in zip(layer, old):
            for src, dst in ((2, 1), (1, 2), (4, 3), (5, 4)):
                assert torch.equal(a[:, dst], was[:, src])
            assert torch.equal(a[:, [0, 5]], was[:, [0, 5]])


def test_host_page_pool_accounting_matches_jax():
    def trace(cls, oop):
        hp, log = cls(capacity_pages=4), []
        log.append((hp.has_room(4), hp.has_room(5)))
        hp.put(0, "a", 3)
        log.append((hp.used_pages, 0 in hp, hp.has_room(2), len(hp)))
        with pytest.raises(oop):
            hp.put(1, "b", 2)
        with pytest.raises(ValueError):
            hp.put(0, "c", 1)
        hp.put(2, "d", 1)
        log.append((hp.peek(2), hp.used_pages, hp.peak_pages))
        log.append((hp.pop(0), hp.used_pages, hp.peak_pages, 0 in hp))
        log.append(cls(0).has_room(10 ** 9))
        return log
    assert trace(HostPagePool, OutOfPages) == trace(JHostPool, JOutOfPages)


def test_policy_choice_matches_jax():
    """swap vs recompute for victims of every size, on llama2-7b and
    gemma2-2b, under the same latency model and each policy."""
    for arch in ("llama2-7b", "gemma2-2b"):
        for policy in ("swap", "recompute", "auto"):
            j = JPressure(j_get(arch), JServe(preempt_policy=policy,
                                              page_size=128),
                          JCache(8, 128, 2, 4), None,
                          latency_model=JLatency(**JAX_LATENCY))
            t = PressureManager(get_model_config(arch),
                                ServeConfig(preempt_policy=policy,
                                            page_size=128),
                                PagedKVCache(8, 128, 2, 4), None,
                                latency_model=OffloadLatencyModel(
                                    **JAX_LATENCY))
            for n_pages in (0, 1, 2, 8, 64, 512):
                for n_tok in (0, 1, 100, 128 * n_pages):
                    assert t.choose_policy(n_pages, n_tok) == \
                        j.choose_policy(n_pages, n_tok), (arch, policy)


def test_full_host_pool_downgrades_swap_to_recompute():
    cfg = get_model_config("gemma2-2b")
    cache = PagedKVCache(num_pages=12, page_size=4, max_slots=3,
                         max_pages_per_seq=8)
    sched = ContinuousBatchScheduler(cache, admission="optimistic",
                                     watermark_pages=1)
    pressure = PressureManager(cfg, ServeConfig(
        preempt_policy="swap", host_pool_pages=1, page_size=4), cache, sched)
    rng = np.random.default_rng(0)
    for i in range(2):
        sched.submit(Request(id=i, prompt=rng.integers(0, 256, size=8),
                             max_new_tokens=8))
    sched.admit()
    for slot in range(2):
        cache.append(slot, 8)                    # 2 pages each
        sched.slots[slot].prefilled = 8
    victim = pressure.preempt_slot(_pools(12, 4, torch.float32), 1)
    # 2 pages > host capacity 1: forced recompute, nothing stashed
    assert victim.resume_kind == "recompute"
    assert pressure.stats["recomputes"] == 1 and len(pressure.host_pool) == 0
    cache.check_invariants()


# ---------------------------------------------------------------------------
# system: pressured serving
# ---------------------------------------------------------------------------

def _wave(vocab, spec=PRESSURE_SPEC, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=s), dict(max_new_tokens=n))
            for i, (s, n) in enumerate(spec)]


@pytest.fixture(scope="module")
def unpressured(pair):
    return drive(pair.torch_core(**KW), [_wave(pair.vocab)])[0]


@pytest.mark.parametrize("policy", ["swap", "recompute", "auto"])
def test_pressured_streams_match(pair, unpressured, policy):
    wave = _wave(pair.vocab)
    kw = dict(KW, num_pages=POOL, preempt_policy=policy)
    jcore = pair.jax_core(**kw)
    jcore.pressure.lat = JLatency(**JAX_LATENCY)
    want, _ = drive(jcore, [wave])
    core = pair.torch_core(**kw)
    core.pressure.lat = OffloadLatencyModel(**JAX_LATENCY)
    got, err = drive(core, [wave])
    assert not err
    assert got == unpressured                    # pressure changes nothing
    exact = streams_match(pair, {r: p for r, p, _ in wave}, got, want)
    assert host_state(core, tokens_equal=exact) == \
        host_state(jcore, tokens_equal=exact)
    st = core.stats()["pressure"]
    assert st["preemptions"] > 0, "pool never pressured"
    assert st["swap_bytes_in"] == st["swap_bytes_out"]
    if policy == "swap":
        assert st["swaps"] == st["preemptions"] and st["swap_bytes_in"] > 0
    if policy == "recompute":
        assert st["recomputes"] == st["preemptions"]
    assert len(core.pressure.host_pool) == 0, "stash leaked"
    assert core.mgr.used_pages == 0, "pages leaked"
    assert core.mgr.peak_used_pages <= POOL - 1


def test_swap_victims_under_a_full_host_pool_recompute(pair):
    """A host pool of 2 pages, smaller than the victims' KV: every swap
    victim is downgraded to recompute, as in the JAX engine."""
    wave = _wave(pair.vocab)
    kw = dict(KW, num_pages=POOL, preempt_policy="swap", host_pool_pages=2)
    jcore = pair.jax_core(**kw)
    want, _ = drive(jcore, [wave])
    core = pair.torch_core(**kw)
    got, _ = drive(core, [wave])
    exact = streams_match(pair, {r: p for r, p, _ in wave}, got, want)
    assert host_state(core, tokens_equal=exact) == \
        host_state(jcore, tokens_equal=exact)
    st = core.stats()["pressure"]
    assert st["preemptions"] > 0 and st["recomputes"] > 0
    assert core.mgr.used_pages == 0


def test_scan_prefill_equals_chunked_and_jax_scan(pair):
    """The scan oracle (one decode step a prompt token) equals the
    chunked prefill within the port, and the JAX scan, also under a
    pressured pool with swap."""
    # one prompt length: the JAX scan traces once a length
    wave = _wave(pair.vocab, [(8, 56), (8, 43), (8, 44), (8, 44)], seed=3)
    prompts = {r: p for r, p, _ in wave}
    chunked, _ = drive(pair.torch_core(**KW), [wave])
    core = pair.torch_core(**KW, prefill_mode="scan")
    scan, _ = drive(core, [wave])
    assert scan == chunked
    assert core.prefill_launches == 0
    jcore = pair.jax_core(**KW, prefill_mode="scan")
    want, _ = drive(jcore, [wave])
    exact = streams_match(pair, prompts, scan, want)
    assert host_state(core, tokens_equal=exact) == \
        host_state(jcore, tokens_equal=exact)
    # under pressure the recompute resumes re-scan prompt + generated
    # tokens; the JAX scan would trace once more for each such length
    kw = dict(KW, num_pages=10, prefill_mode="scan", preempt_policy="swap")
    core = pair.torch_core(**kw)
    pressured, _ = drive(core, [wave])
    assert pressured == chunked
    st = core.stats()["pressure"]
    assert st["preemptions"] > 0 and st["swaps"] > 0
    assert st["swap_bytes_in"] == st["swap_bytes_out"]
    assert core.mgr.used_pages == 0
