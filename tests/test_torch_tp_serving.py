"""Tensor-parallel paged serving of the port against the JAX package's
single-device engine (which the JAX package's own TP test holds its TP
engine bit-identical to): reduced gemma2-2b on the JAX model's weights,
at tp=2 (g=2, s=1: pure head parallelism, attention through the paged
kernels' plain versions on the CPU) and tp=4 (g=2, s=2: the LSE merge of
page-row sub-shards carries the load), one CPU process a rank over gloo
(``tests/_torch_tp_ranks.py``).  The traffic is
``tests/test_tp_serving.py``'s: three greedy requests under each
collective mode, an oversubscribed pool that preempts (auto and swap),
and a shared radix prefix with copy-on-write pages.

Every rank's streams and host state must equal the others' exactly, the
streams the JAX engine's under the greedy margin rule, and the host
state and ``stats()["tp"]`` the JAX engine's and plan's exactly."""
import numpy as np
import pytest

from _torch_engine_pair import (drive, host_state, pair_on_one_thread,
                                streams_match)
from _torch_tp_ranks import serve_rank, spawn, to_numpy
from repro.core.offload import OffloadLatencyModel as JLatency
from repro.sharding.tp import plan_tp as j_plan_tp

# the JAX package's latency constants, on both engines, so that the auto
# policy decides alike
JAX_LATENCY = dict(pcie_gbps=13.2, host_gflops=140.0, device_tflops=197.0)
BASE = dict(max_batch=3, max_seq_len=96, page_size=16, prefill_chunk=16,
            num_pages=24)
PRESSURE = dict(max_batch=4, max_seq_len=64, page_size=16,
                prefill_chunk=16, num_pages=14)
PRESSURE_SPEC = [(8, 56), (5, 43), (20, 44), (4, 44), (30, 34), (6, 58)]


def _traffic(vocab):
    """name -> (serve keywords without tp, waves of (id, prompt,
    sampling keywords)); every run's collective mode beside it."""
    rng = np.random.default_rng(7)
    basic = [[(i, rng.integers(0, vocab, size=n), dict(max_new_tokens=8))
              for i, n in enumerate((5, 23, 40))]]
    rng = np.random.default_rng(7)
    pressure = [[(i, rng.integers(0, vocab, size=s), dict(max_new_tokens=n))
                 for i, (s, n) in enumerate(PRESSURE_SPEC)]]
    shared = rng.integers(0, vocab, size=24)
    tails = [rng.integers(0, vocab, size=6) for _ in range(3)]
    prefix = [[(0, np.concatenate([shared, tails[0]]),
                dict(max_new_tokens=8))],
              [(i, np.concatenate([shared, tails[i]]),
                dict(max_new_tokens=8)) for i in (1, 2)]]
    return {
        "basic-tiled": ("tiled", BASE, basic),
        "basic-single": ("single", BASE, basic),
        "preempt-auto": ("tiled", PRESSURE, pressure),
        "preempt-swap": ("single", dict(PRESSURE, preempt_policy="swap"),
                         pressure),
        "prefix": ("tiled", dict(BASE, prefix_cache=True), prefix),
    }


RUNS = ["basic-tiled", "basic-single", "preempt-auto", "preempt-swap",
        "prefix"]


@pytest.fixture(scope="module")
def pair():
    with pair_on_one_thread() as p:
        yield p


@pytest.fixture(scope="module")
def traffic(pair):
    return _traffic(pair.vocab)


@pytest.fixture(scope="module")
def jax_runs(pair, traffic):
    """The JAX single-device engine on every run's traffic (the two
    collective modes share one)."""
    out, seen = {}, {}
    for name, (_, serve, waves) in traffic.items():
        key = repr(sorted(serve.items())) + repr(waves[0][0][1][:3])
        if key not in seen:
            core = pair.jax_core(**serve)
            core.pressure.lat = JLatency(**JAX_LATENCY)
            toks, errs = drive(core, waves)
            assert not errs
            seen[key] = (toks, core)
        out[name] = seen[key]
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, pair, traffic, tmp_path_factory):
    tp = request.param
    runs = {name: (dict(serve, tp=tp, tp_collectives=coll), waves)
            for name, (coll, serve, waves) in traffic.items()}
    return tp, spawn(serve_rank, tp, tmp_path_factory.mktemp("pg"),
                     "gemma2-2b", to_numpy(pair.tp), runs, JAX_LATENCY)


@pytest.mark.parametrize("run", RUNS)
def test_every_rank_has_the_same_streams_and_state(ranks, run):
    _, res = ranks
    first = res[0][run]
    for r in res[1:]:
        assert r[run]["tokens"] == first["tokens"]
        assert r[run]["host_all"] == first["host_all"]
        assert r[run]["tp"] == first["tp"]


@pytest.mark.parametrize("run", RUNS)
def test_streams_and_host_state_equal_jax(pair, traffic, jax_runs, ranks,
                                          run):
    _, res = ranks
    got = res[0][run]
    want, jcore = jax_runs[run]
    prompts = {rid: p for w in traffic[run][2] for rid, p, _ in w}
    exact = streams_match(pair, prompts, got["tokens"], want)
    key = "host" if exact else "host_all"
    assert got[key] == host_state(jcore, tokens_equal=exact)


@pytest.mark.parametrize("run", RUNS)
def test_plan_and_local_pools_equal_jax(pair, traffic, ranks, run):
    tp, res = ranks
    coll, serve, _ = traffic[run]
    plan = j_plan_tp(pair.jcfg, tp, serve["page_size"], collectives=coll)
    for r in res:
        assert r[run]["tp"] == {"tp": plan.tp, "g": plan.g, "s": plan.s,
                                "collectives": plan.collectives}
        cfg = pair.tcfg
        assert r[run]["pool"] == (cfg.num_kv_heads // plan.g,
                                  serve["num_pages"],
                                  serve["page_size"] // plan.s,
                                  cfg.head_dim)
    assert (plan.g, plan.s) == {2: (2, 1), 4: (2, 2)}[tp]


def test_preemption_and_prefix_paths_are_taken(jax_runs, ranks):
    """The hard serving paths really ran under TP: preemptions in both
    pressured runs (a swap with bytes equal to the JAX engine's, whose
    host copy is the whole pool, in the swap run), prefix hits, and no
    page or stash left behind."""
    _, res = ranks
    for r in res:
        for run in ("preempt-auto", "preempt-swap"):
            p = r[run]["host_all"]["pressure"]
            want = jax_runs[run][1].stats()["pressure"]
            assert p["preemptions"] > 0
            assert p["swap_bytes_out"] == want["swap_bytes_out"]
            assert p["swap_bytes_in"] == p["swap_bytes_out"]
            assert r[run]["stash"] == 0
        assert r["preempt-swap"]["host_all"]["pressure"]["swaps"] > 0
        assert r["prefix"]["host_all"]["prefix"]["hits"] > 0
        for run in RUNS:
            assert r[run]["host_all"]["pages_used"] == \
                r[run]["host_all"].get("prefix_cached_pages", 0)
