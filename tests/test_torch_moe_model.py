"""Mixture-of-experts models in the port against the JAX package, on the
CPU: reduced qwen3-moe-30b-a3b (4 experts top-2, SwiGLU, GQA) and reduced
grok-1-314b (GeGLU experts, attention softcap 30, tied embeddings).

Both sides run the JAX model's own weights (``params_from_jax``) in
float32.  Held to JAX: ``LM.apply`` logits (the JAX Pallas kernel in
interpret mode and its plain reference), paged prefill chunks at a
capacity factor that drops assignments and paged decode steps, dense
decode steps, all within 1e-4; the paged ``EngineCore``'s greedy streams
under the margin rule of ``tests/_torch_engine_pair.py``, its host state,
pages and steps exactly; dense ``ServeEngine.generate`` under the same
rule.  Capacity is per batch row and per launch in both packages, so
these runs chunk the prompts identically.  The parallel plans over moe
blocks are JAX's (their runs: ``test_torch_moe_tp.py``,
``test_torch_moe_ep.py``, ``test_torch_moe_ep_edges.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_engine_pair import (MARGIN, drive, host_state,  # noqa: E402
                                pair_on_one_thread, streams_match)
from repro.config import ParallelConfig as JParallel  # noqa: E402
from repro.config import ServeConfig as JServe  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.config import ParallelConfig, ServeConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.models import blocks, build_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.sharding.tp import plan_tp  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
TOL = dict(rtol=1e-4, atol=1e-4)
# 4 slots over 6 requests of 5-40 prompt tokens: chunked prefill across
# 16-token pages (cap 10 of a chunk's 32 assignments an expert), decode
# steps at every slot, a slot reused
SERVE = dict(max_batch=4, max_seq_len=64, page_size=16, prefill_chunk=16)
SPEC = [(5, 9), (17, 6), (40, 12), (9, 3), (23, 8), (12, 10)]
PS, CHUNK = 16, 32


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    with pair_on_one_thread(request.param) as p:
        yield p


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def drops(monkeypatch):
    """Record every port MoE block's (dropped, total) assignments of the
    first ``n_valid[b]`` tokens of each row (set ``drops.n_valid``)."""
    class Log(list):
        n_valid = None
    log = Log()
    apply = moe.apply_moe

    def counting(params, x, cfg, **kw):
        r = moe.routing(params, x, cfg, **kw)
        log.append(moe.assignments_dropped(r, log.n_valid))
        return apply(params, x, cfg, **kw)
    monkeypatch.setattr(blocks.moe_mod, "apply_moe", counting)
    return log


def test_params_from_jax_carries_the_experts(pair):
    cfg = pair.tcfg
    e, d, f = cfg.num_experts, cfg.d_model, cfg.expert_dff
    seg = pair.jp["seg0"]["u0"]["moe"]
    for layer in range(cfg.num_layers):
        got = pair.tp["layers"][layer]["moe"]
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            "router": (d, e), "w_up": (e, d, f), "w_gate": (e, d, f),
            "w_down": (e, f, d)}
        for name, w in got.items():
            np.testing.assert_array_equal(w.numpy(),
                                          np.asarray(seg[name])[layer])
    # (E, D, F): expert ex maps a token x to x @ w_up[ex], as JAX's einsum
    x = np.random.default_rng(0).normal(size=(d,)).astype(np.float32)
    w = pair.tp["layers"][0]["moe"]["w_up"]
    want = np.asarray(jnp.einsum("d,edf->ef", jnp.asarray(x),
                                 seg["w_up"][0]))
    np.testing.assert_allclose((_t(x) @ w).numpy(), want, **TOL)
    assert "mlp" not in pair.tp["layers"][0]


def test_apply_logits_match_jax(pair):
    tokens = np.random.default_rng(0).integers(
        0, pair.vocab, size=(2, 70)).astype(np.int32)
    for jimpl in ("reference", "interpret"):
        want = np.asarray(pair.jm.apply(pair.jp, jnp.asarray(tokens),
                                        impl=jimpl))
        for impl in (None, "kernel", "reference"):
            got = pair.tm.apply(pair.tp, _t(tokens), impl=impl)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_prefill_with_drops_and_decode_match_jax(pair, drops):
    """Two chunks of 32 at capacity factor 0.75 (cap 12 of a row's 64
    assignments an expert: full rows drop; padding routes too), then
    three paged decode steps (cap 1, nothing drops)."""
    jcfg = dataclasses.replace(pair.jcfg, moe_capacity_factor=0.75)
    tcfg = dataclasses.replace(pair.tcfg, moe_capacity_factor=0.75)
    jm = j_build(jcfg, JParallel(remat="none"))
    tm = build_model(tcfg, "cpu")
    rng = np.random.default_rng(1)
    table = np.array([[3, 7, 1, 9, 5], [2, 8, 4, 6, 10], [0] * 5], np.int32)
    jcache, tcache = jm.init_paged_cache(12, PS), tm.init_paged_cache(12, PS)
    jt, tt = jnp.asarray(table), _t(table)
    for starts, nvalid in (([0, 0, 0], [32, 9, 0]),
                           ([32, 9, 0], [20, 32, 0])):
        toks = rng.integers(0, pair.vocab, size=(3, CHUNK)).astype(np.int32)
        s, n = np.asarray(starts, np.int32), np.asarray(nvalid, np.int32)
        jl, jcache = jm.prefill_chunk_paged(
            pair.jp, jnp.asarray(toks), jcache, jt, jnp.asarray(s),
            jnp.asarray(n), impl="paged_reference")
        drops.n_valid = _t(n)
        tl, tcache = tm.prefill_chunk_paged(pair.tp, _t(toks), tcache, tt,
                                            _t(s), _t(n))
        jl, tl = np.asarray(jl), tl.numpy()
        for i in range(3):
            np.testing.assert_allclose(tl[i, :nvalid[i]], jl[i, :nvalid[i]],
                                       **TOL)
    assert len(drops) == 2 * tcfg.num_layers
    assert all(d > 0 for d, _ in drops)          # valid tokens dropped
    del drops[:]
    drops.n_valid = None
    pos = np.array([52, 41, 0], np.int32)
    for _ in range(3):
        tok = rng.integers(0, pair.vocab, size=(3,)).astype(np.int32)
        jl, jcache = jm.decode_step_paged(pair.jp, jnp.asarray(tok), jcache,
                                          jt, jnp.asarray(pos),
                                          impl="paged_reference")
        tl, tcache = tm.decode_step_paged(pair.tp, _t(tok), tcache, tt,
                                          _t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos[:2] += 1
    assert drops and all(d == 0 for d, _ in drops)


def test_dense_decode_steps_match_jax(pair):
    rng = np.random.default_rng(2)
    b, max_seq = 2, 16
    jcache = pair.jm.init_cache(b, max_seq)
    tcache = pair.tm.init_cache(b, max_seq)
    for pos in range(6):
        tok = rng.integers(0, pair.vocab, size=(b,)).astype(np.int32)
        jl, jcache = pair.jm.decode_step(pair.jp, jnp.asarray(tok), jcache,
                                         jnp.int32(pos))
        tl, tcache = pair.tm.decode_step(pair.tp, _t(tok), tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _wave(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=s), dict(max_new_tokens=n))
            for i, (s, n) in enumerate(SPEC)]


def test_engine_streams_and_host_state_match_jax(pair):
    wave = _wave(pair.vocab)
    jcore = pair.jax_core(**SERVE)
    want, jerr = drive(jcore, [wave])
    core = pair.torch_core(**SERVE, debug_invariants=True)
    got, err = drive(core, [wave])
    assert not err and not jerr
    assert all(len(got[r]) == n for r, (_, n) in enumerate(SPEC))
    exact = streams_match(pair, {r: p for r, p, _ in wave}, got, want)
    assert host_state(core, tokens_equal=exact) == \
        host_state(jcore, tokens_equal=exact)
    assert core.stats()["pages_used"] == 0


def test_dense_generate_matches_jax(pair):
    n_new, prompt_len = 8, 20
    prompts = np.random.default_rng(4).integers(
        0, pair.vocab, size=(2, prompt_len)).astype(np.int32)
    serve = dict(max_seq_len=prompt_len + n_new + 1, top_k=1)
    want = np.asarray(JEngine(model=pair.jm, params=pair.jp, cfg=pair.jcfg,
                              serve=JServe(**serve)).generate(
        jnp.asarray(prompts), n_new))
    got = ServeEngine(model=pair.tm, params=pair.tp, cfg=pair.tcfg,
                      serve=ServeConfig(**serve)).generate(prompts, n_new)
    assert tuple(got.shape) == (2, n_new)
    for row in range(2):
        margins = pair.margins(prompts[row], want[row])
        for t in range(n_new):
            if margins[t] < MARGIN:
                break                   # a near-tie: later tokens may fork
            assert int(got[row, t]) == int(want[row, t]), (row, t)


def test_moe_parallel_plans_match_jax(pair):
    """tp 2 and 4 over moe blocks factor as JAX's ``plan_tp`` does (the
    experts run whole on every rank), and a model axis of 2 builds
    (expert parallelism); the recurrent kinds still refuse a model
    axis."""
    from repro.sharding.tp import plan_tp as j_plan_tp
    cfg = pair.tcfg
    for tp in (1, 2, 4):
        got, want = plan_tp(cfg, tp, 16), j_plan_tp(pair.jcfg, tp, 16)
        assert (got.g, got.s, got.tp) == (want.g, want.s, tp)
    assert (plan_tp(cfg, 4, 16).g, plan_tp(cfg, 4, 16).s) == (2, 2)
    build_model(cfg, "cpu", parallel=ParallelConfig(model=2))
    build_model(cfg, "cpu", parallel=ParallelConfig(data=2, model=2))
    for arch in ("xlstm-125m", "hymba-1.5b"):
        with pytest.raises(NotImplementedError, match="recurrent"):
            build_model(t_reduce(t_get(arch)), "cpu",
                        parallel=ParallelConfig(model=2))


@pytest.mark.parametrize("mode,expect", [
    ([], "generated (2, 5)"),
    (["--stream", "--requests", "3"], "finished (5 tokens)"),
])
def test_serve_cli_runs_qwen3_moe_on_cpu(capsys, mode, expect):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "5", *mode])
    assert expect in capsys.readouterr().out
