"""The port's dense-cache decode path against the JAX package's, on the CPU.

* the plain ``flash_decode`` (the wrapper on CPU tensors) against the JAX
  ``flash_decode_fwd`` in interpret mode, as
  ``tests/test_kernels_decode.py`` runs it, in both cache layouts;
* the dense branches of ``fast_attention_decode`` against JAX's
  ``impl="reference"``;
* ``LM.init_cache`` / ``LM.decode_step`` logits and caches over 6 steps on
  reduced gemma2-2b (window, softcaps, GQA), qwen2.5-32b (qkv bias) and
  llama2-7b, with the JAX model's weights (``params_from_jax``);
* ``ServeEngine.generate`` greedy tokens against JAX's, the dense engine
  against the port's own paged ``EngineCore``, and ``generate_stream``
  against the core's own events;
* the serving entry point ``python -m repro_torch.launch.serve`` in its
  dense, ``--stream`` and ``--offload-report`` modes.

Inputs are float32, made with numpy from a seed.  Tolerances: 1e-5
(rtol and atol) for the attention functions, where only the order of
float32 sums differs; 1e-4 for model logits (the same through two layers
and the LM head).  Greedy tokens must be equal up to the first position
whose top-1 margin in the JAX model is under 1e-4 (a float32 near-tie the
two frameworks may break differently).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig  # noqa: E402
from repro.config import ServeConfig as JServe  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.core.fastattention import \
    fast_attention_decode as j_decode  # noqa: E402
from repro.kernels.flash_decode.kernel import flash_decode_fwd  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.lm import periodic_segments  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.fastattention import fast_attention_decode  # noqa: E402
from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: E402
from repro_torch.layers.attention import KV_CACHE_LAYOUT  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.core import EngineCore, StreamEvent  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import Request, SamplingParams  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4

# (b, hq, hkv, s, d, lens, window, softcap): ragged kv_len, GQA, window,
# softcap, a cache length that is no multiple of block_kv, a length-1 row
DECODE_CASES = [
    (2, 10, 2, 1024, 64, [1000, 321], None, None),
    (2, 4, 4, 512, 64, [512, 77], None, None),
    (2, 8, 2, 1000, 64, [900, 400], 256, None),
    (1, 4, 1, 512, 32, [511], None, 30.0),
    (3, 2, 1, 64, 16, [1, 33, 64], None, None),
    (2, 16, 2, 768, 128, [768, 500], 300, 20.0),
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(rng, b, hq, hkv, s, d):
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("block_kv", [128, 512])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_plain_flash_decode_matches_jax_kernel(case, layout, block_kv):
    b, hq, hkv, s, d, lens, window, softcap = case
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, b, hq, hkv, s, d)
    kv_len = np.asarray(lens, np.int32)
    want = np.asarray(flash_decode_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        window=window, softcap=softcap, block_kv=block_kv, interpret=True))
    kt, vt = _t(k), _t(v)
    if layout == "bshd":
        kt, vt = _t(k.transpose(0, 2, 1, 3)), _t(v.transpose(0, 2, 1, 3))
    before = flash_decode.launches
    got = flash_decode(_t(q), kt, vt, _t(kv_len), window=window,
                       softcap=softcap, layout=layout)
    assert flash_decode.launches == before      # the plain version ran
    assert got.shape == (b, hq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_flash_decode_reads_strided_views():
    """A "bhsd" view of a "bshd" cache (no copy) gives what the copy
    gives."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 8, 2, 96, 32)
    kv_len = _t(np.asarray([96, 40], np.int32))
    k_bshd, v_bshd = _t(k.transpose(0, 2, 1, 3)), _t(v.transpose(0, 2, 1, 3))
    view = flash_decode(_t(q), k_bshd.transpose(1, 2),
                        v_bshd.transpose(1, 2), kv_len, layout="bhsd")
    copy = flash_decode(_t(q), _t(k), _t(v), kv_len, layout="bhsd")
    torch.testing.assert_close(view, copy, rtol=0, atol=0)
    with pytest.raises(ValueError, match="layout"):
        flash_decode(_t(q), _t(k), _t(v), kv_len, layout="sbhd")


@pytest.mark.parametrize("impl", [None, "reference", "kernel", "pallas"])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("case", DECODE_CASES[1:4] + DECODE_CASES[5:])
def test_dense_decode_facade_matches_jax_reference(case, layout, impl):
    b, hq, hkv, s, d, lens, window, softcap = case
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, b, hq, hkv, s, d)
    q = q[:, None]                                  # (B, 1, Hq, D)
    if layout == "bshd":
        k, v = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    kv_len = np.asarray(lens, np.int32)
    want = np.asarray(j_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        window=window, softcap=softcap, impl="reference", layout=layout))
    got = fast_attention_decode(_t(q), _t(k), _t(v), _t(kv_len),
                                window=window, softcap=softcap, impl=impl,
                                layout=layout)
    assert got.shape == (b, 1, hq, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dense_decode_facade_refuses_paged_impls_without_a_table():
    q = torch.zeros((1, 1, 2, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="unknown fastattn impl 'paged'"):
        fast_attention_decode(q, k, k, torch.ones(1, dtype=torch.int32),
                              impl="paged")


# ---------------------------------------------------------------------------
# the model: LM.init_cache / LM.decode_step
# ---------------------------------------------------------------------------

ARCHS = ["gemma2-2b", "qwen2.5-32b", "llama2-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = reduce_for_smoke(get_model_config(arch))
    tcfg = t_reduce(t_get(arch))
    jm = j_build(jcfg, ParallelConfig(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg, "cpu"), tp


def _jax_cache_k(cache, jm, layer):
    """K cache of ``layer`` from the JAX model's (scan-stacked) cache."""
    li = 0
    for si, (unit, reps) in enumerate(periodic_segments(jm.cfg)):
        for rep in range(reps):
            for i in range(len(unit)):
                if li == layer:
                    k = np.asarray(cache[f"seg{si}"][f"u{i}"].k)
                    return k[rep] if reps > 1 else k
                li += 1
    raise IndexError(layer)


def test_decode_step_logits_and_caches_match_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    b, max_seq, steps = 3, 40, 6
    jcache = jm.init_cache(b, max_seq)
    tcache = tm.init_cache(b, max_seq)
    assert KV_CACHE_LAYOUT == "bshd"
    assert len(tcache) == tcfg.num_layers
    assert tuple(tcache[0].k.shape) == (b, max_seq, tcfg.num_kv_heads,
                                        tcfg.head_dim)
    # the window of reduced gemma2-2b (32) is passed by the last steps
    positions = [0, 1, 2, 3, 33, 34]
    rng = np.random.default_rng(3)
    for pos in positions[:steps]:
        tok = rng.integers(0, jcfg.vocab_size, size=(b,)).astype(np.int32)
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache,
                                    jnp.int32(pos))
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache, pos)
        assert tl.shape == (b, tcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for layer, (k, _) in enumerate(tcache):
        np.testing.assert_allclose(k.numpy(), _jax_cache_k(jcache, jm, layer),
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma():
    jcfg = reduce_for_smoke(get_model_config("gemma2-2b"))
    tcfg = t_reduce(t_get("gemma2-2b"))
    jm = j_build(jcfg, ParallelConfig(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg, "cpu"), tp


def _margins(jm, jp, prompt, generated):
    """Top-1 margin of the JAX model at every generated position
    (teacher-forced full forward)."""
    seq = np.concatenate([prompt, generated[:-1]]).astype(np.int32)
    logits = np.asarray(jm.apply(jp, jnp.asarray(seq[None])))[0]
    rows = logits[len(prompt) - 1:]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_generate_greedy_matches_jax(gemma):
    jcfg, jm, jp, tcfg, tm, tp = gemma
    n_new, prompt_len = 8, 12
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(2, prompt_len)).astype(np.int32)
    serve = dict(max_seq_len=prompt_len + n_new + 1, top_k=1)
    want = np.asarray(JEngine(model=jm, params=jp, cfg=jcfg,
                              serve=JServe(**serve)).generate(
        jnp.asarray(prompts), n_new))
    got = ServeEngine(model=tm, params=tp, cfg=tcfg,
                      serve=ServeConfig(**serve)).generate(prompts, n_new)
    assert tuple(got.shape) == (2, n_new)
    for row in range(2):
        margins = _margins(jm, jp, prompts[row], want[row])
        for t in range(n_new):
            if margins[t] < MARGIN:
                break                   # a near-tie: later tokens may fork
            assert int(got[row, t]) == int(want[row, t]), (row, t)


def test_dense_generate_equals_paged_stream(gemma):
    """The dense path is the paged engine's oracle: greedy streams of the
    port's EngineCore equal the port's dense generate (the JAX package's
    tests/test_scheduler.py holds its own two paths so)."""
    *_, tcfg, tm, tp = gemma
    serve = ServeConfig(max_batch=2, max_seq_len=64, top_k=1, page_size=16)
    engine = ServeEngine(model=tm, params=tp, cfg=tcfg, serve=serve)
    rng = np.random.default_rng(1)
    for n in (6, 21):
        prompt = rng.integers(0, tcfg.vocab_size, size=n)
        dense = engine.generate(prompt[None], 8)[0].tolist()
        req = Request(id=n, prompt=prompt, max_new_tokens=8)
        list(engine.generate_stream([req]))
        assert req.generated == dense


def test_generate_stream_events_equal_core_events(gemma):
    *_, tcfg, tm, tp = gemma
    serve = ServeConfig(max_batch=2, max_seq_len=64, page_size=16)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n) for n in (5, 19, 9)]
    params = [SamplingParams(max_new_tokens=4),
              SamplingParams(temperature=0.8, top_k=8, seed=3,
                             max_new_tokens=6),
              SamplingParams(max_new_tokens=5)]
    core = EngineCore(tm, tp, tcfg, serve, device="cpu")
    for i, (p, sp) in enumerate(zip(prompts, params)):
        core.add_request(p, sp, request_id=i)
    want = []
    while core.has_work:
        want += core.step()
    engine = ServeEngine(model=tm, params=tp, cfg=tcfg, serve=serve)
    reqs = [Request(id=i, prompt=p, sampling=sp)
            for i, (p, sp) in enumerate(zip(prompts, params))]
    got = list(engine.generate_stream(reqs))
    assert got == want
    assert engine.last_cache.used_pages == 0
    assert engine.core.stats()["orphan_events_pending"] == 0


def test_stream_routes_foreign_events_to_orphans(gemma):
    """Events of a request submitted straight to the core while a
    generate_stream drains land in core.orphan_events; the bounded
    buffer counts what it drops; the telemetry exports render."""
    *_, tcfg, tm, tp = gemma
    serve = ServeConfig(max_batch=2, max_seq_len=64, page_size=16)
    engine = ServeEngine(model=tm, params=tp, cfg=tcfg, serve=serve)
    rng = np.random.default_rng(6)
    core = engine.core
    foreign = core.add_request(rng.integers(0, 256, size=7),
                               SamplingParams(max_new_tokens=3),
                               request_id=99)
    req = Request(id=1, prompt=rng.integers(0, 256, size=11),
                  max_new_tokens=5)
    mine = list(engine.generate_stream([req]))
    assert [e.token for e in mine] == req.generated
    orphans = [e for e in core.orphan_events if e.request_id == foreign]
    assert len(orphans) == 3 and orphans[-1].finished
    cap = core.orphan_events.maxlen
    for i in range(cap + 7):
        core.orphan_events.append(StreamEvent(0, i, i, False))
    st = core.stats()
    assert st["orphan_events_pending"] == cap
    assert st["orphans_dropped"] == 7 + 3
    assert "engine_steps_total" in engine.core.export_prometheus()
    assert engine.core.chrome_trace()["traceEvents"]


def test_abandoned_stream_aborts_its_requests(gemma):
    *_, tcfg, tm, tp = gemma
    serve = ServeConfig(max_batch=2, max_seq_len=64, page_size=16)
    engine = ServeEngine(model=tm, params=tp, cfg=tcfg, serve=serve)
    reqs = [Request(id=i, prompt=np.arange(1, 9), max_new_tokens=20)
            for i in range(3)]
    stream = engine.generate_stream(reqs)
    next(stream)
    stream.close()
    assert engine.core.stats()["pages_used"] == 0
    assert engine.core.stats()["aborts"] == 3
    assert not engine.core.has_work


def test_throughput_reads_the_injected_clock(gemma):
    *_, tcfg, tm, tp = gemma
    ticks = iter(range(100))
    engine = ServeEngine(model=tm, params=tp, cfg=tcfg,
                         serve=ServeConfig(max_seq_len=32),
                         clock=lambda: float(next(ticks)))
    assert engine.throughput_tokens_per_s(2, 6, n_new=4) == 2 * 4 / 1.0


def test_serve_engine_refuses_an_injector(gemma):
    """The engine takes a fault injector and hands it to its core (as the
    JAX engine does), and passes tp to it: without a process group of tp
    ranks the core refuses."""
    from repro_torch.serving.faults import FaultInjector
    *_, tcfg, tm, tp = gemma
    inj = FaultInjector(seed=0)
    engine = ServeEngine(model=tm, params=tp, cfg=tcfg, injector=inj)
    assert engine.core.injector is inj
    assert engine.core.mgr.injector is inj
    assert engine.last_pressure.injector is inj
    refused = ServeEngine(model=tm, params=tp, cfg=tcfg, injector=inj,
                          serve=ServeConfig(tp=2))
    with pytest.raises(ValueError, match="tp=2 needs a torch.distributed"):
        refused.core


# ---------------------------------------------------------------------------
# the serving entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,expect", [
    ([], "generated (2, 5)"),
    (["--stream", "--requests", "4", "--metrics"], "engine_steps_total"),
    (["--offload-report"], "T4 offload plan: L_GPU=2 L_CPU=0"),
])
def test_serve_cli_on_cpu(capsys, mode, expect):
    from repro_torch.launch import serve
    serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "5", *mode])
    out = capsys.readouterr().out
    assert expect in out
    if "--stream" in mode:
        assert out.count("finished (5 tokens)") == 4


def test_serve_cli_refuses_speculation(capsys):
    """The CLI refuses an unknown drafter and serves ``--spec-mode
    lookup`` through the engine's verify launches."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--spec-mode", "draft"])
    capsys.readouterr()
    serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                "--stream", "--requests", "3", "--prompt-len", "21",
                "--gen", "6", "--spec-mode", "lookup", "--spec-tokens", "3"])
    out = capsys.readouterr().out
    assert out.count("finished (6 tokens)") == 3
    assert "speculation:" in out and " 0 verify launches" not in out
