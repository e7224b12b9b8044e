"""The port's EngineCore against the JAX package's, on the CPU.

Reduced gemma2-2b (GQA, sliding window, softcaps, post-norms, GeGLU) with
the JAX model's own weights (``params_from_jax``), the traffic of the
first section of ``examples/continuous_batching.py``: 6 requests, 3 slots,
16-token pages and prefill chunks, the pool at its auto size.  Greedy
streams must equal the JAX engine's up to the first token whose top-1
margin in the JAX model is under 1e-4 (a float32 tie the two frameworks
may break differently).  Host state must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig  # noqa: E402
from repro.config import ServeConfig as JServe  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.core import EngineCore as JCore  # noqa: E402
from repro.serving.scheduler import SamplingParams as JParams  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.core import (EngineCore, sample_token,  # noqa: E402
                                      stream_seed)
from repro_torch.serving.scheduler import (ABORTED, FINISHED,  # noqa: E402
                                           SamplingParams)

SERVE = dict(max_batch=3, max_seq_len=96, page_size=16, prefill_chunk=16,
             prefill_token_budget=16)
SPEC = [(5, 6), (9, 3), (3, 10), (7, 4), (12, 5), (60, 4)]
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = reduce_for_smoke(get_model_config("gemma2-2b"))
    tcfg = t_reduce(t_get("gemma2-2b"))
    jm = j_build(jcfg, ParallelConfig(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=s) for s, _ in SPEC]
    return jcfg, jm, jp, tcfg, build_model(tcfg, "cpu"), tp, prompts


def _core(setup, **kw):
    _, _, _, tcfg, tm, tp, _ = setup
    return EngineCore(tm, tp, tcfg, ServeConfig(**{**SERVE, **kw}),
                      device="cpu")


def _drain(core, ids):
    out = {i: [] for i in ids}
    while core.has_work:
        for ev in core.step():
            if ev.kind == "token":
                out[ev.request_id].append(ev.token)
    return out


def _margins(jm, jp, prompt, generated):
    """Top-1 margin of the JAX model at every generated position
    (teacher-forced full forward)."""
    seq = np.concatenate([prompt, generated[:-1]]).astype(np.int32)
    logits = np.asarray(jm.apply(jp, jnp.asarray(seq[None])))[0]
    rows = logits[len(prompt) - 1:]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_greedy_streams_match_jax_engine(setup):
    jcfg, jm, jp, _, _, _, prompts = setup
    jcore = JCore(jm, jp, jcfg, JServe(**SERVE))
    jids = [jcore.add_request(p, JParams(max_new_tokens=n))
            for p, (_, n) in zip(prompts, SPEC)]
    want = _drain(jcore, jids)
    core = _core(setup)
    ids = [core.add_request(p, SamplingParams(max_new_tokens=n))
           for p, (_, n) in zip(prompts, SPEC)]
    got = _drain(core, ids)
    assert ids == jids
    for rid, prompt in zip(ids, prompts):
        w, g = want[rid], got[rid]
        assert len(g) == len(w)
        margins = _margins(jm, jp, prompt, np.asarray(w))
        for t, (a, b) in enumerate(zip(g, w)):
            if margins[t] < MARGIN:
                break                   # a near-tie: later tokens may fork
            assert a == b, (rid, t, g, w)
    st, jst = core.stats(), jcore.stats()
    for key in ("steps", "finished", "pages_used", "pages_peak",
                "prefill_launches", "events_emitted"):
        assert st[key] == jst[key], key
    assert st["pages_used"] == 0


def test_abort_mid_flight_frees_pages(setup):
    *_, prompts = setup
    core = _core(setup, debug_invariants=True)
    ids = [core.add_request(p, SamplingParams(max_new_tokens=8))
           for p in prompts]
    early = core.step() + core.step()
    # one request decoding, the 60-token prompt still waiting/prefilling
    assert core.abort(ids[0])
    assert core.abort(ids[5])
    assert not core.abort(ids[5])               # idempotent
    assert not core.abort(12345)
    out = _drain(core, ids)
    assert core.stats()["pages_used"] == 0
    assert core.stats()["aborts"] == 2
    core.mgr.check_invariants()
    counts = {rid: len(out[rid]) + sum(ev.request_id == rid for ev in early)
              for rid in ids}
    for rid in ids[1:5]:
        assert counts[rid] == 8
    assert all(r.state == FINISHED for r in core.sched.finished)
    assert core.get_request(ids[0]) is None


def test_abort_waiting_request(setup):
    *_, prompts = setup
    core = _core(setup)
    ids = [core.add_request(p, SamplingParams(max_new_tokens=2))
           for p in prompts[:4]]
    req = core.sched.waiting[-1]
    assert core.abort(ids[3]) and req.state == ABORTED
    out = _drain(core, ids)
    assert out[ids[3]] == [] and core.stats()["pages_used"] == 0


def test_seeded_sampling_replays_and_ignores_batch(setup):
    *_, prompts = setup
    sp = SamplingParams(temperature=0.8, top_k=8, seed=42, max_new_tokens=6)

    def run(co_tenants):
        core = _core(setup)
        others = [core.add_request(p, SamplingParams(max_new_tokens=5))
                  for p in prompts[:co_tenants]]
        rid = core.add_request(prompts[3], sp)
        return _drain(core, others + [rid])[rid]

    alone = run(0)
    assert len(alone) == 6
    assert run(0) == alone                   # exact replay
    assert run(2) == alone                   # co-tenants do not matter
    other_seed = SamplingParams(temperature=0.8, top_k=8, seed=7,
                                max_new_tokens=6)
    core = _core(setup)
    rid = core.add_request(prompts[3], other_seed)
    assert _drain(core, [rid])[rid] != alone


def test_sample_token_topk_and_stream_seed():
    logits = torch.tensor([[0.0, 5.0, 4.9, -3.0]])
    assert int(sample_token(logits, None, temperature=0.0)) == 1
    gen = torch.Generator().manual_seed(0)
    seen = {int(sample_token(logits, gen, temperature=1.0, top_k=2))
            for _ in range(50)}
    assert seen <= {1, 2} and len(seen) == 2
    assert stream_seed(1, 0) != stream_seed(1, 1) != stream_seed(2, 0)
    assert 0 <= stream_seed(2 ** 40, 7) < 2 ** 63


def test_stop_strings_trim_the_stream(setup):
    *_, prompts = setup
    core = _core(setup, metrics=False)
    plain = core.add_request(prompts[0], SamplingParams(max_new_tokens=6))
    toks = _drain(core, [plain])[plain]

    def detok(ids):
        return "".join(f"<{t}>" for t in ids)

    stop = f"<{toks[2]}>"
    first = toks.index(toks[2])       # the first occurrence ends the stream
    core = EngineCore(core.model, core.params, core.cfg, core.serve,
                      device="cpu", detokenize=detok)
    rid = core.add_request(prompts[0], SamplingParams(
        max_new_tokens=6, stop_strings=(stop,)))
    events = []
    while core.has_work:
        events += core.step()
    assert [e.token for e in events if e.kind == "token"] == toks[:first]
    assert events[-1].kind == "stop" and events[-1].detail == stop
    assert events[-1].finished and core.stats()["pages_used"] == 0


def test_deadline_times_out_with_fake_clock(setup):
    *_, prompts = setup
    now = [0.0]
    _, _, _, tcfg, tm, tp, _ = setup
    core = EngineCore(tm, tp, tcfg, ServeConfig(**SERVE), device="cpu",
                      clock=lambda: now[0])
    rid = core.add_request(prompts[1], SamplingParams(
        max_new_tokens=8, deadline_ms=50))
    keep = core.add_request(prompts[2], SamplingParams(max_new_tokens=3))
    events = core.step()
    now[0] = 1.0
    events += core.step()
    err = [e for e in events if e.kind == "error"]
    assert [e.request_id for e in err] == [rid]
    assert err[0].detail.startswith("timeout")
    while core.has_work:
        events += core.step()
    kept = [e for e in events if e.request_id == keep]
    assert len(kept) == 3 and kept[-1].finished
    assert core.stats()["pages_used"] == 0
    assert core.stats()["health"]["timed_out"] == 1


def test_bounded_queue_rejects(setup):
    *_, prompts = setup
    core = _core(setup, max_waiting=1)
    core.add_request(prompts[0], SamplingParams(max_new_tokens=2))
    from repro_torch.serving.faults import RequestRejected
    with pytest.raises(RequestRejected):
        core.add_request(prompts[1], SamplingParams(max_new_tokens=2))


@pytest.mark.parametrize("kw", [
    {"spec_mode": "lookup"}, {"tp": 2}, {"prefix_cache": True},
    {"prefill_mode": "scan"}, {"num_pages": 10}, {"injector": True}])
def test_unsupported_configs_raise(setup, kw):
    _, _, _, tcfg, tm, tp, _ = setup
    kw = dict(kw)
    injector = kw.pop("injector", None)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        EngineCore(tm, tp, tcfg, ServeConfig(**{**SERVE, **kw}),
                   device="cpu", injector=injector)


def test_engine_defaults_to_cuda(setup):
    _, _, _, tcfg, tm, tp, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCore(tm, tp, tcfg, ServeConfig(**SERVE))
