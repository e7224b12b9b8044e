"""Head dims 80 and 96 in the port against the JAX package, on the CPU:
phi3-mini-3.8b (D = 96) and stablelm-3b (D = 80).

The port's two configs equal JAX's field for field (but the impl
default).  Each reduced config (2 layers, 2 heads, float32, the JAX
model's own weights through ``params_from_jax``) keeps its real head dim;
its d_model stays the reduced 32, so q, k and v project to 2 x D columns
and no module may assume D = d_model / heads.  Held to JAX there:
``LM.apply`` logits (the JAX Pallas kernel in interpret mode and its plain
reference) within 1e-4; the paged ``EngineCore``'s greedy streams under
the margin rule of ``tests/_torch_engine_pair.py``, host state, pages and
steps exactly; dense ``ServeEngine.generate`` under the same rule.  Each
attention module's wrapper (its plain version on CPU tensors) is held to
its JAX kernel in interpret mode at D = 80 and 96 within 1e-5 (only the
order of float32 sums differs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_engine_pair import (MARGIN, drive, host_state,  # noqa: E402
                                pair_on_one_thread, streams_match)
from repro.config import ServeConfig as JServe  # noqa: E402
from repro.config import get_model_config  # noqa: E402
from repro.kernels.fastattn.kernel import \
    fastattn_fwd as j_fastattn_fwd  # noqa: E402
from repro.kernels.fastattn.kernel import paged_prefill_fwd  # noqa: E402
from repro.kernels.flash_decode.kernel import (  # noqa: E402
    flash_decode_fwd, paged_flash_decode_fwd)
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.kernels import _launch  # noqa: E402
from repro_torch.kernels.fastattn.ops import (  # noqa: E402
    fastattn_fwd, fastattn_paged_prefill)
from repro_torch.kernels.flash_decode.ops import (  # noqa: E402
    flash_decode, paged_flash_decode)
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCHS = {"phi3-mini-3.8b": 96, "stablelm-3b": 80}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
# 4 slots over 6 requests of 5-40 prompt tokens: chunked prefill across
# 16-token pages, decode steps at every slot, a slot reused
SERVE = dict(max_batch=4, max_seq_len=64, page_size=16, prefill_chunk=16)
SPEC = [(5, 9), (17, 6), (40, 12), (9, 3), (23, 8), (12, 10)]


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    with pair_on_one_thread(request.param, ARCHS[request.param]) as p:
        yield p


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_is_a_copy_of_jax(arch):
    got = dataclasses.asdict(t_get(arch))
    want = dataclasses.asdict(get_model_config(arch))
    assert got.pop("attention_impl") == "auto"
    want.pop("attention_impl")
    assert got == want
    cfg = t_get(arch)
    assert cfg.head_dim == ARCHS[arch] in _launch.HEAD_DIMS
    assert cfg.num_layers == 32 and cfg.num_heads == cfg.num_kv_heads == 32
    assert cfg.norm_type == ("layernorm" if arch == "stablelm-3b"
                             else "rmsnorm")


def test_reduced_configs_keep_the_real_head_dim(pair):
    for cfg in (pair.jcfg, pair.tcfg):
        assert cfg.head_dim in (80, 96) and cfg.num_layers == 2
        assert cfg.num_heads == 2 and cfg.d_model != cfg.q_dim
    assert dataclasses.asdict(pair.tcfg) == {
        **dataclasses.asdict(pair.jcfg), "attention_impl": "auto"}


def test_apply_logits_match_jax(pair):
    tokens = np.random.default_rng(0).integers(
        0, pair.vocab, size=(2, 70)).astype(np.int32)
    for jimpl in ("reference", "interpret"):
        want = np.asarray(pair.jm.apply(pair.jp, jnp.asarray(tokens),
                                        impl=jimpl))
        for impl in (None, "kernel", "reference"):
            got = pair.tm.apply(pair.tp, _t(tokens), impl=impl)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


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


# ---------------------------------------------------------------------------
# each attention module at D = 80 and 96, against its JAX kernel
# ---------------------------------------------------------------------------

def _pools(rng, hkv, num_pages, ps, d):
    return [rng.normal(size=(hkv, num_pages, ps, d)).astype(np.float32)
            for _ in range(2)]


def _table(rng, b, n_kv, num_pages):
    perm = rng.permutation(np.arange(1, num_pages))[:b * n_kv]
    return perm.reshape(b, n_kv).astype(np.int32)


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("hq,hkv,window,softcap", [(4, 4, None, None),
                                                   (8, 2, 40, 30.0)])
def test_paged_decode_matches_jax_kernel(d, hq, hkv, window, softcap):
    b, ps, n_kv = 3, 16, 6
    rng = np.random.default_rng(d)
    num_pages = b * n_kv + 3
    kp, vp = _pools(rng, hkv, num_pages, ps, d)
    table = _table(rng, b, n_kv, num_pages)
    table[-1] = 0
    lens = np.asarray([96, 37, 1], np.int32)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    want = paged_flash_decode_fwd(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), window=window, softcap=softcap, interpret=True)
    before = paged_flash_decode.launches
    got = paged_flash_decode(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                             window=window, softcap=softcap)
    assert paged_flash_decode.launches == before     # the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("hq,hkv,window,softcap", [(4, 4, None, None),
                                                   (4, 2, 24, 30.0)])
def test_paged_prefill_matches_jax_kernel(d, hq, hkv, window, softcap):
    ps, n_kv, chunk = 16, 6, 32
    starts = np.asarray([0, 50, 0], np.int32)
    nvalid = np.asarray([32, 11, 0], np.int32)
    b = len(starts)
    rng = np.random.default_rng(d + 1)
    num_pages = b * n_kv + 3
    kp, vp = _pools(rng, hkv, num_pages, ps, d)
    table = _table(rng, b, n_kv, num_pages)
    table[nvalid == 0] = 0
    lens = starts + nvalid
    q = rng.normal(size=(b, hq, chunk, d)).astype(np.float32)
    want = np.asarray(paged_prefill_fwd(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(lens), window=window,
        softcap=softcap, block_q=32, interpret=True))
    got = fastattn_paged_prefill(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(starts), _t(lens), window=window,
                                 softcap=softcap).numpy()
    for i in range(b):
        n = int(nvalid[i])
        if n == 0:
            assert (got[i] == 0).all()          # no valid key -> exactly 0
            continue
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], **TOL)


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("causal,window,softcap,q_offset,kv_valid", [
    (True, None, None, 0, None), (True, 40, 30.0, 20, 120)])
def test_fastattn_fwd_matches_jax_kernel(d, causal, window, softcap,
                                         q_offset, kv_valid):
    rng = np.random.default_rng(d + 2)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 4, 100, d), (1, 2, 130, d), (1, 2, 130, d)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_valid=kv_valid)
    want = np.asarray(j_fastattn_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
        block_kv1=64, block_kv2=32, interpret=True, **kw))
    before = fastattn_fwd.launches
    got = fastattn_fwd(_t(q), _t(k), _t(v), **kw).numpy()
    assert fastattn_fwd.launches == before
    # every row of these masks sees at least one key
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_decode_matches_jax_kernel(d, layout):
    rng = np.random.default_rng(d + 3)
    b, hq, hkv, s = 2, 8, 2, 300
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    lens = np.asarray([300, 159], np.int32)
    want = np.asarray(flash_decode_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        block_kv=128, interpret=True))
    kt, vt = _t(k), _t(v)
    if layout == "bshd":
        kt, vt = _t(k.transpose(0, 2, 1, 3)), _t(v.transpose(0, 2, 1, 3))
    got = flash_decode(_t(q), kt, vt, _t(lens), layout=layout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
