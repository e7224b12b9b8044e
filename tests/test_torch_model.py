"""The port's paged model forward against the JAX package's, on the CPU.

``params_from_jax`` turns the JAX ``LM.init`` pytree into the port's
parameters; then both models run two prefill chunks (ragged ``n_valid``,
one padded batch row) and three decode steps on identical page tables,
the JAX side with ``impl="paged_reference"``.  Smoke configs are float32;
the logits must agree to 1e-4 (float32 sums in another order, through
two layers and the LM head).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import (ParallelConfig, get_model_config,  # noqa: E402
                          reduce_for_smoke)
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402
from repro_torch.config import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = ["gemma2-2b", "qwen2.5-32b", "llama2-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
PS, N_KV, CHUNK = 16, 5, 16


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = reduce_for_smoke(get_model_config(arch))
    tcfg = t_reduce(t_get(arch))
    jm = j_build(jcfg, ParallelConfig(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg, "cpu"), tp


def test_params_from_jax_unstacks_layers(pair):
    jcfg, _, jp, tcfg, _, tp = pair
    assert len(tp["layers"]) == tcfg.num_layers
    seg = jp["seg0"]
    reps = seg["u0"]["ln1"]["scale"].shape[0] \
        if seg["u0"]["ln1"]["scale"].ndim == 2 else 1
    for layer, kind in enumerate(tcfg.blocks()):
        unit = len(tcfg.blocks()) // reps
        rep, i = divmod(layer, unit)
        wq = np.asarray(seg[f"u{i}"]["attn"]["wq"])
        wq = wq[rep] if reps > 1 else wq
        np.testing.assert_array_equal(
            tp["layers"][layer]["attn"]["wq"].numpy(), wq)
    if tcfg.qkv_bias:
        assert "bq" in tp["layers"][0]["attn"]
    assert set(tp["embedding"]) == set(jp["embedding"])


def test_params_from_jax_bf16_bits():
    import ml_dtypes
    from repro_torch.convert import _tensor
    a = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16)
    t = _tensor(a, torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def _tables():
    table = np.array([[3, 7, 1, 9, 5], [2, 8, 4, 6, 10], [0] * N_KV],
                     np.int32)
    return table


def test_prefill_and_decode_logits_match_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    rng = np.random.default_rng(0)
    table = _tables()
    num_pages = 12
    jcache = jm.init_paged_cache(num_pages, PS)
    tcache = tm.init_paged_cache(num_pages, PS)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    # two chunks: row 0 fills 16 then 11 tokens, row 1 9 then 16, row 2 is
    # a padded batch row (n_valid 0, scratch table)
    for starts, nvalid in (([0, 0, 0], [16, 9, 0]),
                           ([16, 9, 0], [11, 16, 0])):
        toks = rng.integers(0, jcfg.vocab_size, size=(3, CHUNK)).astype(
            np.int32)
        s, n = np.asarray(starts, np.int32), np.asarray(nvalid, np.int32)
        jl, jcache = jm.prefill_chunk_paged(
            jp, jnp.asarray(toks), jcache, jt, jnp.asarray(s),
            jnp.asarray(n), impl="paged_reference")
        tl, tcache = tm.prefill_chunk_paged(
            tp, torch.from_numpy(toks), tcache, tt, torch.from_numpy(s),
            torch.from_numpy(n))
        jl, tl = np.asarray(jl), tl.numpy()
        assert np.isfinite(tl).all()
        for i in range(3):
            np.testing.assert_allclose(tl[i, :nvalid[i]],
                                       jl[i, :nvalid[i]], **TOL)
    pos = np.array([27, 25, 0], np.int32)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(3,)).astype(np.int32)
        jl, jcache = jm.decode_step_paged(
            jp, jnp.asarray(tok), jcache, jt, jnp.asarray(pos),
            impl="paged_reference")
        tl, tcache = tm.decode_step_paged(
            tp, torch.from_numpy(tok), tcache, tt, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos[:2] += 1
    # the pools hold the same K/V wherever a sequence owns a page
    for layer, (k, _) in enumerate(tcache):
        jk = _jax_pool(jcache, jm, layer)
        owned = table[:2].ravel()
        np.testing.assert_allclose(k.numpy()[:, owned], jk[:, owned], **TOL)


def _jax_pool(cache, jm, layer):
    """K pool of ``layer`` from the JAX model's (scan-stacked) cache."""
    from repro.models.lm import periodic_segments
    li = 0
    for si, (unit, reps) in enumerate(periodic_segments(jm.cfg)):
        for rep in range(reps):
            for i in range(len(unit)):
                if li == layer:
                    k = np.asarray(cache[f"seg{si}"][f"u{i}"].k)
                    return k[rep] if reps > 1 else k
                li += 1
    raise IndexError(layer)


def test_model_device_defaults_to_cuda():
    cfg = t_reduce(t_get("llama2-7b"))
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, cfg)


@pytest.mark.parametrize("arch", ["hymba-1.5b"])
def test_unported_block_kinds_raise(arch):
    from repro_torch.config import ModelConfig
    jcfg = reduce_for_smoke(get_model_config(arch))
    cfg = ModelConfig(**jcfg.__dict__)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg, "cpu")


def test_init_matches_jax_shapes_and_scale():
    cfg = t_reduce(t_get("gemma2-2b"))
    jcfg = reduce_for_smoke(get_model_config("gemma2-2b"))
    jp = j_build(jcfg, ParallelConfig(remat="none")).init(
        jax.random.PRNGKey(0))
    ref = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    model = build_model(cfg, "cpu")
    got = model.init(model.generator(0))

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    a, b = dict(leaves(got)), dict(leaves(ref))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    w = got["layers"][0]["mlp"]["w_up"]
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.1 * \
        cfg.d_model ** -0.5
