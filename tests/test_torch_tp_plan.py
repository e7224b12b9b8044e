"""The port's tensor-parallel plan, weight slicing, chunking and paged
helpers against the JAX package, in one process (no ranks): ``plan_tp``
and ``chunk_sizes`` give JAX's answers or JAX's errors, the rank slices
of ``shard_params`` add up to the unsharded projections, the paged TP
helpers equal JAX's exactly, and an engine asked for ``tp > 1`` without
a process group of that size refuses."""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import get_model_config as j_get
from repro.config import reduce_for_smoke as j_reduce
from repro.core import distributed_decode as jdd
from repro.core.tiled_allreduce import chunk_sizes as j_chunk_sizes
from repro.sharding.tp import plan_tp as j_plan_tp
from repro_torch.config import ServeConfig, get_model_config
from repro_torch.config import reduce_for_smoke
from repro_torch.core import distributed_decode as dd
from repro_torch.core.tiled_allreduce import chunk_sizes
from repro_torch.layers import mlp as mlp_mod
from repro_torch.models import build_model
from repro_torch.serving.core import EngineCore
from repro_torch.sharding.tp import (TPContext, mlp_sharded, plan_tp,
                                     shard_params, tp_context)

ARCHS = [(a, r) for a in ("gemma2-2b", "qwen2.5-32b", "llama2-7b")
         for r in (True, False)]


def _cfgs(arch, reduced):
    j, t = j_get(arch), get_model_config(arch)
    return (j_reduce(j), reduce_for_smoke(t)) if reduced else (j, t)


def _outcome(fn):
    try:
        p = fn()
    except ValueError as e:
        return ("ValueError", str(e))
    return (p.g, p.s, p.tp, p.collectives, p.ar_chunks, p.first_chunk_frac)


@pytest.mark.parametrize("arch,reduced", ARCHS)
@pytest.mark.parametrize("tp", range(1, 9))
def test_plan_tp_equals_jax(arch, reduced, tp):
    jcfg, tcfg = _cfgs(arch, reduced)
    for ps, coll in itertools.product((3, 16, 128), ("tiled", "single")):
        want = _outcome(lambda: j_plan_tp(jcfg, tp, ps, collectives=coll))
        got = _outcome(lambda: plan_tp(tcfg, tp, ps, collectives=coll))
        assert got == want, (arch, reduced, tp, ps, coll)


@pytest.mark.parametrize("bad", [dict(tp=0), dict(collectives="ring")])
def test_plan_tp_refusals_equal_jax(bad):
    kw = {**dict(tp=2, page_size=16, collectives="tiled"), **bad}
    j = _outcome(lambda: j_plan_tp(j_get("llama2-7b"), kw["tp"],
                                   kw["page_size"],
                                   collectives=kw["collectives"]))
    t = _outcome(lambda: plan_tp(get_model_config("llama2-7b"), kw["tp"],
                                 kw["page_size"],
                                 collectives=kw["collectives"]))
    assert t == j and t[0] == "ValueError"


CHUNK_CASES = [(16, 2, 1.0, 4), (64, 4, 0.5, 8), (8, 4, 0.5, 4),
               (128, 4, 0.5, 1), (12, 5, 0.25, 4), (4, 4, 0.5, 4),
               (96, 3, 0.5, 32), (37, 4, 0.5, 1), (50, 4, 1.0, 2),
               (1, 4, 0.5, 1), (10, 2, 1.0, 4), (0, 4, 0.5, 1),
               (-3, 2, 0.5, 1), (7, 0, 0.5, 1), (4096, 4, 0.5, 1)]


@pytest.mark.parametrize("total,n,frac,align", CHUNK_CASES)
def test_chunk_sizes_equals_jax(total, n, frac, align):
    def run(fn):
        try:
            return list(fn(total, n, frac, align=align))
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(chunk_sizes) == run(j_chunk_sizes)


# ---------------------------------------------------------------------------
# shard_params: the rank slices add up to the whole projections
# ---------------------------------------------------------------------------

def _model(arch):
    cfg = reduce_for_smoke(get_model_config(arch))
    model = build_model(cfg, "cpu")
    return cfg, model.init(model.generator(0))


# (g, s): gemma2-2b (2, 1) and (2, 2); qwen2.5-32b, with qkv biases and
# 5 query heads a kv head, (2, 1) and (1, 5)
@pytest.mark.parametrize("arch,tp", [("gemma2-2b", 2), ("gemma2-2b", 4),
                                     ("qwen2.5-32b", 2),
                                     ("qwen2.5-32b", 5)])
def test_shard_params_add_up_to_the_whole(arch, tp):
    cfg, params = _model(arch)
    plan = plan_tp(cfg, tp, 20 if tp == 5 else 16)
    shards = [shard_params(params, cfg, plan, r) for r in range(tp)]
    x = torch.randn((5, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    dh = cfg.head_dim
    for li, whole in enumerate(params["layers"]):
        wa = whole["attn"]
        for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
            if name not in wa:
                continue
            # the group's columns: ranks of one group hold the same, and
            # the groups in order make the whole
            cols = [shards[gi * plan.s]["layers"][li]["attn"][name]
                    for gi in range(plan.g)]
            for r in range(tp):
                torch.testing.assert_close(
                    shards[r]["layers"][li]["attn"][name],
                    cols[r // plan.s], rtol=0, atol=0)
            torch.testing.assert_close(torch.cat(cols, dim=-1), wa[name],
                                       rtol=0, atol=0)
        # O-proj: each rank's query-head slice against its wo rows
        q = x @ wa["wq"]
        hq_s = cfg.num_heads // tp
        parts = sum(q[:, r * hq_s * dh:(r + 1) * hq_s * dh]
                    @ shards[r]["layers"][li]["attn"]["wo"]
                    for r in range(tp))
        torch.testing.assert_close(parts, q @ wa["wo"], rtol=0, atol=1e-5)
        # MLP: each rank's ff slice through the activation, row-summed
        assert mlp_sharded(cfg, plan)
        f = sum(mlp_mod.apply_mlp(shards[r]["layers"][li]["mlp"], x[None],
                                  cfg.mlp_type) for r in range(tp))
        torch.testing.assert_close(
            f, mlp_mod.apply_mlp(whole["mlp"], x[None], cfg.mlp_type),
            rtol=0, atol=1e-5)
        assert shards[0]["layers"][li]["ln1"] is whole["ln1"]
    assert all(s["embedding"] is params["embedding"] for s in shards)


def test_mlp_stays_whole_when_d_ff_does_not_divide():
    cfg, params = _model("gemma2-2b")
    cfg = cfg.__class__(**{**cfg.__dict__, "d_ff": 250})
    plan = plan_tp(cfg, 4, 16)
    assert not mlp_sharded(cfg, plan)
    got = shard_params(params, cfg, plan, 3)
    assert got["layers"][0]["mlp"] is params["layers"][0]["mlp"]


def test_local_pools_under_a_plan():
    cfg, _ = _model("gemma2-2b")
    model = build_model(cfg, "cpu")
    plan = plan_tp(cfg, 4, 16)
    ctx = TPContext(plan=plan, rank=3, world_group=None, seq_group=None,
                    shard_mlp=True)
    assert (ctx.gi, ctx.si) == (1, 1)
    with tp_context(ctx):
        pools = model.init_paged_cache(9, 16)
    assert tuple(pools[0].k.shape) == (1, 9, 8, cfg.head_dim)
    assert tuple(model.init_paged_cache(9, 16)[0].k.shape) == \
        (2, 9, 16, cfg.head_dim)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_without_a_process_group_raises(tp):
    cfg, params = _model("gemma2-2b")
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match=f"tp={tp} needs a torch.distri"):
        EngineCore(model, params, cfg, ServeConfig(tp=tp, page_size=16),
                   device="cpu")


# ---------------------------------------------------------------------------
# distributed-decode helpers in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_kv,ps,s", [(3, 16, 2), (5, 16, 4), (4, 8, 1)])
def test_paged_helpers_equal_jax(n_kv, ps, s):
    rng = np.random.default_rng(n_kv)
    pages = rng.normal(size=(2, 7, ps // s, 4)).astype(np.float32)
    table = rng.integers(0, 7, size=(3, n_kv)).astype(np.int32)
    got = dd.paged_local_view(torch.from_numpy(pages),
                              torch.from_numpy(table)).numpy()
    want = np.asarray(jdd.paged_local_view(jnp.asarray(pages),
                                           jnp.asarray(table)))
    np.testing.assert_array_equal(got, want)
    for si in range(s):
        np.testing.assert_array_equal(
            dd.paged_shard_kv_positions(n_kv, ps, ps // s, si).numpy(),
            np.asarray(jdd.paged_shard_kv_positions(n_kv, ps, ps // s, si)))


@pytest.mark.parametrize("window,softcap", [(None, None), (12, 30.0)])
def test_attend_with_positions_equals_jax(window, softcap):
    rng = np.random.default_rng(3)
    b, hq, hkv, sq, kv, d = 3, 4, 2, 5, 24, 8
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, kv, d)).astype(np.float32)
    kv_pos = rng.permutation(40)[:kv].astype(np.int32)
    kv_len = np.array([40, 17, 30], np.int32)
    q_pos = (kv_len[:, None] - sq + np.arange(sq)[None]).astype(np.int32)
    kw = dict(causal=True, window=window, softcap=softcap)
    out, lse = dd.attend_with_positions(
        *(torch.from_numpy(a) for a in (q, k, v)),
        q_positions=torch.from_numpy(q_pos),
        kv_positions=torch.from_numpy(kv_pos),
        kv_len=torch.from_numpy(kv_len), **kw)
    jo, jl = jdd.attend_with_positions(
        *(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(q_pos),
        kv_positions=jnp.asarray(kv_pos), kv_len=jnp.asarray(kv_len), **kw)
    valid = np.asarray(jl) > jdd.NEG_INF / 2     # rows with a valid key
    assert valid.any()
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(jo)[valid],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-6,
                               atol=1e-5)
