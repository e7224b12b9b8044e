"""The tiling-AllReduce and the distributed decode of the port, on 2 and
4 CPU ranks over gloo (one spawn a world size, the ranks in
``tests/_torch_tp_ranks.py``), against the numpy sum of the per-rank
products and the JAX package's attention oracles: f32 within 1e-5.
Counterparts of ``tests/test_distributed.py``'s allreduce, unaligned-row
and context-parallel tests."""
import numpy as np
import pytest

import jax.numpy as jnp

from _torch_tp_ranks import all_collectives_rank, spawn
from repro.core.distributed_decode import attend_with_positions
from repro.core.fastattention import fast_attention
from repro.kernels.fastattn.ref import decode_reference
from repro_torch.core.tiled_allreduce import chunk_sizes

TOL = 1e-5
F, D = 32, 16
ROWS = {"t64": 64, "t37": 37, "t50": 50}    # aligned, then ragged rows
FULL = ("tiled", "single", "ring", "dispatch-tiled", "dispatch-single")


def _inputs():
    rng = np.random.default_rng(0)
    w = (0.5 * rng.normal(size=(F, D))).astype(np.float32)
    cases = {n: ((0.5 * rng.normal(size=(t, F))).astype(np.float32), w)
             for n, t in ROWS.items()}
    b, s, h, hkv, d, dm = 2, 24, 8, 4, 8, 16
    fused = tuple(rng.normal(size=shape).astype(np.float32) for shape in (
        (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (h * d, dm)))
    b, hq, hkv, kv, d = 4, 8, 2, 256, 32
    q = rng.normal(size=(b, hq, 1, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, kv, d)).astype(np.float32)
    kv_len = np.array([256, 100, 7, 200], np.int32)
    decode = (q, k, v, kv_len, (kv_len - 1)[:, None])
    return cases, fused, decode


INPUTS = _inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def world(request, tmp_path_factory):
    n = request.param
    return n, spawn(all_collectives_rank, n, tmp_path_factory.mktemp("pg"),
                    *INPUTS)


def _rank_sum(x, w, n):
    f = x.shape[1] // n
    return sum(x[:, r * f:(r + 1) * f] @ w[r * f:(r + 1) * f]
               for r in range(n))


@pytest.mark.parametrize("var", FULL)
@pytest.mark.parametrize("case", list(ROWS))
def test_matmul_allreduce_variants(world, case, var):
    n, ranks = world
    x, w = INPUTS[0][case]
    want = _rank_sum(x, w, n)
    for r in ranks:
        got = r["collectives"][(case, var)]
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("var", ["rs", "rs1"])
@pytest.mark.parametrize("case", list(ROWS))
def test_reducescatter(world, case, var):
    """Rank i holds piece i of every chunk's reduced product; rows that
    do not split over the ranks are refused, not mis-split."""
    n, ranks = world
    x, w = INPUTS[0][case]
    t = x.shape[0]
    if t % n:
        for r in ranks:
            assert r["collectives"][(case, var)].startswith(
                "ValueError: tiled_matmul_reducescatter: leading dim")
        return
    want = _rank_sum(x, w, n)
    sizes = chunk_sizes(t, 1 if var == "rs1" else 4, 0.5, align=n)
    starts = np.cumsum([0] + list(sizes))
    for i, r in enumerate(ranks):
        rows = np.concatenate([np.arange(a + i * (s // n),
                                         a + (i + 1) * (s // n))
                               for a, s in zip(starts, sizes)])
        np.testing.assert_allclose(r["collectives"][(case, var)], want[rows],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("case", list(ROWS))
def test_tiled_issues_one_allreduce_per_chunk(world, case):
    """T3's structure: the tiled mode issues len(chunk_sizes(...))
    all-reduces, one per chunk of the rows; single issues one; the ring
    none (send/recv and an all-gather)."""
    _, ranks = world
    t = ROWS[case]
    for r in ranks:
        c = r["collectives"]
        assert c[(case, "tiled", "calls")] == chunk_sizes(t, 4, 0.5)
        assert c[(case, "dispatch-tiled", "calls")] == chunk_sizes(t, 4, 0.5)
        assert len(c[(case, "tiled", "calls")]) > 1
        assert c[(case, "single", "calls")] == [t]
        assert c[(case, "ring", "calls")] == []


@pytest.mark.parametrize("mode", ["tiled", "single"])
def test_fused_attention_linear(world, mode):
    """The paper's fused attention + Linear + B-allreduce block on each
    rank's heads equals the JAX attention oracle over every head times
    the whole O-proj."""
    _, ranks = world
    q, k, v, w_o = INPUTS[1]
    att = np.asarray(fast_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    impl="reference"))
    b, s = q.shape[:2]
    want = att.reshape(b, s, -1) @ w_o
    for r in ranks:
        np.testing.assert_allclose(r["fused"][mode], want, rtol=0, atol=TOL)


def test_merge_of_strided_slices_equals_whole_cache(world):
    """Each rank attends over every n-th key (the page-row sub-shards'
    strided view) and merge_partial_attention combines them: the JAX
    attend_with_positions over the whole cache."""
    _, ranks = world
    q, k, v, kv_len, q_pos = INPUTS[2]
    want, _ = attend_with_positions(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(q_pos),
        kv_positions=jnp.arange(k.shape[2], dtype=jnp.int32),
        kv_len=jnp.asarray(kv_len))
    for r in ranks:
        np.testing.assert_allclose(r["decode"]["merged"], np.asarray(want),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("window", [None, 64])
def test_context_parallel_decode(world, window):
    _, ranks = world
    q, k, v, kv_len, _ = INPUTS[2]
    want = np.asarray(decode_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_len), window=window))[:, :, 0]
    key = "cp" if window is None else "cp_window"
    for r in ranks:
        np.testing.assert_allclose(r["decode"][key], want, rtol=0, atol=TOL)
