"""The port's dense FastAttention against the JAX package's, on the CPU.

On the CPU the wrapper ``fastattn_fwd`` runs its plain PyTorch version
(the CUDA kernel builds and runs only on the card); it is held here to
the JAX package's Pallas kernel in interpret mode, as
``tests/test_kernels_fastattn.py`` runs it, and the port's autograd
``fastattn`` to ``jax.grad`` through the JAX ``fastattn``.  Inputs are
float32, made with numpy from a seed; the forward must agree to 1e-5 and
the gradients to 1e-4 (float32 sums in another order; the gradients sum
over every query row).  A query row with no visible key is 0 in the port
and the average of the masked values in JAX, so only rows with a visible
key are compared.  The host-side tiling rules (``classify_block``,
``MaskSpec.block_limits``, the M-mask) must equal JAX's exactly, and the
Hopper planner must fit the H100's 227 KB of shared memory per CTA.

``tests/test_torch_cuda.py`` holds the CUDA kernel to the plain version
on the card.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import tiling_mask as jtm  # noqa: E402
from repro.core.fastattention import \
    fast_attention as j_fast_attention  # noqa: E402
from repro.kernels.fastattn import ref as jref  # noqa: E402
from repro.kernels.fastattn.kernel import \
    fastattn_fwd as j_fastattn_fwd  # noqa: E402
from repro.kernels.fastattn.ops import fastattn as j_fastattn  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core import tiling_mask as tm  # noqa: E402
from repro_torch.core.fastattention import fast_attention  # noqa: E402
from repro_torch.kernels.fastattn import ref  # noqa: E402
from repro_torch.kernels.fastattn.ops import (fastattn,  # noqa: E402
                                              fastattn_fwd)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _rows_with_a_key(sq, skv, causal, window, q_offset, kv_valid):
    mask = tm.dense_mask(sq, skv, causal=causal, window=window,
                         q_offset=q_offset).numpy()
    mask[:, kv_valid if kv_valid is not None else skv:] = False
    return mask.any(axis=1)


# (b, hq, hkv, sq, skv, d, causal, window, softcap, q_offset, kv_valid):
# S is no multiple of the blocks (32 / 64 / 32 on the JAX side).  The
# non-causal case keeps kv_valid on a sub-tile edge: see
# test_noncausal_partial_tiles_follow_the_jax_oracle.
FWD_CASES = [
    (2, 4, 4, 70, 70, 16, True, None, None, 0, None),
    (1, 4, 1, 90, 130, 32, True, 40, 30.0, 0, None),        # GQA 4, band
    (1, 4, 2, 50, 150, 16, True, None, 20.0, 80, 120),      # offset, tail
    (1, 2, 2, 70, 100, 16, False, None, 10.0, 0, 64),       # non-causal
    (1, 4, 2, 40, 40, 16, True, 8, None, 0, 30),            # keyless rows
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_fastattn_matches_jax_kernel(case):
    b, hq, hkv, sq, skv, d, causal, window, softcap, off, kv_valid = case
    q, k, v = _qkv(0, b, hq, hkv, sq, skv, d)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off,
              kv_valid=kv_valid)
    want = np.asarray(j_fastattn_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
        block_kv1=64, block_kv2=32, interpret=True, **kw))
    rows = _rows_with_a_key(sq, skv, causal, window, off, kv_valid)
    for got in (fastattn_fwd(_t(q), _t(k), _t(v), **kw),
                fastattn(_t(q), _t(k), _t(v), impl="kernel", **kw),
                fastattn(_t(q), _t(k), _t(v), impl="reference", **kw)):
        got = got.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:, :, rows], want[:, :, rows],
                                   **FWD_TOL)
        assert (got[:, :, ~rows] == 0).all()     # no visible key -> 0


# (b, hq, hkv, sq, skv, d, window, softcap, q_offset, kv_valid): without
# a causal mask, a sub-tile made PARTIAL by the kv_valid tail or a window
# gets the causal B-mask in the JAX kernel (kernel.py:106 slices it
# unconditionally); the JAX oracles and the port mask only what is asked.
NONCAUSAL_PARTIAL_CASES = [
    (1, 2, 2, 64, 100, 16, None, None, 0, 77),
    (1, 2, 1, 33, 96, 16, 24, None, 50, None),
]


@pytest.mark.parametrize("case", NONCAUSAL_PARTIAL_CASES)
def test_noncausal_partial_tiles_follow_the_jax_oracle(case):
    b, hq, hkv, sq, skv, d, window, softcap, off, kv_valid = case
    q, k, v = _qkv(5, b, hq, hkv, sq, skv, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    lens = None if kv_valid is None else jnp.full((b,), kv_valid)
    oracle = np.asarray(jref.standard_attention(
        jq, jk, jv, causal=False, window=window, softcap=softcap,
        q_offset=off, kv_len=lens))
    jkernel = np.asarray(j_fastattn_fwd(
        jq, jk, jv, causal=False, window=window, softcap=softcap,
        q_offset=off, kv_valid=kv_valid, block_q=32, block_kv1=64,
        block_kv2=32, interpret=True))
    assert np.abs(jkernel - oracle).max() > 1e-2      # the JAX kernel's
    got = fastattn(_t(q), _t(k), _t(v), causal=False, window=window,
                   softcap=softcap, q_offset=off, kv_valid=kv_valid,
                   impl="kernel")
    rows = _rows_with_a_key(sq, skv, False, window, off, kv_valid)
    np.testing.assert_allclose(got.numpy()[:, :, rows], oracle[:, :, rows],
                               **FWD_TOL)


# (hq, hkv, causal, window, softcap, q_offset, kv_valid): every row keeps
# a visible key, so the JAX and port gradients cover the same rows
GRAD_CASES = [
    (4, 2, True, None, None, 0, None),
    (4, 1, True, 24, 10.0, 16, None),
    (2, 2, False, None, 15.0, 20, 64),
]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_fastattn_gradients_match_jax(case):
    hq, hkv, causal, window, softcap, off, kv_valid = case
    b, sq, skv, d = 2, 48, 100, 16
    q, k, v = _qkv(1, b, hq, hkv, sq, skv, d)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    assert _rows_with_a_key(sq, skv, causal, window, off, kv_valid).all()

    def j_loss(q, k, v):
        out = j_fastattn(q, k, v, causal, window, softcap, None, off, 32,
                         64, 32, "interpret", kv_valid)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fastattn(*leaves, causal=causal, window=window, softcap=softcap,
                   q_offset=off, kv_valid=kv_valid, impl="kernel")
    got = torch.autograd.grad(out, leaves, _t(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("causal,window,softcap,off,kv_len", [
    (True, None, None, 0, None), (True, 20, 30.0, 12, 70),
    (False, None, 10.0, 0, 50)])
def test_plain_versions_match_jax_oracles(causal, window, softcap, off,
                                          kv_len):
    q, k, v = _qkv(3, 2, 4, 2, 40, 80, 16)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    lens = None if kv_len is None else np.full((2,), kv_len, np.int32)
    rows = _rows_with_a_key(40, 80, causal, window, off, kv_len)
    for jfn, tfn in ((jref.standard_attention, ref.standard_attention),
                     (jref.flash_reference, ref.flash_reference)):
        want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), kv_len=None if lens is None
                              else jnp.asarray(lens), **kw))
        got = tfn(_t(q), _t(k), _t(v), kv_len=None if lens is None
                  else _t(lens), **kw).numpy()
        np.testing.assert_allclose(got[:, :, rows], want[:, :, rows],
                                   **FWD_TOL)


def test_layer_layout_facade_matches_jax():
    """fast_attention takes (B, S, H, D) like the JAX facade."""
    q, k, v = _qkv(4, 2, 4, 2, 30, 30, 16)
    qs, ks, vs = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                  for a in (q, k, v))
    want = np.asarray(j_fast_attention(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs), window=9,
        softcap=5.0, impl="reference"))
    for impl in (None, "auto", "pallas", "kernel", "reference"):
        got = fast_attention(_t(qs), _t(ks), _t(vs), window=9, softcap=5.0,
                             impl=impl)
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    with pytest.raises(ValueError, match="unknown"):
        fast_attention(_t(qs), _t(ks), _t(vs), impl="paged")


def test_classify_and_block_limits_equal_jax():
    grid = itertools.product(range(0, 160, 23), range(0, 200, 29),
                             (16, 32, 64), (8, 32), (True, False),
                             (None, 17, 64), (None, 90, 150))
    n = 0
    for q0, k0, bq, bk, causal, window, kv_len in grid:
        got = tm.classify_block(q0, k0, bq, bk, causal=causal,
                                window=window, kv_len=kv_len)
        want = jtm.classify_block(q0, k0, bq, bk, causal=causal,
                                  window=window, kv_len=kv_len)
        assert got == int(want), (q0, k0, bq, bk, causal, window, kv_len)
        n += 1
    assert n > 5000
    for causal, window, off in itertools.product(
            (True, False), (None, 50, 200), (0, 37, 300)):
        spec, jspec = (m.MaskSpec(causal=causal, window=window, q_offset=off)
                       for m in (tm, jtm))
        for args in ((8, 8, 64, 64, 512), (5, 9, 32, 128, 1000),
                     (3, 4, 256, 1024, 1)):
            for a, w in zip(spec.block_limits(*args),
                            jspec.block_limits(*args)):
                np.testing.assert_array_equal(a, w)


def test_m_mask_and_dense_mask_equal_jax():
    for m in (8, 32):
        np.testing.assert_array_equal(tm.make_m_mask(m).numpy(),
                                      np.asarray(jtm.make_m_mask(m)))
    np.testing.assert_array_equal(
        tm.dense_mask(20, 30, window=7, q_offset=4).numpy(),
        np.asarray(jtm.dense_mask(20, 30, window=7, q_offset=4)))
    assert tm.mask_memory_bytes(65536, 2) == jtm.mask_memory_bytes(65536, 2)
    assert tm.m_mask_memory_bytes(512) == jtm.m_mask_memory_bytes(512)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_hopper_plan_fits_shared_memory(d, dtype_bytes):
    """The plan describes the kernel the dtype launches: float32 the FMA
    kernel (64-row blocks, 32-key sub-tiles, level 1 grown while two CTAs
    fit an SM); bfloat16 the wgmma kernel (64 rows per warpgroup, two
    warpgroups up to head_dim 128; 64-key sub-tiles; a ring of three
    level-1 stages, grown while it fits one CTA's 227 KB)."""
    plan = tiling.plan_two_level_tiling(2048, 2048, d,
                                        dtype_bytes=dtype_bytes)
    assert plan.smem_bytes <= 232_448
    assert plan.smem_bytes == tiling.smem_working_set(
        plan.block_q, plan.block_kv1, d, dtype_bytes)
    assert plan.block_kv1 % plan.block_kv2 == 0
    if dtype_bytes == 4:
        assert (plan.block_q, plan.block_kv2) == (64, 32)
    else:
        assert (plan.block_q, plan.block_kv2) == ((128 if d <= 128 else 64),
                                                  64)
        # the ring's stages fit one CTA, and a larger stage would not
        assert plan.stages == 3
        assert plan.smem_bytes == (1024 + 2 * plan.block_q * d
                                   + plan.stages * 2 * 2 * plan.block_kv1 * d
                                   + plan.stages * 2 * 8)
        assert tiling.smem_working_set(plan.block_q, 2 * plan.block_kv1, d,
                                       2) > 232_448
    assert plan.ctas_per_sm >= 1
    # float32: level 1 grows while two CTAs still fit an SM
    if (dtype_bytes == 4
            and tiling.smem_working_set(64, 32, d, dtype_bytes) <= 115_712):
        assert plan.ctas_per_sm == 2
    if d <= 128:
        assert plan.block_kv1 > plan.block_kv2
        assert tiling.sync_count(2048, plan.block_kv1) < \
            tiling.sync_count(2048, plan.block_kv2)
    # short sequences do not stage more keys than exist
    assert tiling.plan_two_level_tiling(40, 40, d, dtype_bytes=dtype_bytes
                                        ).block_kv1 <= 64
