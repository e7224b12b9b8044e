"""The port's paged attention kernels against the JAX package's kernels.

On the CPU the wrappers run their plain PyTorch versions (the CUDA kernels
build and run only on the card); these are held to the JAX package's
Pallas kernels in interpret mode, as ``tests/test_kernels_decode.py`` and
``tests/test_kernels_fastattn.py`` run them.  Inputs are float32 and made
with numpy from a seed; the tolerance is 1e-5 (only the order of float32
sums differs).  Rows past a chunk's valid length are garbage on both
sides and are not compared; a row with no valid key is exactly 0 in the
port (the JAX kernels average the masked values there).

``tests/test_torch_cuda.py`` holds the CUDA kernels to the plain versions
on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fastattn.kernel import paged_prefill_fwd  # noqa: E402
from repro.kernels.fastattn.ref import \
    flash_reference_with_lse as j_flash  # noqa: E402
from repro.kernels.flash_decode.kernel import \
    paged_flash_decode_fwd  # noqa: E402
from repro_torch.core.fastattention import (  # noqa: E402
    fast_attention_decode, fast_attention_prefill_paged)
from repro_torch.kernels import _launch  # noqa: E402
from repro_torch.kernels.fastattn.ops import \
    fastattn_paged_prefill  # noqa: E402
from repro_torch.kernels.fastattn.ref import (  # noqa: E402
    flash_reference_with_lse, paged_prefill_reference)
from repro_torch.kernels.flash_decode.ops import \
    paged_flash_decode  # noqa: E402
from repro_torch.kernels.flash_decode.ref import paged_gather  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _pools(rng, hkv, num_pages, ps, d):
    k = rng.normal(size=(hkv, num_pages, ps, d)).astype(np.float32)
    v = rng.normal(size=(hkv, num_pages, ps, d)).astype(np.float32)
    return k, v


def _table(rng, b, n_kv, num_pages):
    """Scrambled: each sequence owns distinct pages spread over the pool
    (page 0 is the scratch page)."""
    perm = rng.permutation(np.arange(1, num_pages))[:b * n_kv]
    return perm.reshape(b, n_kv).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# (b, hq, hkv, ps, n_kv, d, lens, window, softcap); the last row of each
# case is an idle engine slot: all-scratch table row, kv_len 1
DECODE_CASES = [
    (3, 4, 4, 16, 5, 32, [80, 33, 1], None, None),           # g=1
    (3, 8, 4, 16, 6, 32, [17, 96, 1], 40, 30.0),             # g=2, window
    (2, 4, 2, 128, 2, 64, [200, 1], None, 50.0),             # ps=128
    (3, 4, 2, 128, 2, 32, [256, 129, 1], 100, None),         # window 100
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_paged_decode_matches_jax_kernel(case):
    b, hq, hkv, ps, n_kv, d, lens, window, softcap = case
    rng = np.random.default_rng(0)
    num_pages = b * n_kv + 3
    kp, vp = _pools(rng, hkv, num_pages, ps, d)
    table = _table(rng, b, n_kv, num_pages)
    table[-1] = 0
    lens = np.asarray(lens, np.int32)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    want = paged_flash_decode_fwd(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), window=window, softcap=softcap, interpret=True)
    got = paged_flash_decode(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                             window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the facade's two impls agree on CPU tensors
    for impl in ("paged", "paged_reference"):
        out = fast_attention_decode(
            _t(q)[:, None], _t(kp), _t(vp), _t(lens), page_table=_t(table),
            window=window, softcap=softcap, impl=impl)
        np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(want),
                                   **TOL)


# (hq, hkv, ps, n_kv, d, chunk, starts, nvalid, window, softcap); a row
# with n_valid 0 is a padded batch row: all-scratch table, kv_len 0
PREFILL_CASES = [
    (4, 4, 16, 6, 32, 32, [0, 32, 0], [32, 20, 0], None, None),
    (4, 2, 16, 6, 32, 32, [16, 50, 0], [32, 11, 0], 24, 30.0),
    (2, 2, 128, 2, 64, 64, [0, 100, 0], [64, 37, 0], None, 50.0),
    (4, 2, 128, 2, 32, 64, [128, 3, 0], [64, 64, 0], 100, None),
]


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_paged_prefill_matches_jax_kernel(case):
    hq, hkv, ps, n_kv, d, chunk, starts, nvalid, window, softcap = case
    b = len(starts)
    rng = np.random.default_rng(1)
    num_pages = b * n_kv + 3
    kp, vp = _pools(rng, hkv, num_pages, ps, d)
    table = _table(rng, b, n_kv, num_pages)
    starts = np.asarray(starts, np.int32)
    nvalid = np.asarray(nvalid, np.int32)
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
    assert np.isfinite(got).all()
    for i in range(b):
        n = int(nvalid[i])
        if n == 0:
            assert (got[i] == 0).all()          # no valid key -> exactly 0
            continue
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], **TOL)
    # the layer-layout facade gives the same, transposed
    out = fast_attention_prefill_paged(
        _t(q).transpose(1, 2), _t(kp), _t(vp), _t(table), _t(starts),
        _t(lens), window=window, softcap=softcap, impl="paged_reference")
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), got, **TOL)


@pytest.mark.parametrize("causal,window,softcap,offset", [
    (True, None, None, 0), (True, 48, 20.0, 32), (False, None, None, 0)])
def test_flash_reference_with_lse_matches_jax(causal, window, softcap,
                                              offset):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4, 40, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 96, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 96, 16)).astype(np.float32)
    kv_len = np.asarray([96, 61], np.int32)
    jo, jl = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, softcap=softcap,
                     q_offset=offset, kv_len=jnp.asarray(kv_len),
                     block_kv=32)
    to, tl = flash_reference_with_lse(
        _t(q), _t(k), _t(v), causal=causal, window=window, softcap=softcap,
        q_offset=offset, kv_len=_t(kv_len), block_kv=32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-4)


def test_paged_gather_roundtrip():
    rng = np.random.default_rng(3)
    dense = rng.normal(size=(2, 2, 64, 8)).astype(np.float32)
    table = _table(rng, 2, 4, 10)
    pools = np.zeros((2, 10, 16, 8), np.float32)
    for bi in range(2):
        for ki in range(4):
            pools[:, table[bi, ki]] = dense[bi, :, ki * 16:(ki + 1) * 16]
    np.testing.assert_array_equal(paged_gather(_t(pools), _t(table)).numpy(),
                                  dense)


def test_fully_masked_rows_are_zero_and_finite():
    """kv_len = 0 everywhere: every row of the plain prefill is exactly 0;
    a window that excludes every key zeroes decode rows too."""
    rng = np.random.default_rng(4)
    kp, vp = _pools(rng, 2, 5, 16, 8)
    table = np.zeros((2, 4), np.int32)
    q = _t(rng.normal(size=(2, 2, 8, 8)).astype(np.float32))
    z = torch.zeros(2, dtype=torch.int32)
    out = paged_prefill_reference(q, _t(kp), _t(vp), _t(table), z, z)
    assert torch.equal(out, torch.zeros_like(out))
    lens = torch.tensor([100, 90], dtype=torch.int32)   # past the table
    dec = paged_flash_decode(q[:, :, 0].contiguous(), _t(kp), _t(vp),
                             _t(table), lens, window=8)
    assert torch.equal(dec, torch.zeros_like(dec))


def test_wrapper_checks_reject_cpu_and_wrong_dtypes():
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        _launch.check_tensors("k", {"q": q}, {})
    with pytest.raises(ValueError, match="not supported"):
        _launch.check_tensors("k", {"q": q.half()}, {})
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _launch.check_status("k", 1)
