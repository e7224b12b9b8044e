"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; without a card they skip.  They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (only the order of sums differs); bfloat16 2e-2
(both sides accumulate in float32 and round the output once to bf16).
The mLSTM's h is not bounded like an attention output (|h| reaches tens
on N(0, 1) inputs, and a denominator that nearly cancels magnifies the
order of sums to ~1e-5 of |h| between its own three float32 forms), so
its tolerance is relative to each case's largest |h|: 1e-4 (float32) and
2^-7 (bfloat16, one rounding of the output); its float32 state (C, n, m)
is held to 1e-4 of its own scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fastattention import fast_attention_decode  # noqa: E402
from repro_torch.kernels.fastattn.ops import (  # noqa: E402
    fastattn, fastattn_fwd, fastattn_paged_prefill)
from repro_torch.kernels.fastattn.ref import (  # noqa: E402
    flash_reference, paged_prefill_reference)
from repro_torch.kernels.flash_decode.ops import (  # noqa: E402
    flash_decode, paged_flash_decode, plan_dense_splits, plan_splits)
from repro_torch.kernels.flash_decode.ref import \
    decode_reference  # noqa: E402
from repro_torch.kernels.mlstm import ref as mlstm_ref  # noqa: E402
from repro_torch.kernels.mlstm.ops import (  # noqa: E402
    mlstm_chunkwise, mlstm_chunkwise_fwd)

# (b, hq, hkv, ps, n_kv, d, lens, window, softcap); a row of kv_len 1 is
# an idle engine slot: all-scratch table row.  lens may be a function of
# the launch's split_keys (``plan_splits`` on this card): the split-KV
# edges.  After the first four: kv_len one below, at and one above a
# split, a window narrower than the table (its range starts mid-page and
# ends in a part split), one sequence of 4096 keys over many splits, and
# only idle rows.  Then head dims 80 and 96 (16-lane thread groups, 10
# and 12 lanes holding columns): GQA groups of 1, 4 (D = 96) and 8, split
# edges, a window and a softcap.
DECODE_CASES = [
    (3, 4, 4, 16, 5, 64, [80, 33, 1], None, None),
    (3, 8, 4, 16, 6, 128, [17, 96, 1], 40, 30.0),
    (2, 4, 2, 128, 2, 256, [200, 1], None, 50.0),
    (3, 20, 2, 128, 3, 128, [384, 129, 1], 100, None),     # g=10: 2 tiles
    (4, 4, 4, 16, 64, 128, lambda sk: [sk - 1, sk, sk + 1, 1], None, None),
    (4, 8, 4, 16, 64, 128, lambda sk: [2 * sk + 1, 2 * sk, 3 * sk - 1, 1],
     None, 30.0),
    (3, 8, 2, 16, 64, 256, [1000, 301, 1], 100, 50.0),
    (1, 8, 8, 128, 32, 128, [4096], None, None),
    (2, 4, 4, 16, 8, 64, [1, 1], 20, None),
    (3, 8, 8, 16, 6, 80, [96, 33, 1], None, None),
    (3, 16, 4, 16, 6, 96, [80, 17, 1], 40, 30.0),
    (4, 8, 1, 16, 64, 96, lambda sk: [sk - 1, sk, sk + 1, 1], None, None),
    (4, 8, 8, 16, 64, 80, lambda sk: [2 * sk + 1, sk, 3 * sk - 1, 1],
     None, 30.0),
]
# (hq, hkv, ps, n_kv, d, chunk, starts, nvalid, window, softcap); a row
# with n_valid 0 is a padded batch row: all-scratch table, kv_len 0.
# Beside the first four: a chunk of 1 row and one of 129 (across the
# bf16 kernel's 128-row block), fewer keys than one 64-key sub-tile,
# head_dim 256 with a window, 64-key sub-tiles straddling 16-key
# pages from an unaligned start, and head dims 80 and 96 (the bf16 tiles
# padded to 128 columns) with GQA, a window and a softcap
PREFILL_CASES = [
    (4, 4, 16, 6, 64, 32, [0, 32, 0], [32, 20, 0], None, None),
    (4, 2, 16, 6, 128, 32, [16, 50, 0], [32, 11, 0], 24, 30.0),
    (2, 2, 128, 2, 256, 64, [0, 100, 0], [64, 37, 0], None, 50.0),
    (4, 2, 128, 3, 128, 100, [128, 3, 0], [100, 77, 0], 100, None),
    (4, 2, 16, 6, 128, 1, [40, 0, 7], [1, 0, 1], None, None),
    (4, 4, 16, 12, 64, 129, [0, 50, 0], [129, 100, 0], None, None),
    (4, 2, 16, 3, 128, 32, [0, 10, 0], [32, 20, 0], None, None),
    (4, 2, 128, 3, 256, 128, [100, 0, 0], [128, 60, 0], 64, None),
    (8, 2, 16, 16, 128, 96, [37, 150, 0], [96, 70, 0], None, None),
    (4, 4, 16, 6, 80, 32, [0, 32, 0], [32, 20, 0], None, None),
    (4, 2, 16, 12, 96, 129, [0, 50, 0], [129, 100, 0], 24, 30.0),
    (8, 2, 128, 3, 80, 100, [128, 3, 0], [100, 77, 0], None, 50.0),
]


def _pools(rng, hkv, num_pages, ps, d):
    k = rng.normal(size=(hkv, num_pages, ps, d)).astype(np.float32)
    v = rng.normal(size=(hkv, num_pages, ps, d)).astype(np.float32)
    return k, v


def _table(rng, b, n_kv, num_pages):
    perm = rng.permutation(np.arange(1, num_pages))[:b * n_kv]
    return perm.reshape(b, n_kv).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_cuda_paged_decode_matches_plain(cuda_device, case, dtype, tol):
    b, hq, hkv, ps, n_kv, d, lens, window, softcap = case
    if callable(lens):
        split_keys, _ = plan_splits(
            b, hkv, hq // hkv, n_kv, ps, window,
            torch.cuda.get_device_properties(cuda_device).multi_processor_count)
        lens = lens(split_keys)
    rng = np.random.default_rng(5)
    num_pages = b * n_kv + 3
    kp, vp = (_t(a).to(cuda_device, dtype)
              for a in _pools(rng, hkv, num_pages, ps, d))
    table = _table(rng, b, n_kv, num_pages)
    table[np.asarray(lens) == 1] = 0
    q = _t(rng.normal(size=(b, hq, d)).astype(np.float32)).to(cuda_device,
                                                               dtype)
    args = (q, kp, vp, _t(table).to(cuda_device),
            _t(np.asarray(lens, np.int32)).to(cuda_device))
    before = paged_flash_decode.launches
    got = paged_flash_decode(*args, window=window, softcap=softcap)
    assert paged_flash_decode.launches == before + 1
    want = fast_attention_decode(
        q[:, None], kp, vp, args[4], page_table=args[3], window=window,
        softcap=softcap, impl="paged_reference")[:, 0]
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_cuda_paged_prefill_matches_plain(cuda_device, case, dtype, tol):
    hq, hkv, ps, n_kv, d, chunk, starts, nvalid, window, softcap = case
    b = len(starts)
    rng = np.random.default_rng(6)
    num_pages = b * n_kv + 3
    kp, vp = (_t(a).to(cuda_device, dtype)
              for a in _pools(rng, hkv, num_pages, ps, d))
    table = _table(rng, b, n_kv, num_pages)
    starts = np.asarray(starts, np.int32)
    nvalid = np.asarray(nvalid, np.int32)
    table[nvalid == 0] = 0
    dev = [_t(a).to(cuda_device) for a in (table, starts, starts + nvalid)]
    q = _t(rng.normal(size=(b, hq, chunk, d)).astype(np.float32)).to(
        cuda_device, dtype)
    got = fastattn_paged_prefill(q, kp, vp, *dev, window=window,
                                 softcap=softcap)
    want = paged_prefill_reference(q, kp, vp, *dev, window=window,
                                   softcap=softcap)
    for i in range(b):
        n = int(nvalid[i])
        if n == 0:
            assert torch.count_nonzero(got[i]) == 0
            continue
        torch.testing.assert_close(got[i, :, :n].float(),
                                   want[i, :, :n].float(), rtol=0, atol=tol)


# (b, hq, hkv, sq, skv, d, causal, window, softcap, q_offset, kv_valid):
# ragged Sq/Skv that are no multiple of the tiles, GQA, window bands with
# SKIP sub-tiles, a q_offset past 0, kv_valid tails; rows with no visible
# key are 0 on both sides.  Beside the first six: Sq = 1 and Sq = 129
# (across the bf16 kernel's 128-row block), Skv below one 64-key
# sub-tile, head_dim 256 with a window, kv_valid = 0 (every row
# exactly 0), and head dims 80 and 96
FWD_CASES = [
    (2, 4, 4, 200, 200, 64, True, None, None, 0, None),
    (1, 8, 2, 300, 257, 128, True, 100, 30.0, 0, None),
    (1, 4, 2, 130, 333, 256, True, None, 50.0, 150, 300),
    (2, 4, 1, 96, 160, 128, False, None, None, 0, 140),
    (1, 2, 2, 64, 700, 64, False, 64, None, 600, None),
    (1, 2, 2, 50, 40, 128, True, 16, None, 0, 0),
    (1, 4, 2, 1, 300, 128, True, None, None, 299, None),
    (2, 4, 4, 129, 129, 64, True, None, None, 0, None),
    (1, 4, 2, 129, 500, 128, True, None, None, 371, None),
    (1, 4, 2, 100, 40, 128, False, None, None, 0, None),
    (1, 4, 2, 300, 300, 256, True, 100, None, 0, None),
    (1, 2, 1, 129, 100, 64, False, None, None, 0, 0),
    (2, 4, 4, 200, 200, 80, True, None, None, 0, None),
    (1, 8, 2, 300, 257, 96, True, 100, 30.0, 0, None),
    (1, 4, 2, 129, 500, 80, True, None, None, 371, 450),
    (2, 4, 1, 96, 160, 96, False, None, None, 0, 140),
]


def _qkv(rng, b, hq, hkv, sq, skv, d, device, dtype):
    return [_t(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FWD_CASES)
def test_cuda_fastattn_fwd_matches_plain(cuda_device, case, dtype, tol):
    b, hq, hkv, sq, skv, d, causal, window, softcap, off, kv_valid = case
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, b, hq, hkv, sq, skv, d, cuda_device, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    before = fastattn_fwd.launches
    got = fastattn_fwd(q, k, v, kv_valid=kv_valid, **kw)
    assert fastattn_fwd.launches == before + 1
    want = flash_reference(q, k, v, kv_len=kv_valid, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    if kv_valid == 0:
        assert torch.count_nonzero(got) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window,softcap", [(True, None, None),
                                                   (True, 48, 20.0),
                                                   (False, None, None)])
def test_cuda_fastattn_autograd_matches_plain(cuda_device, causal, window,
                                              softcap):
    """The autograd op launches the kernel in the forward and recomputes
    through the plain version in the backward: output and gradients
    equal the plain path's (float32, 1e-4)."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 2, 4, 2, 160, 160, 64, cuda_device, torch.float32)
    g = _t(rng.normal(size=q.shape).astype(np.float32)).to(cuda_device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    res = {}
    for impl in ("kernel", "reference"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = fastattn_fwd.launches
        out = fastattn(*leaves, impl=impl, **kw)
        launched = fastattn_fwd.launches - before
        assert launched == (1 if impl == "kernel" else 0)
        res[impl] = (out, *torch.autograd.grad(out, leaves, g))
    for got, want in zip(res["kernel"], res["reference"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_fastattn_fwd_rejects_bad_arguments(cuda_device):
    q = torch.zeros((1, 2, 8, 72), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fastattn_fwd(q, q, q)
    q = torch.zeros((1, 2, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fastattn_fwd(q.transpose(1, 2), q, q)


# (b, hq, hkv, s, d, lens, window, softcap): ragged kv_len with a length-1
# row, a cache length no multiple of the tiles, GQA groups of 1, 2, 4 and
# 10 (two row tiles), window and softcap; head dims 80 and 96
DENSE_DECODE_CASES = [
    (3, 4, 4, 300, 64, [300, 77, 1], None, None),
    (2, 8, 4, 1000, 128, [999, 400], 256, 30.0),
    (2, 8, 2, 512, 256, [512, 3], None, 50.0),
    (2, 20, 2, 777, 128, [700, 129], 100, None),
    (3, 4, 4, 300, 80, [300, 77, 1], None, None),
    (2, 8, 2, 1000, 96, [999, 400], 256, 30.0),
    (2, 20, 4, 777, 96, [700, 129], None, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", ["bshd", "bhsd", "bhsd-view"])
@pytest.mark.parametrize("case", DENSE_DECODE_CASES)
def test_cuda_flash_decode_matches_plain(cuda_device, case, layout, dtype,
                                         tol):
    """Both layouts, and a "bhsd" view of a "bshd" cache read through its
    strides (no copy)."""
    b, hq, hkv, s, d, lens, window, softcap = case
    rng = np.random.default_rng(8)
    q = _t(rng.normal(size=(b, hq, d)).astype(np.float32)).to(cuda_device,
                                                               dtype)
    shape = (b, s, hkv, d) if layout == "bshd" else (b, hkv, s, d)
    if layout == "bhsd-view":
        shape = (b, s, hkv, d)
    k, v = (_t(rng.normal(size=shape).astype(np.float32)).to(cuda_device,
                                                             dtype)
            for _ in range(2))
    lay = layout
    if layout == "bhsd-view":
        k, v, lay = k.transpose(1, 2), v.transpose(1, 2), "bhsd"
    kv_len = _t(np.asarray(lens, np.int32)).to(cuda_device)
    kw = dict(window=window, softcap=softcap, layout=lay)
    before = flash_decode.launches
    got = flash_decode(q, k, v, kv_len, **kw)
    assert flash_decode.launches == before + 1
    want = decode_reference(q[:, :, None], k, v, kv_len, window=window,
                            softcap=softcap, layout=lay)[:, :, 0]
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


# (b, hq, hkv, s, d, lens, window, softcap): split-KV edges of the dense
# kernel.  lens may be a function of the launch's split_keys
# (``plan_dense_splits`` on this card): kv_len one
# below, at and one above a split (GQA groups of 1, 2, 5 in the 8-row
# tile, 8), a window (its range starts mid-split), a window narrower than
# the 32-key split, and one row over many splits
DENSE_SPLIT_CASES = [
    (4, 4, 4, 2048, 128, lambda sk: [sk - 1, sk, sk + 1, 1], None, None),
    (4, 8, 4, 4096, 64, lambda sk: [2 * sk + 1, 2 * sk, 3 * sk - 1, 1],
     None, 30.0),
    (3, 40, 8, 3000, 128, lambda sk: [sk + 1, 3000, 1], None, None),
    (2, 16, 2, 5000, 256, lambda sk: [5000, sk + 1], 777, None),
    (4, 8, 2, 1024, 128, [1024, 21, 20, 1], 20, None),
    (1, 32, 32, 20000, 128, [20000], None, None),
    (4, 32, 8, 2048, 96, lambda sk: [sk - 1, sk, sk + 1, 1], None, None),
    (1, 32, 32, 20000, 80, [20000], None, None),
]


def _dense_inputs(rng, b, hq, hkv, s, d, layout, device, dtype):
    shape = (b, s, hkv, d) if layout == "bshd" else (b, hkv, s, d)
    q = _t(rng.normal(size=(b, hq, d)).astype(np.float32)).to(device, dtype)
    k, v = (_t(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,rtol", [(torch.float32, 1e-4, 1e-3),
                                            (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("case", DENSE_SPLIT_CASES)
def test_cuda_flash_decode_split_edges_match_plain(cuda_device, case, layout,
                                                   dtype, tol, rtol):
    """Every (batch, head) row against the plain version, within the
    absolute tolerance and within ``rtol`` of the row's own scale (a long
    row's output is small: the absolute gate alone would pass a dropped
    split); a row of kv_len 1 and the idle splits included."""
    b, hq, hkv, s, d, lens, window, softcap = case
    if callable(lens):
        split_keys, _ = plan_dense_splits(
            b, hq, hkv, s, window,
            torch.cuda.get_device_properties(cuda_device).multi_processor_count)
        lens = lens(split_keys)
    rng = np.random.default_rng(10)
    q, k, v = _dense_inputs(rng, b, hq, hkv, s, d, layout, cuda_device,
                            dtype)
    kv_len = _t(np.asarray(lens, np.int32)).to(cuda_device)
    kw = dict(window=window, softcap=softcap, layout=layout)
    before = flash_decode.launches
    got = flash_decode(q, k, v, kv_len, **kw)
    assert flash_decode.launches == before + 1
    want = decode_reference(q[:, :, None], k, v, kv_len, **kw)[:, :, 0]
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    diff = (got.float() - want.float()).abs().reshape(-1, d).amax(1)
    scale = want.float().abs().reshape(-1, d).amax(1)
    assert bool((diff <= rtol * scale).all()), (diff / scale).max().item()


# (b, hq, hkv, s, d, kv_start, lens, window, softcap): one rank's slice of
# a cache sharded along its sequence, kv_len global: a row with no valid
# key in the slice (ending before it, or a window starting past it), rows
# ending inside and past it, a window that cuts it from below, GQA 4 and
# 8 at D = 256 with a softcap, rows over many splits and in one split
DENSE_SLICE_CASES = [
    (4, 8, 8, 1024, 128, 1024, [1000, 1030, 2048, 1025], None, None),
    (3, 8, 2, 2048, 256, 0, [3100, 1500, 2049], 1024, 50.0),
    (3, 8, 2, 2048, 256, 2048, [3100, 1500, 4096], 1024, 50.0),
    (2, 32, 4, 4096, 128, 4096, [8192, 4097], None, 30.0),
    (2, 16, 16, 512, 64, 512, [1024, 600], 20, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", DENSE_SLICE_CASES)
def test_cuda_flash_decode_slice_and_lse_match_plain(cuda_device, case,
                                                     dtype, tol):
    """``kv_start`` and the log-sum-exp output against the plain version:
    out float32 (unrounded, whatever the inputs' dtype) within 1e-4, lse
    within 1e-3, and a row with no valid key exactly 0 and NEG_INF on
    both sides; without the log-sum-exp, out in the inputs' dtype within
    its tolerance."""
    b, hq, hkv, s, d, kv_start, lens, window, softcap = case
    rng = np.random.default_rng(12)
    q, k, v = _dense_inputs(rng, b, hq, hkv, s, d, "bshd", cuda_device,
                            dtype)
    kv_len = _t(np.asarray(lens, np.int32)).to(cuda_device)
    kw = dict(window=window, softcap=softcap, layout="bshd",
              kv_start=kv_start)
    before = flash_decode.launches
    got, lse = flash_decode(q, k, v, kv_len, return_lse=True, **kw)
    assert flash_decode.launches == before + 1
    want, want_lse = decode_reference(q[:, :, None], k, v, kv_len,
                                      return_lse=True, **kw)
    torch.cuda.synchronize()
    want, want_lse = want[:, :, 0], want_lse[:, :, 0]
    assert lse.dtype == torch.float32 and lse.shape == (b, hq)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    empty = want_lse == -1e30
    assert bool((lse[empty] == -1e30).all())
    assert bool((got[empty] == 0).all()) and bool((want[empty] == 0).all())
    # without lse, at kv_start 0: the same output as before
    plain = flash_decode(q, k, v, kv_len, window=window, softcap=softcap,
                         layout="bshd")
    ref = decode_reference(q[:, :, None], k, v, kv_len, window=window,
                           softcap=softcap, layout="bshd")[:, :, 0]
    torch.cuda.synchronize()
    torch.testing.assert_close(plain.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_dense_and_paged_decode_share_the_split_workspace(cuda_device):
    """Dense and paged split-KV launches back to back on one stream share
    the per-device ``split_workspace``: each launch's merging CTAs reset
    their counters, so every launch finds them at 0 and stays right, and
    they are all 0 once the stream is done."""
    from repro_torch.kernels.flash_decode.ops import split_workspace
    rng = np.random.default_rng(13)
    dt = torch.bfloat16
    q, k, v = _dense_inputs(rng, 2, 8, 2, 3000, 128, "bshd", cuda_device, dt)
    dense_len = _t(np.asarray([3000, 1500], np.int32)).to(cuda_device)
    num_pages = 2 * 64 + 3
    kp, vp = (_t(a).to(cuda_device, dt)
              for a in _pools(rng, 2, num_pages, 16, 128))
    table = _t(_table(rng, 2, 64, num_pages)).to(cuda_device)
    paged_len = _t(np.asarray([1024, 700], np.int32)).to(cuda_device)
    pq = _t(rng.normal(size=(2, 8, 128)).astype(np.float32)).to(cuda_device,
                                                                 dt)
    want_d = decode_reference(q[:, :, None], k, v, dense_len,
                              layout="bshd")[:, :, 0]
    want_p = fast_attention_decode(pq[:, None], kp, vp, paged_len,
                                   page_table=table,
                                   impl="paged_reference")[:, 0]
    outs = []
    for _ in range(3):
        outs.append((flash_decode(q, k, v, dense_len, layout="bshd"),
                     paged_flash_decode(pq, kp, vp, table, paged_len)))
    torch.cuda.synchronize()
    _, counters = split_workspace(q.device, 0, 0)
    assert torch.count_nonzero(counters) == 0
    for got_d, got_p in outs:
        torch.testing.assert_close(got_d.float(), want_d.float(), rtol=0,
                                   atol=2e-2)
        torch.testing.assert_close(got_p.float(), want_p.float(), rtol=0,
                                   atol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_decode_rejects_bad_arguments(cuda_device):
    q = torch.zeros((1, 2, 72), device=cuda_device)
    k = torch.zeros((1, 8, 2, 72), device=cuda_device)
    lens = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode(q, k, k, lens, layout="bshd")
    q = torch.zeros((1, 2, 64), device=cuda_device)
    k = torch.zeros((1, 2, 64, 8), device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q, k, k, lens, layout="bhsd")
    k = torch.zeros((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        flash_decode(q, k, k, lens.long(), layout="bshd")
    with pytest.raises(ValueError, match="bfloat16"):
        flash_decode(q, k.bfloat16(), k.bfloat16(), lens, layout="bshd")


@pytest.mark.cuda
def test_cuda_paged_kernels_reject_a_head_dim_they_are_not_built_for(
        cuda_device):
    """D = 72 is no instance of paged_decode.cu or paged_prefill.cu: a
    CUDA tensor raises, it never falls back to the plain version."""
    pages = torch.zeros((2, 4, 16, 72), device=cuda_device)
    table = torch.ones((1, 2), dtype=torch.int32, device=cuda_device)
    lens = torch.full((1,), 5, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        paged_flash_decode(torch.zeros((1, 2, 72), device=cuda_device),
                           pages, pages, table, lens)
    with pytest.raises(ValueError, match="head_dim"):
        fastattn_paged_prefill(
            torch.zeros((1, 2, 5, 72), device=cuda_device), pages, pages,
            table, torch.zeros_like(lens), lens)


# (b, h, s, dk, dv, chunk, layout, forget bias): ragged S, S below the
# chunk, dv not a multiple of the 64-column tile, dk = dv = 384
# (xlstm-125m's heads), and the model's (B, S, H, D) projections read in
# place ("bshd").  Then 16 chunks of state recurrence at a small dk/dv, a
# ragged S over eight chunks, and a forget bias of -2: m then falls across
# chunks and the stabiliser changes sign
MLSTM_CASES = [
    (2, 3, 300, 64, 96, 128, "bhsd", 2.0),
    (1, 2, 50, 32, 32, 128, "bhsd", 2.0),
    (2, 2, 200, 48, 40, 64, "bshd", 2.0),
    (1, 2, 260, 384, 384, 128, "bshd", 2.0),
    (2, 2, 2048, 32, 48, 128, "bhsd", 2.0),
    (1, 3, 1000, 64, 64, 128, "bshd", 2.0),
    (2, 2, 700, 64, 96, 128, "bhsd", -2.0),
]


def _mlstm_inputs(rng, b, h, s, dk, dv, layout, device, dtype, bias=2.0):
    def draw(*shape):
        return _t(rng.normal(size=shape).astype(np.float32)).to(device)
    if layout == "bshd":
        q, k, v = (draw(b, s, h, d).to(dtype).transpose(1, 2)
                   for d in (dk, dk, dv))
    else:
        q, k, v = (draw(b, h, s, d).to(dtype) for d in (dk, dk, dv))
    return q, k, v, draw(b, h, s), draw(b, h, s) + bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLSTM_CASES)
def test_cuda_mlstm_chunkwise_fwd_matches_plain(cuda_device, case, dtype):
    b, h, s, dk, dv, chunk, layout, bias = case
    rng = np.random.default_rng(11)
    q, k, v, ig, fg = _mlstm_inputs(rng, b, h, s, dk, dv, layout,
                                    cuda_device, dtype, bias)
    before = mlstm_chunkwise_fwd.launches
    got, state = mlstm_chunkwise_fwd(q, k, v, ig, fg, chunk=chunk)
    assert mlstm_chunkwise_fwd.launches == before + 1
    want, want_state = mlstm_ref.mlstm_chunkwise(
        q, k, v, ig, fg, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, s, dv)
    assert torch.isfinite(got).all()
    rel = 1e-4 if dtype == torch.float32 else 2 ** -7
    scale = want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=rel * scale)
    for g, w in zip(state, want_state):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())


@pytest.mark.cuda
def test_cuda_mlstm_autograd_matches_plain(cuda_device):
    """The autograd op launches the kernel in the forward and recomputes
    through the plain version in the backward: h and every gradient equal
    the plain path's (float32, 1e-4 of each one's scale)."""
    rng = np.random.default_rng(12)
    inputs = _mlstm_inputs(rng, 2, 2, 150, 64, 64, "bshd", cuda_device,
                           torch.float32)
    g = _t(rng.normal(size=(2, 2, 150, 64)).astype(np.float32)).to(
        cuda_device)
    res = {}
    for impl in ("kernel", "reference"):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        before = mlstm_chunkwise_fwd.launches
        out = mlstm_chunkwise(*leaves, 64, impl=impl)
        launched = mlstm_chunkwise_fwd.launches - before
        assert launched == (1 if impl == "kernel" else 0)
        res[impl] = (out, *torch.autograd.grad(out, leaves, g))
    for got, want in zip(res["kernel"], res["reference"]):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
def test_cuda_mlstm_chunkwise_fwd_rejects_bad_arguments(cuda_device):
    q = torch.zeros((1, 2, 8, 32), device=cuda_device)
    gates = torch.zeros((1, 2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="bad arguments"):
        mlstm_chunkwise_fwd(q, q[..., :16], q, gates, gates)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 32, 8), device=cuda_device).transpose(2, 3)
        mlstm_chunkwise_fwd(t, t, t, gates, gates)
    with pytest.raises(ValueError, match="chunk"):
        q = torch.zeros((1, 2, 300, 32), device=cuda_device)
        g = torch.zeros((1, 2, 300), device=cuda_device)
        mlstm_chunkwise_fwd(q, q, q, g, g, chunk=256)
    with pytest.raises(ValueError, match="expected"):
        mlstm_chunkwise_fwd(q, q.bfloat16(), q, g, g)
    with pytest.raises(ValueError, match="shared memory"):
        q = torch.zeros((1, 1, 8, 2048), device=cuda_device)
        g = torch.zeros((1, 1, 8), device=cuda_device)
        mlstm_chunkwise_fwd(q, q, q, g, g)
