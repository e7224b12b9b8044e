"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; without a card they skip.  They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (only the order of sums differs); bfloat16 2e-2
(both sides accumulate in float32 and round the output once to bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fastattention import fast_attention_decode  # noqa: E402
from repro_torch.kernels.fastattn.ops import \
    fastattn_paged_prefill  # noqa: E402
from repro_torch.kernels.fastattn.ref import \
    paged_prefill_reference  # noqa: E402
from repro_torch.kernels.flash_decode.ops import \
    paged_flash_decode  # noqa: E402

# (b, hq, hkv, ps, n_kv, d, lens, window, softcap); the last row is an
# idle engine slot: all-scratch table row, kv_len 1
DECODE_CASES = [
    (3, 4, 4, 16, 5, 64, [80, 33, 1], None, None),
    (3, 8, 4, 16, 6, 128, [17, 96, 1], 40, 30.0),
    (2, 4, 2, 128, 2, 256, [200, 1], None, 50.0),
    (3, 20, 2, 128, 3, 128, [384, 129, 1], 100, None),     # g=10: 2 tiles
]
# (hq, hkv, ps, n_kv, d, chunk, starts, nvalid, window, softcap); a row
# with n_valid 0 is a padded batch row: all-scratch table, kv_len 0
PREFILL_CASES = [
    (4, 4, 16, 6, 64, 32, [0, 32, 0], [32, 20, 0], None, None),
    (4, 2, 16, 6, 128, 32, [16, 50, 0], [32, 11, 0], 24, 30.0),
    (2, 2, 128, 2, 256, 64, [0, 100, 0], [64, 37, 0], None, 50.0),
    (4, 2, 128, 3, 128, 100, [128, 3, 0], [100, 77, 0], 100, None),
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
    rng = np.random.default_rng(5)
    num_pages = b * n_kv + 3
    kp, vp = (_t(a).to(cuda_device, dtype)
              for a in _pools(rng, hkv, num_pages, ps, d))
    table = _table(rng, b, n_kv, num_pages)
    table[-1] = 0
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
