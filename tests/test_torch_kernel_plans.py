"""Host-side plans of the port's CUDA kernels, checked without a card:
the split-KV planner of ``paged_decode.cu`` and ``flash_decode.cu`` and
the workspace of the bfloat16 ``mlstm_chunkwise.cu``."""
import itertools
import math

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.flash_decode.ops import (  # noqa: E402
    SPLIT_STEP, plan_dense_splits, plan_splits, rows_per_cta)
from repro_torch.kernels.mlstm.ops import workspace_floats  # noqa: E402

GRID = list(itertools.product(
    (1, 3, 8, 64),              # B
    (1, 4, 8, 32),              # Hkv
    (1, 2, 4, 5, 8),            # g
    (1, 5, 16, 128),            # n_kv
    (16, 128),                  # page size
    (None, 40, 256, 4096),      # window
    (132, 78)))                 # SM count


@pytest.mark.parametrize("sms", [132, 78])
def test_split_plan_covers_every_key_once_and_fills_the_card(sms):
    for b, hkv, g, n_kv, ps, window, sm in GRID:
        if sm != sms:
            continue
        split_keys, n_split = plan_splits(b, hkv, g, n_kv, ps, window, sm)
        width = n_kv * ps
        span = min(window, width) if window else width
        assert split_keys % SPLIT_STEP == 0 and n_split >= 1
        # the key at offset o of a row's valid range lies in split
        # o // split_keys alone, and every offset a row can have has one
        assert n_split * split_keys >= span
        assert (n_split - 1) * split_keys < span
        owners = [o // split_keys for o in range(span)]
        assert owners == sorted(owners) and owners[-1] == n_split - 1
        ctas = b * hkv * math.ceil(g / rows_per_cta(g)) * n_split
        # a wave on the card wherever the span allows as many splits
        assert ctas >= sm or n_split == math.ceil(span / SPLIT_STEP)


def test_split_plan_of_the_main_decode_shapes():
    # llama2-7b serving (B=8, 32/32 heads, 16 pages of 128) on 132 SMs
    assert plan_splits(8, 32, 1, 16, 128, None, 132) == (704, 3)
    # gemma2-2b's 256-key window (B=8, 8/4 heads)
    assert plan_splits(8, 4, 2, 16, 128, 256, 132) == (32, 8)
    # enough CTAs already: one split a row
    assert plan_splits(128, 32, 1, 4, 16, None, 132) == (64, 1)


def _dense_splits(kv_len, s_max, window, split_keys):
    """The key ranges the splits of one flash_decode.cu row walk: the
    kernel's own arithmetic (n_active from kv_len, split z from the row's
    first valid key)."""
    kv_end = min(kv_len, s_max)
    kv_begin = max(kv_len - window, 0) if window else 0
    n_active = -(-max(kv_end - kv_begin, 0) // split_keys)
    return [range(kv_begin + z * split_keys,
                  min(kv_begin + (z + 1) * split_keys, kv_end))
            for z in range(n_active)]


@pytest.mark.parametrize("s_max,window", [
    (65537, None), (65537, 4096), (161, None), (161, 20), (1000, 999),
    (4096, 5000)])
def test_dense_split_plan_covers_every_key_once(s_max, window):
    """The dense plan (the cache width as the span, a key a "page") walks
    every valid key of a row once, with at most n_split active splits,
    for kv_len far below the cache width, at it, and under a window."""
    for b, hkv, g in ((1, 32, 1), (8, 32, 1), (2, 8, 5), (4, 2, 4)):
        split_keys, n_split = plan_dense_splits(b, hkv * g, hkv, s_max,
                                                window, 132)
        for kv_len in {1, 2, 31, 32, 33, 159, split_keys - 1, split_keys,
                       split_keys + 1, s_max // 2, s_max - 1, s_max}:
            if kv_len < 1:
                continue
            splits = _dense_splits(kv_len, s_max, window, split_keys)
            keys = [k for r in splits for k in r]
            lo = max(kv_len - window, 0) if window else 0
            assert keys == list(range(lo, min(kv_len, s_max)))
            assert 1 <= len(splits) <= n_split
            assert all(len(r) > 0 for r in splits)


def test_split_plan_of_the_dense_decode_shapes():
    # phase 3b: generate's caches, B=8 x 161 tokens, llama2-7b 32/32: the
    # rows already fill the card, one split
    assert plan_dense_splits(8, 32, 32, 161, None, 132) == (192, 1)
    # llama2-7b at B=1 on 65536 tokens (phase 2), and phase 3c's 65537:
    # 8 splits, 256 CTAs
    assert plan_dense_splits(1, 32, 32, 65536, None, 132) == (8192, 8)
    assert plan_dense_splits(1, 32, 32, 65537, None, 132) == (8224, 8)
    # qwen2.5-32b's GQA 40/8 (one 8-row tile a kv head) at B=2, 32768: 256
    # CTAs, one wave of the 8-row instance (2 an SM)
    assert plan_dense_splits(2, 40, 8, 32768, None, 132) == (2048, 16)
    # a window narrower than the 32-key step: one split
    assert plan_dense_splits(4, 8, 2, 2048, 20, 132) == (32, 1)
    # the dense aim leaves the paged plans as they were
    assert plan_splits(8, 32, 1, 16, 128, None, 132) == (704, 3)


def test_rows_per_cta_follows_the_kernel_dispatch():
    assert [rows_per_cta(g) for g in (1, 2, 3, 4, 5, 8, 10)] == [
        1, 2, 4, 4, 8, 8, 8]


def test_mlstm_workspace_of_xlstm_125m():
    """The state before each of the 16 chunks of every (b, h) at
    xlstm-125m's training shape, with its gate records: 304 MB."""
    n = workspace_floats(8, 4, 2048, 384, 384, 128)
    assert n == 8 * 4 * 16 * (384 * 384 + 384 + 644)
    assert n * 4 == 304_095_232
    # a ragged tail takes a whole chunk's slot
    assert workspace_floats(1, 1, 129, 64, 64, 128) == 2 * (
        64 * 64 + 64 + 644)
