"""The parts of ``chip_smoke.py`` that run without a card: its check of
the ``-Xptxas -v`` build log, its phase-2 case lists, its per-row output
gate and its profile groups; and ``kernels_bench.py``'s refusal without
a card."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(name, stores=0, loads=0, regs=183):
    return (f"ptxas info    : Compiling entry function '{name}' for "
            "'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


WG = "_ZN12_GLOBAL__N_118fastattn_fwd_wgmmaILi128EEEvPK13__nv_bfloat16"
FMA = "_ZN12_GLOBAL__N_119fastattn_fwd_kernelIfLi256EEEvPKT_"
DECODE = ("_ZN12_GLOBAL__N_119flash_decode_kernelI13__nv_bfloat16Li128ELi1E"
          "EEvNS_4ArgsE")
PAGED = "_ZN12_GLOBAL__N_119paged_decode_kernelIfLi256ELi8EEEvNS_4ArgsE"


def test_clean_build_log_has_no_faults(cs):
    assert cs.ptxas_faults(_entry(WG) + _entry(FMA, 8, 8) + _entry(DECODE)
                           + _entry(PAGED, 8, 8)) == []


@pytest.mark.parametrize("stores,loads", [(16, 0), (0, 16)])
def test_spills_in_a_flash_decode_kernel_are_faults(cs, stores, loads):
    """A spill in any instance of the dense decode kernel fails phase 1:
    local-memory traffic in a kernel bound by bytes (the paged kernel's
    instances are not held to it)."""
    faults = cs.ptxas_faults(_entry(PAGED, 8, 8)
                             + _entry(DECODE, stores, loads))
    assert len(faults) == 1 and faults[0].startswith(DECODE)


@pytest.mark.parametrize("stores,loads", [(16, 0), (0, 16), (8, 8)])
def test_spills_in_a_wgmma_kernel_are_faults(cs, stores, loads):
    faults = cs.ptxas_faults(_entry(FMA) + _entry(WG, stores, loads))
    assert len(faults) == 1 and faults[0].startswith(WG)


@pytest.mark.parametrize("code", ["C7510", "C7514", "C7517", "C7519",
                                  "C7520"])
def test_serialized_wgmma_advisory_is_a_fault(cs, code):
    advisory = (f"ptxas info    : ({code}) Potential Performance Loss: "
                "wgmma.mma_async instructions are serialized due to program "
                f"dependence on compiler-inserted WG.AR in divergent path in "
                f"the function '{WG}'\n")
    assert len(cs.ptxas_faults(advisory + _entry(WG))) == 1


def test_attention_cases_reach_the_tile_edges(cs):
    """Phase 2 keeps the main-path shapes first and holds bf16 cases with
    ragged Sq, a q_offset, a kv_valid tail, GQA and 16-key pages."""
    name, fwd = cs.FWD_CASES[0]
    assert (fwd["b"], fwd["hq"], fwd["sq"], fwd["d"], fwd["dtype"]) == (
        4, 32, 2048, 128, "bfloat16")
    assert any(kw["dtype"] == "bfloat16" and kw["sq"] % 128
               and kw.get("q_offset") and kw.get("kv_valid")
               and kw["hq"] != kw["hkv"] for _, kw in cs.FWD_CASES)
    name, pre = cs.PREFILL_CASES[0]
    assert (pre["chunk"], pre["ps"], pre["dtype"]) == (512, 128, "bfloat16")
    assert any(kw["dtype"] == "bfloat16" and kw["ps"] == 16
               and 0 in kw["nvalid"] for _, kw in cs.PREFILL_CASES)
    for _, kw in cs.FWD_CASES + cs.PREFILL_CASES:
        assert kw["dtype"] in cs.TOL


def test_decode_and_mlstm_cases_reach_the_split_edges(cs):
    """Phase 2 keeps the main-path shapes first, holds paged decode at the
    split-KV edges and the mLSTM over many chunks and a negative forget
    bias."""
    _, dec = cs.DECODE_CASES[0]
    assert (dec["b"], dec["hq"], dec["d"], dec["ps"], dec["n_kv"],
            dec["dtype"]) == (8, 32, 128, 128, 16, "bfloat16")
    assert "lens" not in dec
    kws = [kw for _, kw in cs.DECODE_CASES]
    assert [kw["lens"](256) for kw in kws if callable(kw.get("lens"))] == [
        [255, 256, 257, 1]]
    assert any(kw.get("window") and max(kw["lens"]) > kw["window"]
               for kw in kws if isinstance(kw.get("lens"), list))
    assert any(kw["b"] == 1 and kw.get("lens") == [4096] for kw in kws)
    assert any(kw.get("lens") == [1] * kw["b"] for kw in kws)
    _, mls = cs.MLSTM_CASES[0]
    assert (mls["b"], mls["h"], mls["s"], mls["dk"], mls["dv"],
            mls["dtype"], mls["layout"]) == (8, 4, 2048, 384, 384,
                                             "bfloat16", "bshd")
    kws = [kw for _, kw in cs.MLSTM_CASES]
    assert any(kw["s"] >= 16 * 128 and kw["dk"] < 384 for kw in kws)
    assert any(kw["s"] % 128 and kw["s"] > 4 * 128
               and kw["dtype"] == "bfloat16" for kw in kws)
    assert any(kw.get("fbias", 3.0) < 0 for kw in kws)
    # dense decode: the long shapes (the kernels line's, and the paper's
    # longest), qwen2.5-32b's GQA, the split edges and a window narrower
    # than the 32-key split
    dense = dict(cs.DENSE_DECODE_CASES)
    long = dense[cs.LONG_DECODE]
    assert (long["b"], long["hq"], long["hkv"], long["s"], long["d"],
            long["dtype"], long["layout"]) == (1, 32, 32, 65536, 128,
                                               "bfloat16", "bshd")
    kws = list(dense.values())
    assert any(kw["b"] == 1 and kw["s"] == 262144 for kw in kws)
    assert any((kw["hq"], kw["hkv"]) == (40, 8) and kw["s"] == 32768
               for kw in kws)
    assert [kw["lens"](256) for kw in kws if callable(kw.get("lens"))] == [
        [255, 256, 257, 1]]
    assert any(kw.get("window") and kw["window"] < 32
               and max(kw["lens"]) > kw["window"] for kw in kws
               if isinstance(kw.get("lens"), list))
    for _, kw in cs.DECODE_CASES + cs.MLSTM_CASES + cs.DENSE_DECODE_CASES:
        assert kw["dtype"] in cs.TOL


def _dropped_paged_split():
    """Paged decode that drops the last 256-key split of a 16384-key row
    (B=2, 2 kv heads): (the kernel's output, the plain one)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode.ref import paged_decode_reference
    rng = np.random.default_rng(0)
    hkv, d, ps, n_kv = 2, 128, 128, 128
    num_pages = 2 * n_kv + 4

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).bfloat16().float()
    kp, vp = draw(hkv, num_pages, ps, d), draw(hkv, num_pages, ps, d)
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages))[
        :2 * n_kv].reshape(2, n_kv).astype(np.int32))
    q = draw(2, hkv, 1, d)
    lens = torch.tensor([n_kv * ps, 700], dtype=torch.int32)
    want = paged_decode_reference(q, kp, vp, table, lens)[:, :, 0]
    dropped = lens.clone()
    dropped[0] -= 256
    got = paged_decode_reference(q, kp, vp, table, dropped)[:, :, 0]
    return got, want


def _dropped_dense_split():
    """Dense decode at llama2-7b's long shape, B=1 with 32 query heads on
    a 65536-key row, in which head 5 lost the first split of the card's
    plan (8192 keys: the window below leaves them out).  One kv head
    shared by the 32 (MQA) keeps the cache small here; the output is
    (1, 32, 128) as in phase 2.  (the kernel's output, the plain one)"""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode.ops import plan_dense_splits
    from repro_torch.kernels.flash_decode.ref import decode_reference
    s, d = 65536, 128
    split_keys, _ = plan_dense_splits(1, 32, 32, s, None, 132)
    rng = np.random.default_rng(1)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).bfloat16().float()
    k, v, q = draw(1, s, 1, d), draw(1, s, 1, d), draw(1, 32, 1, d)
    lens = torch.tensor([s], dtype=torch.int32)
    want = decode_reference(q, k, v, lens, layout="bshd")[:, :, 0]
    dropped = decode_reference(q, k, v, lens, window=s - split_keys,
                               layout="bshd")[:, :, 0]
    got = want.clone()
    got[:, 5] = dropped[:, 5]
    return got, want


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_row_gate_rejects_a_dropped_split(cs, kind):
    """A decode "kernel" that drops one split of a long row: the absolute
    gate alone passes it, held_to_plain's per-row gate (which phase 2
    applies to every (batch, head) row of both decode kernels) does
    not."""
    got, want = (_dropped_paged_split if kind == "paged"
                 else _dropped_dense_split)()
    d = want.shape[-1]
    err = (got - want).abs().max().item()
    assert 0 < err <= cs.TOL["bfloat16"]
    with pytest.raises(AssertionError, match="relative"):
        cs.held_to_plain("decode", "dropped split", got.reshape(-1, d),
                         want.reshape(-1, d), "bfloat16")
    cs.held_to_plain("decode", "whole", want.reshape(-1, d),
                     want.reshape(-1, d), "bfloat16")


def _kernels_of(source):
    import re
    text = (ROOT / source).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)", text)


def test_profiles_read_every_kernel_of_the_redesigned_sources(cs):
    """The profile groups of phase 6b and profile_serving.py match every
    CUDA kernel of mlstm_chunkwise.cu and paged_decode.cu, and phase 3c
    every one of flash_decode.cu (so a kernel renamed or added in a
    redesign is not read as 0)."""
    spec = importlib.util.spec_from_file_location(
        "profile_serving", ROOT / "profile_serving.py")
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)
    mlstm = _kernels_of("src/repro_torch/kernels/mlstm/csrc/"
                        "mlstm_chunkwise.cu")
    assert len(mlstm) == 4
    for name in mlstm:
        key = f"void (anonymous namespace)::{name}<float, 64>(Args)"
        assert cs._train_group(key).startswith("mLSTM forward")
    decode = _kernels_of("src/repro_torch/kernels/flash_decode/csrc/"
                         "paged_decode.cu")
    assert decode
    for name in decode:
        key = f"void (anonymous namespace)::{name}<__nv_bfloat16, 128, 1>"
        assert ps._group(key) == "attention: paged_decode.cu"
    # phase 3c reads the dense decode kernel's share by this name
    dense = _kernels_of("src/repro_torch/kernels/flash_decode/csrc/"
                        "flash_decode.cu")
    assert dense and all("flash_decode_" in name for name in dense)


def test_kernels_bench_needs_a_card():
    """kernels_bench.py measures only on a GPU: without one it exits 2
    and prints no result."""
    import subprocess
    import sys
    run = subprocess.run([sys.executable, str(ROOT / "kernels_bench.py")],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 2 and run.stdout == ""
