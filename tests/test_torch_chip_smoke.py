"""The parts of ``chip_smoke.py`` that run without a card: its check of
the ``-Xptxas -v`` build log and its phase-2 attention cases."""
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


def test_clean_build_log_has_no_faults(cs):
    assert cs.ptxas_faults(_entry(WG) + _entry(FMA, 8, 8)) == []


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
