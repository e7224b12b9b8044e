"""The parts of ``chip_smoke.py`` that run without a card: its check of
the ``-Xptxas -v`` build log, its phase-2 case lists, its per-row output
gate, its profile groups, and phase 3d's traffic and gates (each must
reject a faked failure); and ``kernels_bench.py``'s refusal without a
card."""
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
    assert [255, 256, 257, 1] in [kw["lens"](256) for kw in kws
                                  if callable(kw.get("lens"))]
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


@pytest.mark.parametrize("d", [80, 96])
def test_phase2_holds_every_attention_kernel_at_head_dims_80_and_96(cs, d):
    """Each of the four attention kernels at D = 80 and 96, in bf16 and
    float32, its bf16 case at the main path's shape (the kernels line's
    d80_* / d96_* numbers): paged decode B=8 at 32/32 heads on 16 pages of
    128, a chunk-512 prefill with a ragged and a padded row, the causal
    forward at B=4, S=2048, dense decode at B=1 on 65536 tokens, and
    dense decode at generate's kv_len 159 in both layouts."""
    lists = {"paged_decode": cs.DECODE_CASES,
             "paged_prefill": cs.PREFILL_CASES,
             "fastattn_fwd": cs.FWD_CASES,
             "flash_decode": cs.DENSE_DECODE_CASES}
    for kernel, cases in lists.items():
        assert {kw["dtype"] for _, kw in cases if kw["d"] == d} == {
            "bfloat16", "float32"}, kernel
        main = dict(cases)[cs.head_dim_case(kernel, d)]
        assert (main["d"], main["dtype"]) == (d, "bfloat16")
        assert cs.head_dim_case(kernel, d, "float32") in dict(cases) or \
            kernel == "flash_decode"
    dec = dict(cs.DECODE_CASES)[cs.head_dim_case("paged_decode", d)]
    assert (dec["b"], dec["hq"], dec["hkv"], dec["ps"], dec["n_kv"]) == (
        8, 32, 32, 128, 16)
    pre = dict(cs.PREFILL_CASES)[cs.head_dim_case("paged_prefill", d)]
    assert pre["chunk"] == 512 and 0 in pre["nvalid"] and any(
        0 < n < 512 for n in pre["nvalid"])
    fwd = dict(cs.FWD_CASES)[cs.head_dim_case("fastattn_fwd", d)]
    assert (fwd["b"], fwd["hq"], fwd["sq"], fwd["skv"]) == (4, 32, 2048, 2048)
    assert fwd.get("causal", True)
    long = dict(cs.DENSE_DECODE_CASES)[cs.head_dim_case("flash_decode", d)]
    assert (long["b"], long["s"], long["layout"]) == (1, 65536, "bshd")
    gen = {(kw["layout"], kw["dtype"]) for _, kw in cs.DENSE_DECODE_CASES
           if kw["d"] == d and kw["s"] == 161 and kw["lens"] == [159] * 8}
    assert gen == {(lay, dt) for lay in ("bshd", "bhsd")
                   for dt in ("bfloat16", "float32")}


def test_phase2_head_dim_cases_reach_the_edges(cs):
    """At D = 80 paged decode's split edges; at D = 96 a GQA group of 4
    (the 16-lane thread group against the 4-row tile); at each a ragged
    prefill chunk with a padded row and a ragged float32 forward with a
    q_offset and a kv_valid tail."""
    dec = [kw for _, kw in cs.DECODE_CASES if kw["d"] in (80, 96)]
    assert any(kw["d"] == 80 and callable(kw.get("lens"))
               and kw["lens"](256) == [255, 256, 257, 1] for kw in dec)
    assert any(kw["d"] == 96 and kw["hq"] // kw["hkv"] == 4 for kw in dec)
    for d in (80, 96):
        assert any(kw["d"] == d and kw["chunk"] % 64 and 0 in kw["nvalid"]
                   for _, kw in cs.PREFILL_CASES)
        assert any(kw["d"] == d and kw["dtype"] == "float32"
                   and kw.get("q_offset") and kw.get("kv_valid")
                   for _, kw in cs.FWD_CASES)


def test_phase7_serves_both_head_dim_models(cs):
    """Phase 7 runs after phase 6 on stablelm-3b (D = 80) and
    phi3-mini-3.8b (D = 96), each a head dim the kernels are built for."""
    import inspect
    from repro_torch.config import get_model_config
    from repro_torch.kernels._launch import HEAD_DIMS
    assert cs.HEAD_DIM_ARCHS == {80: "stablelm-3b", 96: "phi3-mini-3.8b"}
    for d, arch in cs.HEAD_DIM_ARCHS.items():
        cfg = get_model_config(arch)
        assert cfg.head_dim == d and d in HEAD_DIMS
        assert cfg.num_layers == 32
    main = inspect.getsource(cs.main)
    assert main.index("phase_xlstm()") < main.index("phase_head_dims()")
    assert cs.APPLY_TOKENS == 2048


def test_kernels_line_gains_head_dim_entries(cs):
    """Each attention kernel's entry gets d80_* and d96_* numbers (phase
    2's bf16 main-shape case; flash_decode's from phase 7 (b), with its
    long shape beside them) and its phase 7 launches; the mLSTM's none."""
    def res(tag):
        return {"err": 1e-3, "ms": tag, "device_ms": tag / 2,
                "plain_ms": 9.0, "bound_ms": 0.01, "bound_by": "bytes",
                "library_ms": None, "library_device_ms": 0.5}
    attn = ("paged_prefill", "paged_decode", "fastattn_fwd", "flash_decode")
    kernels = [{"name": n} for n in attn + ("mlstm_chunkwise",)]
    cases = {(n, d): res(float(d)) for n in attn for d in (80, 96)}
    runs = {d: {"launches": {"paged_decode": 2272, "paged_prefill": 576,
                             "flash_decode": 5088, "fastattn_fwd": 32},
                "flash_decode": res(d + 0.5)} for d in (80, 96)}
    cs.add_head_dim_entries(kernels, cases, runs)
    by = {k["name"]: k for k in kernels}
    assert by["mlstm_chunkwise"] == {"name": "mlstm_chunkwise"}
    for d in (80, 96):
        assert by["paged_decode"][f"d{d}_ms"] == d
        assert by["paged_decode"][f"d{d}_launches"] == 2272
        assert by["fastattn_fwd"][f"d{d}_launches"] == 32
        assert by["flash_decode"][f"d{d}_ms"] == d + 0.5
        assert by["flash_decode"][f"d{d}_long_device_ms"] == d / 2
        for n in attn:
            assert {f"d{d}_{x}" for x in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "launches")} <= set(by[n])


def test_phase2_holds_the_paged_kernels_at_a_tp2_rank_shape(cs):
    """Phase 3e (a) runs both paged kernels on each rank of llama2-7b at
    tp=2 (16 of the 32 heads): phase 2 holds them to their plain versions
    at that shape, paged decode at the engine's 8 slots (the split plan
    of B * Hkv = 128) and at that plan's split edges, prefill on 8 rows
    with padding."""
    from repro_torch.config import ServeConfig, get_model_config
    from repro_torch.sharding.tp import plan_tp
    cfg = get_model_config("llama2-7b")
    serve = ServeConfig(**cs.SERVE_3)
    plan = plan_tp(cfg, 2, serve.page_size)
    shape = dict(hq=cfg.num_heads // plan.g, hkv=cfg.num_kv_heads // plan.g,
                 d=cfg.head_dim, ps=serve.page_size // plan.s,
                 n_kv=serve.max_seq_len // serve.page_size,
                 dtype="bfloat16")
    assert (shape["hq"], shape["hkv"]) == (16, 16)

    def at_shape(kw):
        return all(kw[k] == v for k, v in shape.items())
    dec = [kw for _, kw in cs.DECODE_CASES
           if at_shape(kw) and kw["b"] == serve.max_batch]
    assert any("lens" not in kw for kw in dec)
    edges = [kw["lens"](416) for kw in dec if callable(kw.get("lens"))]
    assert edges == [[415, 416, 417, 831, 832, 833, 2048, 1]]
    pre = [kw for _, kw in cs.PREFILL_CASES
           if at_shape(kw) and kw["chunk"] == serve.prefill_chunk]
    assert len(pre) == 1 and len(pre[0]["starts"]) == serve.max_batch
    assert 0 in pre[0]["nvalid"]


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


# ---------------------------------------------------------------------------
# phase 3d: the rest of the paged engine
# ---------------------------------------------------------------------------

def test_verify_shape_case_and_feature_traffic(cs):
    """Phase 2 holds paged_prefill at the speculative verify shape, and
    phase 3d's traffic has the sizes it is meant to have."""
    kw = dict(cs.PREFILL_CASES)[cs.VERIFY_CASE]
    assert (kw["chunk"], kw["ps"], kw["n_kv"], kw["dtype"]) == (
        5, 128, 16, "bfloat16")
    assert kw["nvalid"] == [5, 5, 4, 3, 2, 1, 1, 0]
    assert kw["starts"][-1] == 0
    assert min(kw["starts"][:-1]) >= 37 and max(kw["starts"]) <= 1900
    t = cs.feature_traffic(32000)
    prefix = [x for w in t["prefix"] for x in w]
    assert len(t["prefix"]) == 2 and len(prefix) == 8
    system = prefix[0][1][:cs.SYSTEM_LEN]
    for _, prompt, n in prefix:
        assert (prompt[:cs.SYSTEM_LEN] == system).all() and n == 32
        assert 64 <= len(prompt) - cs.SYSTEM_LEN <= 448
    assert len(t["pressure"][0]) == 8 and all(
        1200 <= len(p) <= 1800 and n == 128 for _, p, n in t["pressure"][0])
    assert all(len(p) == 256 and n == 64 for _, p, n in t["spec"][0])
    faults = [x for w in t["faults"] for x in w]
    assert len({rid for rid, _, _ in faults}) == 8
    assert any(len(p) == cs.SYSTEM_LEN for _, p, _ in faults)
    assert [len(p) for _, p, _ in t["scan"][0]] == [128]


def test_every_fault_site_is_armed_once(cs):
    from repro_torch.serving.faults import SITES
    assert set(cs.FAULT_CALLS) == set(SITES)
    assert set(cs.FAILING_SITES) < set(SITES)


def test_tokens_gate_rejects_a_clear_margin_mismatch(cs):
    ref = {0: [5, 6, 7], 1: [1, 2, 3]}
    margins = {(r, t): (1.0, 0.1) for r in ref for t in range(3)}
    assert cs.tokens_gate("same", ref, ref, margins) == (6, 6)
    forked = {0: [5, 9, 9], 1: [1, 2, 3]}
    near = dict(margins)
    near[(0, 1)] = (0.05, 0.1)                 # a near-tie may fork
    assert cs.tokens_gate("near-tie", forked, ref, near) == (4, 6)
    with pytest.raises(AssertionError, match="margin"):
        cs.tokens_gate("clear", forked, ref, margins)
    with pytest.raises(AssertionError, match="tokens"):
        cs.tokens_gate("short", {0: [5, 6], 1: [1, 2, 3]}, ref, margins)


def test_run_gates_reject_faked_failures(cs):
    cs.launch_gate("ok", {"paged_prefill": 3, "paged_decode": 0},
                   ("paged_prefill",))
    with pytest.raises(AssertionError, match="never launched"):
        cs.launch_gate("none", {"paged_prefill": 3, "paged_decode": 0},
                       ("paged_prefill", "paged_decode"))
    clean = {"pages_used": 8, "prefix_cached_pages": 8, "active_slots": 0}
    cs.leak_gate("ok", clean, 0)
    for stats, stash in ((dict(clean, pages_used=9), 0),
                         (dict(clean, active_slots=1), 0), (clean, 1)):
        with pytest.raises(AssertionError):
            cs.leak_gate("leak", stats, stash)
    pressure = {"preemptions": 2, "swap_bytes_in": 64, "swap_bytes_out": 64}
    cs.pressure_gate("ok", {"pressure": pressure})
    for bad in (dict(pressure, preemptions=0),
                dict(pressure, swap_bytes_in=32)):
        with pytest.raises(AssertionError):
            cs.pressure_gate("bad", {"pressure": bad})
    warm = [(1100, 1024), (1300, 1024)]
    assert cs.prefix_gate("ok", {"prefix": {"hits": 2}}, warm, 1024) == 352
    with pytest.raises(AssertionError, match="no prefix hit"):
        cs.prefix_gate("cold", {"prefix": {"hits": 0}}, warm, 1024)
    with pytest.raises(AssertionError, match="prefilled"):
        cs.prefix_gate("short", {"prefix": {"hits": 2}},
                       [(1100, 1024), (1300, 896)], 1024)
    cs.spec_gate("ok", {"spec": {"verify_launches": 3, "drafted": 5}})
    for bad in ({"verify_launches": 0, "drafted": 5},
                {"verify_launches": 3, "drafted": 0}):
        with pytest.raises(AssertionError):
            cs.spec_gate("bad", {"spec": bad})


def test_fault_gate_rejects_other_failures(cs):
    log = [("prefill_launch", 3), ("sample", 9), ("cow_copy", 1),
           ("page_alloc", 7)]
    named = {3: "injected: injected fault at sample (call 9)",
             7: "injected: injected fault at cow_copy (call 1)"}

    def plus(rid, detail):
        return {**named, rid: detail}
    cs.fault_gate("ok", named, log)
    cs.fault_gate("page_alloc too", plus(
        2, "injected: injected fault at page_alloc (call 7)"), log)
    with pytest.raises(AssertionError, match="another reason"):
        cs.fault_gate("logits", plus(
            1, "logits: request 1: non-finite logits at token 4"), log)
    with pytest.raises(AssertionError, match="another reason"):
        cs.fault_gate("not fired", plus(
            1, "injected: injected fault at sample (call 4)"), log)
    with pytest.raises(AssertionError, match="two requests"):
        cs.fault_gate("twice", plus(
            5, "injected: injected fault at sample (call 9)"), log)
    with pytest.raises(AssertionError, match="failed no request"):
        cs.fault_gate("lost", {3: named[3]}, log)


def test_failure_gate_rejects_failed_requests_without_a_fault(cs):
    """Every run of phase 3d goes through failure_gate: without an
    injector one failed request (non-finite logits quarantined by the
    engine, say) fails the run, whatever its token comparison shows."""
    health = {"failed": 0, "shed": 0, "timed_out": 0, "last_error": None}
    cs.failure_gate("clean", {}, {"health": health}, armed=False)
    failed = dict(health, failed=1,
                  last_error="request 3: logits: non-finite logits")
    error = {3: "logits: request 3: non-finite logits at token 4"}
    for errors, h in ((error, failed), ({}, failed), (error, health),
                      ({}, dict(health, last_error="request 3: x")),
                      ({}, dict(health, shed=1)),
                      ({}, dict(health, timed_out=1))):
        with pytest.raises(AssertionError, match="no fault armed"):
            cs.failure_gate("unarmed", errors, {"health": h}, armed=False)
    named = {3: "injected: injected fault at sample (call 9)"}
    cs.failure_gate("armed", named, {"health": failed}, armed=True)
    for errors, h in (({}, failed), (named, dict(failed, failed=2)),
                      (named, dict(failed, shed=1))):
        with pytest.raises(AssertionError, match="error events"):
            cs.failure_gate("armed", errors, {"health": h}, armed=True)


def _tp_rank_result(**kw):
    res = {"tokens": {0: [5, 6, 7], 1: [1, 2, 3]},
           "tp": {"tp": 2, "g": 2, "s": 1, "collectives": "tiled"},
           "pages_used": 0, "prefill_launches": 2, "decode_launches": 3,
           "launches": {"paged_prefill": 64, "paged_decode": 96}}
    res.update(kw)
    return res


@pytest.mark.parametrize("bad,match", [
    (dict(tokens={0: [5, 6, 8], 1: [1, 2, 3]}), "streams differ"),
    (dict(tp={"tp": 2, "g": 1, "s": 2, "collectives": "tiled"}), "plan"),
    (dict(pages_used=3), "leaked"),
    (dict(launches={"paged_prefill": 63, "paged_decode": 96}),
     "launched paged_prefill 63"),
    (dict(launches={"paged_prefill": 64, "paged_decode": 0}),
     "launched paged_decode 0")])
def test_tp_gate_rejects_faked_failures(cs, bad, match):
    """Phase 3e's gate: the ranks agree exactly, ran the plan, leaked no
    page and launched each paged kernel 32 (here 32) times a launch on
    every rank; and the streams hold to tp=1's under the margin rule."""
    ref = {0: [5, 6, 7], 1: [1, 2, 3]}
    margins = {(r, t): (1.0, 0.1) for r in ref for t in range(3)}
    plan = {"tp": 2, "g": 2, "s": 1, "collectives": "tiled"}
    kernels = ("paged_prefill", "paged_decode")
    assert cs.tp_gate("ok", [_tp_rank_result()] * 2, ref, margins, plan,
                      32, kernels) == (6, 6)
    with pytest.raises(AssertionError, match=match):
        cs.tp_gate("bad", [_tp_rank_result(), _tp_rank_result(**bad)], ref,
                   margins, plan, 32, kernels)
    forked = _tp_rank_result(tokens={0: [5, 9, 9], 1: [1, 2, 3]})
    with pytest.raises(AssertionError, match="margin"):
        cs.tp_gate("clear", [forked] * 2, ref, margins, plan, 32, kernels)


def test_tp_phase_b_traffic_preempts_on_its_pool(cs):
    """Phase 3e (b)'s pressured run asks more pages of its pool than it
    holds, and its two lighter runs share one traffic."""
    t = cs.tp_b_traffic(256)
    assert t["tiled"][1] is t["single"][1]
    serve, waves = t["swap"]
    need = sum(-(-(len(p) + n) // serve["page_size"]) for w in waves
               for _, p, n in w)
    assert serve["preempt_policy"] == "swap"
    assert need > serve["num_pages"] - 1


# ---------------------------------------------------------------------------
# phase 4b: (data=2, model=2) training against phase 4
# ---------------------------------------------------------------------------

def _dist_ref():
    torch = pytest.importorskip("torch")
    return {"loss": [10.0, 9.0, 8.0, 7.0, 6.0],
            "grad_norm": [5.0, 4.0, 3.0, 2.0, 1.0],
            "lr": [3e-4, 2e-4, 1e-4, 5e-5, 3e-5],
            "init": [torch.zeros(8, 2), torch.zeros(3)]}


def _dist_rank_result(cs, r, **kw):
    n = cs.DIST_STEPS
    res = {"coords": {"data": r // 2, "model": r % 2},
           "loss": [10.0, 9.05, 8.0][:n], "grad_norm": [5.05, 4.0, 3.0][:n],
           "lr": [3e-4, 2e-4, 1e-4][:n],
           "launches": cs.TRAIN_LAYERS * 2 * n,
           "q_offsets": [(r % 2) * 1024], "init_keys": [(r, 1), (7, 7)],
           "numel": [8, 3], "ckpt_differs": [], "ckpt_files": 9}
    res.update(kw)
    return res


@pytest.mark.parametrize("bad,match", [
    (dict(loss=[10.2, 9.05, 8.0]), "step 0"),
    (dict(grad_norm=[5.05, 4.1, 3.0]), "step 1"),
    (dict(lr=[3e-4, 2e-4, 1.01e-4]), "step 2"),
    (dict(launches=23), "launched fastattn_fwd 23"),
    (dict(q_offsets=[0, 1024]), "q_offsets"),
    (dict(q_offsets=[512]), "q_offsets"),
    (dict(init_keys=[(9, 9), (7, 7)]), "initial pieces"),
    (dict(numel=[16, 3]), "1/2 of the whole"),
    (dict(ckpt_differs=["arr_3.npy"]), "checkpoint differs"),
])
def test_dist_gate_rejects_faked_failures(cs, bad, match):
    """Phase 4b's gate: the ranks agree, each step's loss and grad norm
    within DIST_LOSS_RTOL / DIST_GNORM_RTOL of phase 4's and lr exact,
    fastattn_fwd TRAIN_LAYERS x 2 x DIST_STEPS launches at the rank's
    q_offset, the initial pieces phase 4's slices, a sharded leaf half
    the whole, the checkpoint the one-rank file."""
    assert cs.DIST_STEPS <= 3 and cs.DIST_MESH == {"data": 2, "model": 2}
    ref, specs = _dist_ref(), [("model",), ()]
    keys = [[(r, 1), (7, 7)] for r in range(4)]
    ok = [_dist_rank_result(cs, r) for r in range(4)]
    cs.dist_gate("ok", ok, ref, keys, specs, 2048, 2)
    # rank 1 is the one at fault: every rank's results are gated
    ranks = [_dist_rank_result(cs, r) for r in range(4)]
    for k, v in bad.items():
        for res in ranks if k in ("loss", "grad_norm", "lr",
                                  "ckpt_differs") else ranks[1:2]:
            res[k] = v[:cs.DIST_STEPS] if k in ("loss", "grad_norm",
                                                "lr") else v
    with pytest.raises(AssertionError, match=match):
        cs.dist_gate("bad", ranks, ref, keys, specs, 2048, 2)
    ranks = [_dist_rank_result(cs, r) for r in range(4)]
    ranks[2]["loss"] = [10.0, 9.05, 8.01][:cs.DIST_STEPS]
    with pytest.raises(AssertionError, match="differs from rank 0"):
        cs.dist_gate("disagree", ranks, ref, keys, specs, 2048, 2)


def _whole_leaves(init, final_one, final_dist) -> list:
    """One rank holding every leaf whole, in ``delta_gate``'s terms: per
    leaf the squared norms of the updates' difference and of one
    device's update."""
    return [{"coords": {}, "delta": [
        ((c.float() - b.float()).square().sum().item(),
         (b.float() - a.float()).square().sum().item())
        for a, b, c in zip(init, final_one, final_dist, strict=True)]}]


def test_delta_gate_holds_each_leaf_update(cs):
    torch = pytest.importorskip("torch")
    init = [torch.zeros(1000), torch.ones(10)]
    one = [torch.linspace(-1, 1, 1000), torch.ones(10)]
    near = [one[0] * 1.05, torch.ones(10)]
    whole = [(), ()]
    rel = cs.delta_gate("ok", ["a", "scale"], _whole_leaves(init, one, near),
                        whole)
    assert rel["scale"] == 0.0 and 0.04 < rel["a"] < 0.06
    with pytest.raises(AssertionError, match="leaf a"):
        cs.delta_gate("far", ["a", "scale"], _whole_leaves(
            init, one, [one[0] * 1.2, torch.ones(10)]), whole)
    flipped = one[0].clone()
    flipped[:300] *= -1                 # 30% of the updates flip sign
    with pytest.raises(AssertionError, match="leaf a"):
        cs.delta_gate("flip", ["a", "scale"], _whole_leaves(
            init, one, [flipped, torch.ones(10)]), whole)
    with pytest.raises(AssertionError, match="leaf scale"):
        cs.delta_gate("moved", ["a", "scale"], _whole_leaves(
            init, one, [one[0], torch.ones(10) * 1.01]), whole)


def test_same_checkpoint_and_bits_key(cs, tmp_path):
    """Phase 4b holds the (2, 2) checkpoint to what a one-rank save of
    the gathered state writes without gathering or writing it again:
    one read of the files, each rank's slice of each leaf against its
    piece's fingerprint, the manifest against the ranks' -- a flipped
    bit in a piece, other extras, a missing or an extra file each fail."""
    torch = pytest.importorskip("torch")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import tree
    from repro_torch.training.checkpoint import CheckpointManager
    state = {"a": torch.randn(4, 6).to(torch.bfloat16),
             "b": torch.arange(6, dtype=torch.int32),
             "c": torch.tensor([[0.0, 1.5], [-0.0, 2.0]]).t(),
             "step": torch.tensor(3, dtype=torch.int32)}
    extras = {"data": {"step": 3}}
    CheckpointManager(str(tmp_path)).save(3, state, extras=extras)
    # two ranks holding rows of "a" and "b" (model axis), the rest whole
    meshes = [make_mesh((2,), ("model",), r) for r in range(2)]
    specs = [("model", None), ("model",), (), ()]
    read = cs.read_checkpoint(str(tmp_path), 3, {"(2,)": (meshes, specs)},
                              False)
    assert read["files"] == ["arr_0.npy", "arr_1.npy", "arr_2.npy",
                             "arr_3.npy", "manifest.json"]
    leaves = tree.leaves_with_paths(state)
    manifest = {"step": 3, "n_leaves": 4, "extras": extras, "leaves": [
        {"path": p, "dtype": str(t.dtype).replace("torch.", ""),
         "shape": list(t.shape)} for p, t in leaves]}

    def ranks(**change):
        out = []
        for r in range(2):
            pieces = [t.chunk(2)[r] if s else t
                      for (_, t), s in zip(leaves, specs)]
            if r == 1 and "flip" in change:
                pieces[2] = pieces[2].clone()
                pieces[2][0, 1] = 0.0             # -0.0 -> 0.0: one bit
            out.append({"final_keys": [cs.bits_key(t) for t in pieces],
                        "ckpt_manifest": change.get("manifest", manifest)})
        return out
    assert cs.checkpoint_differs(read, ranks(), "(2,)") == []
    assert cs.checkpoint_differs(read, ranks(flip=True), "(2,)") == ["/c"]
    other = dict(manifest, extras={"data": {"step": 4}})
    assert cs.checkpoint_differs(read, ranks(manifest=other), "(2,)") == \
        ["manifest.json"]
    read["files"] = read["files"][1:] + ["arr_9.npy"]
    assert cs.checkpoint_differs(read, ranks(), "(2,)") == \
        ["arr_0.npy", "arr_9.npy"]
    x = torch.randn(64).to(torch.bfloat16)
    assert cs.bits_key(x) == cs.bits_key(x.clone())
    assert cs.bits_key(x) != cs.bits_key(x.flip(0))
    y = x.clone()
    y[5] = -y[5]
    assert cs.bits_key(x) != cs.bits_key(y)


def test_kernels_line_gains_context_entries(cs):
    """fastattn_fwd's entry gets phase 2's context-parallel cases (m=1 as
    context_*, m=0 as context_m0_*) and phase 4b's launches a rank; the
    cases are a (2, 2) rank's shape of phase 4's batches."""
    def res(tag):
        return {"err": 1e-3, "ms": tag, "device_ms": tag / 2,
                "plain_ms": 9.0, "bound_ms": 0.05, "bound_by": "operations",
                "library_ms": 0.3, "library_device_ms": 0.2}
    kernels = [{"name": n} for n in ("paged_prefill", "fastattn_fwd")]
    run = {"launches": [24, 24, 24, 24], "q_offsets": [[0], [1024]] * 2}
    cs.add_context_entries(kernels, {0: res(0.1), 1: res(0.2)}, run)
    k = kernels[1]
    assert kernels[0] == {"name": "paged_prefill"}
    assert k["context_ms"] == 0.2 and k["context_m0_device_ms"] == 0.05
    assert k["context_launches"] == [24] * 4
    assert {f"context_{x}" for x in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "launches")} <= set(k)
    for m, (name, kw) in cs.CONTEXT_CASES.items():
        assert kw["q_offset"] == m * cs.TRAIN_SEQ // 2
        assert kw["sq"] == cs.TRAIN_SEQ // 2 and kw["skv"] == cs.TRAIN_SEQ
        assert kw["b"] == cs.TRAIN_BATCH // 2 and f"m={m}" in name
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index("phase_training()") < \
        main.index("phase_dist_training(") < main.index("phase_offload()")
    assert cs.LAUNCHER[-4:] == ["--data", "2", "--model-axis", "2"]


# llama2-7b's block shapes at a width the CPU trains in seconds
BF16_CFG = dict(d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                d_ff=688, vocab_size=4000)


def test_phase4b_bounds_hold_for_bf16_training_on_cpu_ranks(cs, tmp_path):
    """Phase 4b's comparison on the CPU before the card: llama2-7b's
    block shapes at d_model 256 in bf16, phase 4's TrainConfig, the first
    DIST_STEPS steps on one device and on a (2, 2) mesh of gloo ranks
    from the same seeded draw and batches, held by phase 4b's own bounds
    and ``delta_gate``: each step's loss and grad norm within
    DIST_LOSS_RTOL / DIST_GNORM_RTOL, lr equal, each leaf's update
    within DIST_DELTA_RTOL and the unchanged leaves unchanged."""
    pytest.importorskip("torch")
    import sys
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_train_ranks import bf16_train, spawn
    args = (BF16_CFG, dict(seq_len=256, global_batch=cs.TRAIN_BATCH),
            dict(learning_rate=3e-4, warmup_steps=1,
                 total_steps=cs.TRAIN_STEPS), cs.DIST_STEPS)
    one = bf16_train(0, *args, str(tmp_path / "one"))
    mesh = spawn(bf16_train, 4, tmp_path, *args, str(tmp_path / "mesh"),
                 cs.DIST_MESH)[0]
    for i, (a, b) in enumerate(zip(one, mesh, strict=True)):
        dl = abs(b["loss"] - a["loss"]) / a["loss"]
        dg = abs(b["grad_norm"] - a["grad_norm"]) / a["grad_norm"]
        print(f"step {i}: loss rel {dl:.2e}, grad norm rel {dg:.2e}")
        assert dl <= cs.DIST_LOSS_RTOL and dg <= cs.DIST_GNORM_RTOL
        assert b["lr"] == a["lr"]

    def params(d, step):
        return [(p, t) for p, t in cs.checkpoint_leaves(str(tmp_path / d),
                                                        step)
                if p.startswith("/params/")]
    init, final_one, final_mesh = (params("one", 0),
                                   params("one", cs.DIST_STEPS),
                                   params("mesh", cs.DIST_STEPS))
    rel = cs.delta_gate("bf16 (2,2)", [p for p, _ in init], _whole_leaves(
        [t for _, t in init], [t for _, t in final_one],
        [t for _, t in final_mesh]), [()] * len(init))
    worst = max(rel, key=rel.get)
    print(f"worst update ratio {worst} {rel[worst]:.3e}")
    assert any(v == 0.0 for v in rel.values()) and rel[worst] > 0


def test_fwd_bound_counts_only_the_keys_a_row_sees(cs):
    """The bytes of fastattn_fwd's bound: Q and O once, K and V once for
    each key column some row sees -- at a context rank's q_offset 0 the
    first Sq of its 2Sq keys, at q_offset Sq all of them."""
    pytest.importorskip("torch")
    from repro_torch.core.tiling_mask import dense_mask
    b, h, sq, d = 2, 32, 1024, 128
    q_o = 2 * b * h * sq * d * 2
    for m, kv in ((0, sq), (1, 2 * sq)):
        mask = dense_mask(sq, 2 * sq, causal=True, q_offset=m * sq)
        assert cs.fwd_bytes(mask, b=b, hq=h, hkv=h, d=d, esize=2) == \
            q_o + 2 * b * h * kv * d * 2
    # the m=0 bound of phase 2's context case: 67.1 MB over 3.35 TB/s
    mask = dense_mask(sq, 2 * sq, causal=True)
    n = cs.fwd_bytes(mask, b=b, hq=h, hkv=h, d=d, esize=2)
    ops = 4.0 * b * h * int(mask.sum()) * d
    bnd, by = cs.bound_ms(n, ops, "bfloat16")
    assert by == "bytes" and abs(bnd - n / cs.H100_BYTES_PER_S * 1e3) < 1e-12
    assert 0.019 < bnd < 0.021
    # keys past kv_valid are never read; GQA reads hkv heads of K and V
    mask[:, 1000:] = False
    assert cs.fwd_bytes(mask, b=1, hq=8, hkv=2, d=64, esize=4) == \
        (2 * 8 * sq * 64 + 2 * 2 * 1000 * 64) * 4


def _resumed(keys, loss=13.8):
    return {"restored_keys": list(keys), "next_loss": loss}


@pytest.mark.parametrize("fault,match", [
    ("moment", "restored leaves \\[2\\]"),
    ("dropped", "restored 2 leaves"),
    ("loss", "next losses"),
    ("disagree", "next losses"),
])
def test_resume_gate_rejects_faked_failures(cs, fault, match):
    """Phase 4b's restore at (1, 2): every restored leaf of every rank --
    params, AdamW's moments, its step -- is its slice of the checkpoint,
    and the next loss is the (2, 2) run's."""
    keys = [[(r, 1), (r, 2), (r, 3)] for r in range(2)]
    ok = [_resumed(k) for k in keys]
    cs.resume_gate("ok", ok, keys, 13.8)
    bad = [_resumed(k) for k in keys]
    if fault == "moment":          # a moment sliced wrong on rank 1
        bad[1]["restored_keys"][2] = (0, 0)
    elif fault == "dropped":
        bad[0]["restored_keys"] = bad[0]["restored_keys"][:2]
    elif fault == "loss":
        bad = [_resumed(k, 13.9) for k in keys]
    else:
        bad[1]["next_loss"] = 13.80001
    with pytest.raises(AssertionError, match=match):
        cs.resume_gate("bad", bad, keys, 13.8)


def test_leaf_gnorm_report_names_the_leaves_that_move_the_norm(cs):
    one, mesh = [3.0, 4.0, 0.1], [3.0, 4.2, 0.2]
    rows = cs.leaf_gnorm_report(["a", "embed", "scale"], one, mesh, top=2)
    assert [r[0] for r in rows] == ["embed", "scale"]
    assert rows[0][1] == pytest.approx(0.05)
    assert rows[0][2] == pytest.approx((4.2 ** 2 - 16) / (9 + 16 + 0.01))


def test_phase4b_picks_its_backend_for_each_world(cs, monkeypatch):
    """Phase 4b asks the launcher's ``train_backend`` for each spawned
    world: NCCL only where there is a GPU a rank (four for (2, 2), two
    for the (1, 2) restore), else gloo with every rank on cuda:0."""
    torch = pytest.importorskip("torch")
    import inspect
    from repro_torch.launch.train import train_backend
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    backend, dev_of = train_backend(cuda, 4)
    assert backend == "gloo" and {dev_of(r) for r in range(4)} == {"cuda:0"}
    backend, dev_of = train_backend(cuda, 2)
    assert backend == "nccl" and [dev_of(r) for r in range(2)] == \
        ["cuda:0", "cuda:1"]
    src = inspect.getsource(cs.phase_dist_training)
    assert "train_backend(kind, n)" in src and "tp_backend" not in src


def test_step0_gradient_readings_on_one_device(cs):
    """Phase 4's step-0 readings beside phase 4b's: the leaves' gradient
    norms make up the step's grad norm, and in f32 the embed's norm with
    rows summed in f32 is the plain one (the lookup is restored after)."""
    torch = pytest.importorskip("torch")
    import repro_torch.models.lm as lm
    from repro_torch.config import (ParallelConfig, TrainConfig,
                                    get_model_config, reduce_for_smoke)
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.training import tree
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = reduce_for_smoke(get_model_config("llama2-7b"))
    model = build_model(cfg, "cpu", ParallelConfig())
    state = init_train_state(model, model.generator(0))
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)).next().items()}
    norms = cs.leaf_grad_norms(model, cfg, state.params, batch)
    lookup = lm.embed_tokens
    f32 = cs.embed_f32_grad_norm(model, cfg, state.params, batch)
    assert lm.embed_tokens is lookup
    paths = [p for p, _ in tree.leaves_with_paths(state.params)]
    assert f32 == pytest.approx(norms[paths.index("/embedding/embed")],
                                rel=1e-6)
    _, m = make_train_step(model, cfg, ParallelConfig(), TrainConfig())(
        state, batch)
    assert sum(x * x for x in norms) ** 0.5 == pytest.approx(
        float(m["grad_norm"]), rel=1e-5)


def test_phase2_holds_every_attention_kernel_at_gqa_8(cs):
    """Each of the four attention kernels at qwen3-moe's 32/4 heads of
    128 (a GQA group of 8: every row of the 8-row instances), bf16, at
    phase 8's main-path shapes: paged decode B=8 on 16 pages of 128, a
    prefill of 8 rows of 512 with ragged and padded rows, the causal
    forward at 1 x 2048, dense decode B=8 at generate's kv_len 159."""
    from repro_torch.config import get_model_config
    cfg = get_model_config(cs.MOE_ARCH)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 4, 128)
    lists = {"paged_decode": cs.DECODE_CASES,
             "paged_prefill": cs.PREFILL_CASES,
             "fastattn_fwd": cs.FWD_CASES,
             "flash_decode": cs.DENSE_DECODE_CASES}
    for kernel, cases in lists.items():
        kw = dict(cases)[cs.gqa8_case(kernel)]
        assert (kw["hq"], kw["hkv"], kw["d"], kw["dtype"]) == (
            32, 4, 128, "bfloat16"), kernel
    dec = dict(cs.DECODE_CASES)[cs.gqa8_case("paged_decode")]
    assert (dec["b"], dec["ps"], dec["n_kv"]) == (8, 128, 16)
    pre = dict(cs.PREFILL_CASES)[cs.gqa8_case("paged_prefill")]
    assert pre["chunk"] == 512 and len(pre["starts"]) == 8
    assert 0 in pre["nvalid"] and any(0 < n < 512 for n in pre["nvalid"])
    fwd = dict(cs.FWD_CASES)[cs.gqa8_case("fastattn_fwd")]
    assert (fwd["b"], fwd["sq"], fwd["skv"]) == (1, 2048, 2048)
    assert fwd.get("causal", True)
    dense = dict(cs.DENSE_DECODE_CASES)[cs.gqa8_case("flash_decode")]
    assert (dense["b"], dense["s"], dense["lens"]) == (8, 161, [159] * 8)


def test_gate_g_rejects_a_faked_logits_gap(cs):
    """Gate G is LOGIT_TOL or twice the plain path's own sensitivity,
    whichever is larger; a kernel-path gap above it fails."""
    import torch
    assert cs.gate_g(0.001) == cs.LOGIT_TOL
    assert cs.gate_g(0.2) == 0.4
    g = cs.gate_g(0.1)
    ref = torch.tensor([[4.0, 1.0, -2.0]])
    cs._compare_logits("ok", ref + 0.19 * 4.0 * torch.tensor([[0, 1, 0]]),
                       ref, g)
    with pytest.raises(AssertionError, match="differ by"):
        cs._compare_logits("faked", ref + 0.21 * 4.0 * torch.tensor(
            [[0, 1, 0]]), ref, g)


def test_drop_gate_rejects_a_faked_drop(cs):
    log = cs.DropLog(active=True)
    log.launches = [[0, 4096], [0, 1024]]
    log.other = [0, 8192]
    cs.drop_gate("clean", log)
    log.launches[1][0] = 1
    with pytest.raises(AssertionError, match="dropped by capacity"):
        cs.drop_gate("faked prefill drop", log)
    log.launches[1][0] = 0
    log.other[0] = 3
    with pytest.raises(AssertionError, match="dropped by capacity"):
        cs.drop_gate("faked decode drop", log)


def test_one_ulp_up_moves_one_ulp(cs):
    import torch
    for dt in (torch.bfloat16, torch.float32):
        x = torch.tensor([1.0, -3.0, 0.5, 7.0], dtype=dt)
        flip = torch.tensor([True, True, False, True])
        y = cs.one_ulp_up(x, flip)
        eps = torch.finfo(dt).eps               # the ulp at 1
        assert y.tolist() == [1.0 + eps, -3.0 - 2 * eps, 0.5, 7.0 + 4 * eps]


@pytest.fixture(scope="module")
def moe_model():
    """Reduced qwen3-moe-30b-a3b (2 layers, 4 experts top-2) in bf16 on
    the CPU, with the seeded draw of ``LM.init``."""
    import dataclasses
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    from repro_torch.models import build_model
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(reduce_for_smoke(get_model_config(
        "qwen3-moe-30b-a3b")), dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    yield model, model.init(model.generator(0))
    torch.set_num_threads(n)


def test_phase8_counts_drops_in_each_prefill_launch(cs, moe_model):
    """``counting_drops`` around a paged engine: one (dropped, total)
    pair of valid assignments a prefill launch, decode steps apart, none
    dropped there (cap 1, a token's experts distinct); a model without
    MoE blocks counts nothing."""
    import numpy as np
    from repro_torch.config import ServeConfig
    from repro_torch.serving.core import EngineCore
    from repro_torch.serving.scheduler import SamplingParams
    model, params = moe_model
    core = EngineCore(model, params, model.cfg, ServeConfig(
        max_batch=4, max_seq_len=128, page_size=16, prefill_chunk=64),
        device="cpu")
    rng = np.random.default_rng(0)
    lens = [64, 30, 100, 7]
    for n in lens:
        core.add_request(rng.integers(0, 256, size=n),
                         SamplingParams(max_new_tokens=3))
    with cs.counting_drops(model) as drops:
        while core.has_work:
            core.step()
    assert drops.active and core.prefill_launches == len(drops.launches)
    k = model.cfg.num_experts_per_tok
    assert sum(t for _, t in drops.launches) == \
        sum(lens) * k * model.cfg.num_layers
    assert any(d > 0 for d, _ in drops.launches)
    assert drops.other[0] == 0 and drops.other[1] > 0
    assert "prefill_chunk_paged" not in vars(model)
    assert len(drops.shares()) == len(drops.launches)
    assert len(drops.layer_shares()) == model.cfg.num_layers
    assert sum(d for d, _ in drops.layers) == sum(
        d for d, _ in drops.launches)


def test_phase8_gate_and_checks_on_a_reduced_moe_model(cs, moe_model,
                                                       monkeypatch):
    """Phase 8's helpers on the CPU: ``perturbed_router`` moves only the
    first MoE block's input of each forward; ``router_sensitivity`` gives
    a positive change for each of its three runs; (e)'s
    ``moe_block_check`` passes on the blocks' own inputs (both paths
    plain here: nothing routes differently); (d)'s two launches are the
    same bits."""
    import torch
    from repro_torch.layers import moe
    model, params = moe_model
    monkeypatch.setattr(cs, "APPLY_TOKENS", 96)
    seen = []
    apply = moe.apply_moe

    def spy(p, x, cfg, **kw):
        seen.append(x.clone())
        return apply(p, x, cfg, **kw)
    monkeypatch.setattr(moe, "apply_moe", spy)
    toks = cs.apply_tokens(model)
    model.apply(params, toks)
    clean = list(seen)
    seen.clear()
    with cs.perturbed_router(model):
        model.apply(params, toks)
        model.apply(params, toks)
    assert moe.apply_moe is spy
    assert len(seen) == 2 * model.cfg.num_layers
    moved = (seen[0] != clean[0]).float().mean().item()
    assert 0.002 < moved < 0.03
    assert not torch.equal(seen[2], clean[0])         # the second forward
    monkeypatch.setattr(moe, "apply_moe", apply)
    sens = cs.router_sensitivity(model, params,
                                 torch.arange(40).numpy() % 256)
    assert set(sens) == {"prefill", "decode", "apply"}
    assert all(v >= 0 for v in sens.values()) and sens["apply"] > 0
    inputs = []
    with cs.capturing_block_inputs(model, inputs):
        model.apply(params, toks)
        model.apply(params, toks, impl="reference")
    assert len(inputs) == model.cfg.num_layers
    res = cs.moe_block_check(model, params, inputs)
    assert res["top_set_differs"] == [0.0] * model.cfg.num_layers
    # a faked kernel path 5% off on every attention output fails (e)
    from repro_torch.models import blocks
    attn = blocks.attn_mod.apply_attention

    def off(*a, impl=None, **kw):
        out = attn(*a, impl=impl, **kw)
        return out if impl == "reference" else out * 1.05
    monkeypatch.setattr(blocks.attn_mod, "apply_attention", off)
    with pytest.raises(AssertionError, match="routed alike differ"):
        cs.moe_block_check(model, params, inputs)
    monkeypatch.setattr(blocks.attn_mod, "apply_attention", attn)
    prompts = [torch.arange(n).numpy() % 256 for n in
               (600, 37, 512, 100, 700, 5, 64, 513)]
    assert cs.deterministic_prefill(model, params, prompts) == \
        512 + 37 + 512 + 100 + 512 + 5 + 64 + 512


def test_kernels_line_gains_gqa8_entries(cs):
    """Each attention kernel's entry gets g8_* numbers (phase 2's
    qwen3-moe case; flash_decode's from phase 8 (b), with its phase-2
    case as g8_case_*) and its phase 8 launches; the mLSTM's none."""
    def res(tag):
        return {"err": 1e-3, "ms": tag, "device_ms": tag / 2,
                "plain_ms": 9.0, "bound_ms": 0.01, "bound_by": "bytes",
                "library_ms": 1.0, "library_device_ms": 0.5}
    attn = ("paged_prefill", "paged_decode", "fastattn_fwd", "flash_decode")
    kernels = [{"name": n} for n in attn + ("mlstm_chunkwise",)]
    cases = {n: res(1.0) for n in attn}
    run = {"launches": {"paged_decode": 3408, "paged_prefill": 864,
                        "flash_decode": 7632, "fastattn_fwd": 48},
           "flash_decode": res(2.0)}
    cs.add_moe_entries(kernels, cases, run)
    by = {k["name"]: k for k in kernels}
    assert by["mlstm_chunkwise"] == {"name": "mlstm_chunkwise"}
    assert by["fastattn_fwd"]["moe_launches"] == 48
    assert by["flash_decode"]["g8_ms"] == 2.0
    assert by["flash_decode"]["g8_case_device_ms"] == 0.5
    for n in attn:
        assert {f"g8_{x}" for x in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")} <= set(by[n])


def test_phase8_serves_qwen3_moe_last(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index("phase_head_dims()") < main.index("phase_moe()") \
        < main.index("print(json.dumps(line))")
    assert "add_moe_entries" in main


def test_phase2_holds_both_kernels_at_hymba_shapes(cs):
    """Phase 2's cases at hymba-1.5b's 25/5 heads of 64 (5 of the 8 rows
    of the GQA instances) and its window of 1024: fastattn_fwd at (a)'s
    8 x 2048 with and without the window and a ragged float32 case with
    the window; flash_decode at (b)'s B=8, kv_len 159 in both layouts,
    and at B=1 on 4096 keys with the window narrower than the cache."""
    from repro_torch.config import get_model_config
    cfg = get_model_config(cs.HYMBA_ARCH)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.window_size) == (25, 5, 64, 1024)
    fwd, dense = dict(cs.FWD_CASES), dict(cs.DENSE_DECODE_CASES)
    # phase 12's rank shape at hymba's heads is held in its own test
    mesh = {name for name, _ in cs.MESH_FWD_CASES.values()}
    hy = [kw for name, kw in list(fwd.items()) + list(dense.items())
          if (kw["hq"], kw["hkv"], kw["d"]) == (25, 5, 64)
          and name not in mesh]
    assert len(hy) == 6
    main = fwd[cs.hymba_case("fastattn_fwd")]
    assert (main["b"], main["sq"], main["skv"], main["window"],
            main["dtype"]) == (8, 2048, 2048, 1024, "bfloat16")
    glob = fwd[cs.hymba_case("fastattn_fwd", "global")]
    assert glob.get("window") is None and glob["sq"] == 2048
    ragged = [kw for kw in hy if kw["dtype"] == "float32"]
    assert len(ragged) == 1 and ragged[0]["window"] == 1024
    assert ragged[0]["q_offset"] > 0 and ragged[0]["kv_valid"] < \
        ragged[0]["skv"]
    dec = dense[cs.hymba_case("flash_decode")]
    assert (dec["b"], dec["s"], dec["lens"], dec["layout"]) == (
        8, 161, [159] * 8, "bshd")
    assert sorted(kw["layout"] for kw in hy if kw.get("lens") == [159] * 8) \
        == ["bhsd", "bshd"]
    win = dense[cs.hymba_case("flash_decode", "window")]
    assert (win["b"], win["s"], win["window"]) == (1, 4096, 1024)
    assert win["window"] < win["s"]


def test_hymba_gate_follows_the_plain_paths_own_change(cs, monkeypatch,
                                                       hymba_model):
    """LOGIT_TOL while one ulp moves the plain logits by at most half of
    it, else gate G's max(LOGIT_TOL, twice the change); the change comes
    from ``hymba_sensitivity``, here under faked perturbations of block
    0's input below and above half of LOGIT_TOL."""
    import torch
    assert cs.hymba_gate(0.0) == (cs.LOGIT_TOL, "LOGIT_TOL")
    assert cs.hymba_gate(cs.LOGIT_TOL / 2) == (cs.LOGIT_TOL, "LOGIT_TOL")
    assert cs.hymba_gate(0.03) == (0.06, "G")
    assert cs.hymba_gate(0.2) == (0.4, "G")
    model, params = hymba_model
    toks = torch.arange(2 * 40).reshape(2, 40) % model.cfg.vocab_size
    for fake, rule in ((lambda x: x, "LOGIT_TOL"),
                       (lambda x: x * 1.001, "LOGIT_TOL"),
                       (lambda x: -x, "G")):
        monkeypatch.setattr(cs, "_ulp_noise", lambda seed, frac: fake)
        ref, change = cs.hymba_sensitivity(model, params, toks)
        assert cs.hymba_gate(change)[1] == rule, change
    assert torch.equal(ref, model.apply(params, toks, impl="reference"))


def test_exact_launches_rejects_faked_counts(cs):
    want = {"fastattn_fwd": 32, "flash_decode": 32 * 159}
    cs.exact_launches("ok", dict(want), want)
    for bad in ({"fastattn_fwd": 31, "flash_decode": 32 * 159},
                {"fastattn_fwd": 32, "flash_decode": 32 * 159 + 1},
                {"fastattn_fwd": 32}):
        with pytest.raises(AssertionError, match="launched"):
            cs.exact_launches("faked", bad, want)


@pytest.fixture(scope="module")
def hymba_model():
    """Reduced hymba-1.5b (2 layers: hymba, hymba_local; window 32) in
    bf16 on the CPU, with the seeded draw of ``LM.init``."""
    import dataclasses
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    from repro_torch.models import build_model
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(reduce_for_smoke(get_model_config(
        "hymba-1.5b")), dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    yield model, model.init(model.generator(0))
    torch.set_num_threads(n)


def test_phase9_helpers_on_a_reduced_hymba_model(cs, hymba_model,
                                                 monkeypatch):
    """Phase 9's (a), (b) and (c) on the CPU, where both paths are plain
    and launch nothing: ``perturbed_first_block`` moves about 1% of the
    first block's input of each forward and nothing else; (a) holds the
    logits and falls back to the block check only under rule G, which a
    faked kernel path fails; (b)'s decode logits hold to LM.apply's and
    to the plain path's LM.apply and decode_step teacher-forced on its
    tokens; (c) holds decode past the window."""
    import numpy as np
    import torch
    from repro_torch.models import blocks
    model, params = hymba_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, size=(2, cs.DENSE_PROMPT)).astype(np.int32))
    seen = []
    apply = blocks.apply_block

    def spy(p, x, *a, **kw):
        seen.append(x.clone())
        return apply(p, x, *a, **kw)
    monkeypatch.setattr(blocks, "apply_block", spy)
    with torch.no_grad():
        model.apply(params, toks)
        clean = list(seen)
        seen.clear()
        with cs.perturbed_first_block(model):
            model.apply(params, toks)
            model.apply(params, toks)
    assert blocks.apply_block is spy
    moved = (seen[0] != clean[0]).float().mean().item()
    assert 0.002 < moved < 0.03
    assert len(seen) == 2 * model.cfg.num_layers
    assert not torch.equal(seen[2], clean[0])          # the second forward
    monkeypatch.setattr(blocks, "apply_block", apply)

    ref, change = cs.hymba_sensitivity(model, params, toks)
    gate, rule = cs.hymba_gate(change)
    res = cs.hymba_apply(model, params, toks, ref, gate, rule)
    assert res["launches"] == 0 and res["rule"] == rule
    # the fallback: a miss under G holds each block instead
    compare = cs._compare_logits

    def missing(*a, **kw):
        raise AssertionError("faked miss")
    monkeypatch.setattr(cs, "_compare_logits", missing)
    with pytest.raises(AssertionError, match="faked miss"):
        cs.hymba_apply(model, params, toks, ref, gate, "LOGIT_TOL")
    res = cs.hymba_apply(model, params, toks, ref, gate, "G")
    assert res["rule"] == "blocks"
    assert len(res["blocks"]) == model.cfg.num_layers
    attn = blocks.attn_mod.apply_attention

    def off(*a, impl=None, **kw):
        out = attn(*a, impl=impl, **kw)
        return out if impl == "reference" else -out
    monkeypatch.setattr(blocks.attn_mod, "apply_attention", off)
    with pytest.raises(AssertionError, match="max_abs_err"):
        cs.hymba_apply(model, params, toks, ref, gate, "G")
    monkeypatch.setattr(blocks.attn_mod, "apply_attention", attn)
    monkeypatch.setattr(cs, "_compare_logits", compare)

    with torch.no_grad():
        apply_logits = model.apply(params, toks).float()
    gen = cs.hymba_generate(model, model, params, toks.numpy(),
                            apply_logits, gate)
    assert gen["launches"] == 0
    assert gen["plain_launches"] == {"fastattn_fwd": 0, "flash_decode": 0}
    assert gen["cache"][0]["mamba"].h.dtype == torch.float32
    monkeypatch.setattr(cs, "HYMBA_LONG_FROM", 40)
    long_run = cs.hymba_long(model, params, toks[0, :50].numpy(), gate)
    assert long_run["steps"] == 50 + cs.HYMBA_LONG_NEW - 1
    assert long_run["launches"] == 0


class _Launching:
    """A plain model whose ``method`` also bumps ``kernel``'s launch
    count: a plain run that reached a kernel."""

    def __init__(self, model, method, kernel):
        self.model, self.method, self.kernel = model, method, kernel

    def __getattr__(self, name):
        fn = getattr(self.model, name)
        if name != self.method:
            return fn

        def launching(*a, **kw):
            self.kernel.launches += 1
            return fn(*a, **kw)
        return launching


@pytest.mark.parametrize("method, kernel", [("apply", "fastattn_fwd"),
                                            ("decode_step", "flash_decode")])
def test_hymba_generate_fails_a_plain_run_that_launches(cs, hymba_model,
                                                        monkeypatch, method,
                                                        kernel):
    """(b)'s plain runs -- LM.apply on the generated tokens and the
    decode_step teacher-forced on them -- must launch neither kernel: a
    plain model whose apply launches fastattn_fwd, or whose decode_step
    launches flash_decode, fails the phase."""
    import numpy as np
    import torch
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.kernels.flash_decode.ops import flash_decode
    model, params = hymba_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "DENSE_NEW", 4)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, size=(2, cs.DENSE_PROMPT)).astype(np.int32))
    with torch.no_grad():
        apply_logits = model.apply(params, toks).float()
    plain = _Launching(model, method, {"fastattn_fwd": fastattn_fwd,
                                       "flash_decode": flash_decode}[kernel])
    with pytest.raises(AssertionError, match=f"{kernel} launched [1-9]"):
        cs.hymba_generate(model, plain, params, toks.numpy(), apply_logits,
                          cs.LOGIT_TOL)


def test_counting_scans_sees_each_scan_call(cs, hymba_model):
    """(e)'s scan count: ``counting_scans`` sees one ``mamba_scan_chunk``
    call a chunk a layer (the first call's inputs kept), and restores
    the function after."""
    import torch
    from repro_torch.layers import ssm
    model, params = hymba_model
    scan = ssm.mamba_scan_chunk
    calls = []
    with cs.counting_scans(calls):
        assert ssm.mamba_scan_chunk is not scan
        with torch.no_grad():
            model.apply(params, torch.zeros((1, 40), dtype=torch.int32))
    assert ssm.mamba_scan_chunk is scan
    assert len(calls) == model.cfg.num_layers     # one chunk of 40 a layer
    assert calls[1:] == [None] * (len(calls) - 1)
    (h0, xc, dt, bc, cc, a), kw = calls[0]
    assert xc.shape == (1, 40, model.cfg.q_dim) and not kw
    assert h0.dtype == xc.dtype == torch.float32


def test_kernels_line_gains_hymba_entries(cs):
    """fastattn_fwd's and flash_decode's entries get hymba_* numbers
    (phase 2's case at hymba's main-path shape), fastattn_fwd's also
    hymba_global_*, flash_decode's hymba_window_*, and their phase 9
    launches; the other kernels' entries nothing."""
    def res(tag):
        return {"err": 1e-3, "ms": tag, "device_ms": tag / 2,
                "plain_ms": 9.0, "bound_ms": 0.01, "bound_by": "bytes",
                "library_ms": 1.0, "library_device_ms": 0.5}
    names = ("paged_prefill", "paged_decode", "fastattn_fwd",
             "flash_decode", "mlstm_chunkwise")
    kernels = [{"name": n} for n in names]
    cases = {("fastattn_fwd", "main"): res(1.0),
             ("fastattn_fwd", "global"): res(2.0),
             ("flash_decode", "main"): res(3.0),
             ("flash_decode", "window"): res(4.0)}
    run = {"launches": {"fastattn_fwd": {"apply": 32, "train": 192},
                        "flash_decode": {"generate": 5088,
                                         "long": 35424}}}
    cs.add_hymba_entries(kernels, cases, run)
    by = {k["name"]: k for k in kernels}
    for n in ("paged_prefill", "paged_decode", "mlstm_chunkwise"):
        assert by[n] == {"name": n}
    assert by["fastattn_fwd"]["hymba_ms"] == 1.0
    assert by["fastattn_fwd"]["hymba_global_ms"] == 2.0
    assert by["flash_decode"]["hymba_ms"] == 3.0
    assert by["flash_decode"]["hymba_window_device_ms"] == 2.0
    assert by["fastattn_fwd"]["hymba_launches"] == {"apply": 32,
                                                    "train": 192}
    for n, extra in (("fastattn_fwd", "global"), ("flash_decode", "window")):
        for pre in ("hymba", f"hymba_{extra}"):
            assert {f"{pre}_{x}" for x in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")} <= \
                set(by[n])


def test_phase9_runs_hymba_last(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index("phase_moe()") < main.index("phase_hymba()") \
        < main.index("print(json.dumps(line))")
    assert "add_hymba_entries" in main


def test_phase9_long_run_keeps_four_layers_of_the_pattern(cs):
    """(c) decodes past the window on the first HYMBA_LONG_LAYERS layers:
    hymba's layer 0 (global) and layers 1-3 (window 1024)."""
    from repro_torch.config import get_model_config
    cfg = get_model_config(cs.HYMBA_ARCH)
    assert cs.HYMBA_LONG_LAYERS == 4
    assert cfg.blocks()[:4] == ("hymba",) + ("hymba_local",) * 3


def test_hymba_long_runs_its_first_layers(cs, hymba_model, monkeypatch):
    """(c) on a one-layer cut of the reduced model: decode past the
    window, its logits held to that cut's LM.apply."""
    import numpy as np
    import torch
    model, params = hymba_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "HYMBA_LONG_LAYERS", 1)
    monkeypatch.setattr(cs, "HYMBA_LONG_FROM", 40)
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, size=50).astype(np.int32)
    run = cs.hymba_long(model, params, toks, cs.LOGIT_TOL)
    assert run["layers"] == 1
    assert run["steps"] == 50 + cs.HYMBA_LONG_NEW - 1
    assert run["launches"] == 0


def test_phase2_holds_both_kernels_at_whisper_shapes(cs):
    """Phase 2's bf16 cases at whisper-small's 12/12 heads of 64:
    fastattn_fwd non-causal on 1500 keys with 1500, 448 and 1 query rows;
    flash_decode at B=8 on a 512-slot cache at kv_len 64 and ragged, SDPA
    on its flash path (no mask)."""
    from repro_torch.config import get_model_config
    cfg = get_model_config(cs.WHISPER_ARCH)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.encoder_seq) == (12, 12, 64, 1500)
    fwd, dense = dict(cs.FWD_CASES), dict(cs.DENSE_DECODE_CASES)
    for variant, sq in (("enc", 1500), ("cross", cs.WHISPER_TEXT),
                        ("step", 1)):
        kw = fwd[cs.whisper_case("fastattn_fwd", variant)]
        assert (kw["b"], kw["hq"], kw["hkv"], kw["d"], kw["sq"], kw["skv"],
                kw["causal"], kw["dtype"]) == (8, 12, 12, 64, sq, 1500,
                                               False, "bfloat16")
    main = dense[cs.whisper_case("flash_decode", "main")]
    assert (main["b"], main["s"], main["lens"], main["lib"]) == (
        8, 512, [64] * 8, "flash")
    ragged = dense[cs.whisper_case("flash_decode", "ragged")]
    assert ragged.get("lens") is None and ragged["lib"] == "flash"
    assert {(k, v) for k, v in cs.WHISPER_CASES} == {
        ("fastattn_fwd", "enc"), ("fastattn_fwd", "cross"),
        ("fastattn_fwd", "step"), ("flash_decode", "main"),
        ("flash_decode", "ragged")}


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_jagged_rows_hold_each_rows_keys(cs, layout):
    """The jagged SDPA's keys: row i's first kv_len[i] keys, (B, H, j,
    D), from either cache layout; SDPA on them equals attention over each
    row's keys alone."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    g = torch.Generator()
    g.manual_seed(0)
    b, h, s, d = 3, 2, 9, 8
    lens = np.array([9, 4, 1], np.int32)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    k, v = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    q = torch.randn((b, h, d), generator=g)
    kj, vj = cs._jagged_rows(k, lens, layout), cs._jagged_rows(v, lens,
                                                               layout)
    qj = cs._jagged(q, [1] * b)
    out = F.scaled_dot_product_attention(qj, kj, vj).transpose(1, 2)
    for i, n in enumerate(lens.tolist()):
        ki = k[i, :n].transpose(0, 1) if layout == "bshd" else k[i, :, :n]
        vi = v[i, :n].transpose(0, 1) if layout == "bshd" else v[i, :, :n]
        want = torch.softmax(q[i][:, None] @ ki.transpose(1, 2) * d ** -0.5,
                             -1) @ vi
        torch.testing.assert_close(out[i][0], want[:, 0], rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def whisper_model():
    """Reduced whisper-small (2 + 2 layers, 16 frames) in bf16 on the
    CPU, with the seeded draw of ``EncDec.init``."""
    import dataclasses
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    from repro_torch.models import build_model
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(reduce_for_smoke(get_model_config(
        "whisper-small")), dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    yield model, model.init(model.generator(0))
    torch.set_num_threads(n)


def test_phase10_helpers_on_a_reduced_whisper(cs, whisper_model,
                                              monkeypatch):
    """Phase 10's gate, (a), (b) and (c) on the CPU, where both paths are
    plain and launch nothing: ``perturbed_frames`` moves about 1% of the
    frontend's input at every encode and nothing else; (a) holds the
    logits; (b)'s decode logits hold to EncDec.apply on its tokens and
    its greedy tokens to the plain run's; (c) generates over the zero
    cross cache; the launches are returned for the phase to hold."""
    import torch
    from repro_torch.models import encdec
    model, params = whisper_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "WHISPER_NEW", 6)
    frames, toks = cs.whisper_inputs(model, 2, 10)
    assert frames.dtype == torch.float32 and tuple(frames.shape) == (
        2, model.cfg.encoder_seq, model.cfg.d_model)
    seen = []
    front = encdec.apply_frontend

    def spy(p, x, cfg):
        seen.append(x.clone())
        return front(p, x, cfg)
    monkeypatch.setattr(encdec, "apply_frontend", spy)
    with torch.no_grad():
        model.encode(params, frames)
        with cs.perturbed_frames():
            model.encode(params, frames)
            model.encode(params, frames)
    assert encdec.apply_frontend is spy
    moved = (seen[1] != seen[0]).float().mean().item()
    assert 0.002 < moved < 0.03
    assert not torch.equal(seen[2], seen[1])     # a fresh draw each encode
    monkeypatch.setattr(encdec, "apply_frontend", front)

    ref, change = cs.whisper_sensitivity(model, params, frames, toks)
    assert change > 0
    gate, rule = cs.hymba_gate(change)
    res = cs.whisper_apply(model, params, frames, toks, ref, gate)
    assert res["launches"] == 0 and res["encode_ms"] > 0
    prompt = toks[:, :cs.WHISPER_PROMPT].contiguous()
    trans = cs.whisper_transcribe(model, model, params, frames, prompt, gate)
    assert trans["steps"] == cs.WHISPER_PROMPT + 6
    assert trans["launches"] == trans["plain_launches"] == {
        "fastattn_fwd": 0, "flash_decode": 0}
    assert trans["tokens_equal"] == trans["tokens"] == 2 * 6
    assert len(trans["cache"]["self"]) == model.cfg.num_layers
    gen = cs.whisper_generate(model, model, params, prompt, gate)
    assert gen["launches"] == gen["plain_launches"] == {
        "fastattn_fwd": 0, "flash_decode": 0}
    assert gen["tokens_equal"] == gen["tokens"] == 2 * cs.WHISPER_GEN_NEW


@pytest.mark.parametrize("method, kernel", [
    ("encode", "fastattn_fwd"), ("decode_step", "fastattn_fwd"),
    ("decode_step", "flash_decode")])
def test_whisper_transcribe_fails_a_plain_run_that_launches(
        cs, whisper_model, monkeypatch, method, kernel):
    """(b)'s plain run must launch neither kernel: a plain model whose
    encode launches fastattn_fwd, or whose decode_step launches either
    kernel, fails the phase."""
    import torch
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.kernels.flash_decode.ops import flash_decode
    model, params = whisper_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "WHISPER_NEW", 3)
    frames, toks = cs.whisper_inputs(model, 2, 4)
    plain = _Launching(model, method, {"fastattn_fwd": fastattn_fwd,
                                       "flash_decode": flash_decode}[kernel])
    with pytest.raises(AssertionError, match=f"{kernel} launched [1-9]"):
        cs.whisper_transcribe(model, plain, params, frames, toks,
                              cs.LOGIT_TOL)


def test_whisper_generate_fails_a_plain_run_that_launches(
        cs, whisper_model, monkeypatch):
    import torch
    from repro_torch.kernels.flash_decode.ops import flash_decode
    model, params = whisper_model
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "WHISPER_GEN_NEW", 3)
    _, toks = cs.whisper_inputs(model, 2, 4)
    plain = _Launching(model, "decode_step", flash_decode)
    with pytest.raises(AssertionError, match="flash_decode launched [1-9]"):
        cs.whisper_generate(model, plain, params, toks, cs.LOGIT_TOL)


def test_whisper_train_on_a_reduced_whisper(cs, monkeypatch):
    """(d) through the trainer's functions at a tiny batch on the CPU
    (float32): finite losses, step 0 on the plain path's loss and grad
    norm, the frames in every batch."""
    import dataclasses
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "WHISPER_BATCH", 2)
    monkeypatch.setattr(cs, "WHISPER_TEXT", 8)
    cfg = reduce_for_smoke(get_model_config("whisper-small"))
    try:
        res = cs.whisper_train(dataclasses.replace(cfg), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert len(res["losses"]) == cs.WHISPER_TRAIN_STEPS
    assert res["launches"] == 0
    assert res["loss_rel"] < 1e-6 and res["gnorm_rel"] < 1e-5


def test_kernels_line_gains_whisper_entries(cs):
    """fastattn_fwd's entry gets whisper_enc_*, whisper_cross_* and
    whisper_step_*, flash_decode's whisper_* and whisper_ragged_*, both
    their phase 10 launches by run; the other kernels' entries nothing."""
    def res(tag):
        return {"err": 1e-3, "ms": tag, "device_ms": tag / 2,
                "plain_ms": 9.0, "bound_ms": 0.01, "bound_by": "bytes",
                "library_ms": 1.0, "library_device_ms": 0.5}
    names = ("paged_prefill", "paged_decode", "fastattn_fwd",
             "flash_decode", "mlstm_chunkwise")
    kernels = [{"name": n} for n in names]
    cases = {c: res(float(i + 1)) for i, c in enumerate(cs.WHISPER_CASES)}
    run = {"launches": {
        "fastattn_fwd": {"apply": 36, "transcribe": 780, "generate": 228,
                         "train": 216},
        "flash_decode": {"transcribe": 768, "generate": 228}}}
    cs.add_whisper_entries(kernels, cases, run)
    by = {k["name"]: k for k in kernels}
    for n in ("paged_prefill", "paged_decode", "mlstm_chunkwise"):
        assert by[n] == {"name": n}
    fa, fd = by["fastattn_fwd"], by["flash_decode"]
    assert (fa["whisper_enc_ms"], fa["whisper_cross_ms"],
            fa["whisper_step_ms"]) == (1.0, 2.0, 3.0)
    assert (fd["whisper_ms"], fd["whisper_ragged_device_ms"]) == (4.0, 2.5)
    assert fa["whisper_launches"]["transcribe"] == 780
    assert fd["whisper_launches"] == {"transcribe": 768, "generate": 228}
    for k, pres in ((fa, ("whisper_enc", "whisper_cross", "whisper_step")),
                    (fd, ("whisper", "whisper_ragged"))):
        for pre in pres:
            assert {f"{pre}_{x}" for x in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")} <= set(k)


def test_phase10_runs_whisper_after_hymba(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index("phase_hymba()") < main.index("phase_whisper()") \
        < main.index("print(json.dumps(line))")
    assert "add_whisper_entries" in main


def test_phase2_holds_every_attention_kernel_at_qwen2_vl_heads(cs):
    """Phase 2's bf16 cases at qwen2-vl-72b's 64/8 heads of 128, phase
    11's model: paged decode at B=8 on 16 pages of 128, paged prefill of
    8 rows of a 512 chunk (ragged and padded rows), the causal forward
    at 1 x 2048, dense decode at B=8, kv_len 159."""
    from repro_torch.config import get_model_config
    cfg = get_model_config(cs.VL_ARCH)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (64, 8, 128)
    cases = {k: dict(v) for k, v in (
        ("paged_decode", cs.DECODE_CASES), ("paged_prefill",
                                            cs.PREFILL_CASES),
        ("fastattn_fwd", cs.FWD_CASES),
        ("flash_decode", cs.DENSE_DECODE_CASES))}
    for kernel, by_name in cases.items():
        kw = by_name[cs.vl_case(kernel)]
        assert (kw["hq"], kw["hkv"], kw["d"], kw["dtype"]) == (
            64, 8, 128, "bfloat16"), kernel
        vl = [k for k in by_name.values()
              if (k["hq"], k["hkv"], k.get("d")) == (64, 8, 128)]
        assert len(vl) == 1, kernel
    assert (cases["paged_decode"][cs.vl_case("paged_decode")]["b"],
            cases["paged_decode"][cs.vl_case("paged_decode")]["n_kv"]) == (
        8, 16)
    pre = cases["paged_prefill"][cs.vl_case("paged_prefill")]
    assert len(pre["starts"]) == 8 and pre["chunk"] == 512
    assert 0 in pre["nvalid"] and any(0 < n < 512 for n in pre["nvalid"])
    fwd = cases["fastattn_fwd"][cs.vl_case("fastattn_fwd")]
    assert (fwd["b"], fwd["sq"], fwd["skv"], fwd.get("causal", True)) == (
        1, 2048, 2048, True)
    dec = cases["flash_decode"][cs.vl_case("flash_decode")]
    assert (dec["b"], dec["s"], dec["lens"], dec["layout"]) == (
        8, 161, [159] * 8, "bshd")


def test_vl_positions_follow_qwen2_vl_layout(cs):
    """Text at t = h = w = i, patch (r, c) at (n, n + r, n + c), text
    after the image from n + max(grid): phase 11's 64 + 32 x 48 + 448 at
    2048 positions, and a small case checked element by element."""
    import torch
    pos, img = cs.vl_positions(2, cs.VL_SEQ, device="cpu")
    assert tuple(pos.shape) == (3, 2, 2048) and int(img[0].sum()) == 1536
    t, h, w = pos[:, 0]
    assert torch.equal(t[:64], torch.arange(64)) and torch.equal(t[:64],
                                                                 h[:64])
    assert (t[64:1600] == 64).all()
    assert int(h[64:1600].max()) == 64 + 31 and int(w[64:1600].max()) == \
        64 + 47
    assert torch.equal(t[1600:], torch.arange(112, 112 + 448))
    assert torch.equal(t[1600:], h[1600:]) and torch.equal(t[1600:],
                                                           w[1600:])
    pos, img = cs.vl_positions(1, 12, n_text=2, grid=(2, 3), device="cpu")
    assert pos[:, 0].tolist() == [
        [0, 1, 2, 2, 2, 2, 2, 2, 5, 6, 7, 8],
        [0, 1, 2, 2, 2, 3, 3, 3, 5, 6, 7, 8],
        [0, 1, 2, 3, 4, 2, 3, 4, 5, 6, 7, 8]]
    assert img[0].tolist() == [False] * 2 + [True] * 6 + [False] * 4
    with pytest.raises(ValueError, match="do not fit"):
        cs.vl_positions(1, 7, n_text=2, grid=(2, 3), device="cpu")


@pytest.fixture(scope="module")
def vl_model():
    """Reduced qwen2-vl-72b (2 layers, 16/2 heads of 16, sections
    (2, 3, 3)) in bf16 on the CPU, with the seeded draw of ``LM.init``."""
    import dataclasses
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    from repro_torch.models import build_model
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(reduce_for_smoke(get_model_config(
        "qwen2-vl-72b")), dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    yield model, model.init(model.generator(0))
    torch.set_num_threads(n)


def _small_vl(cs, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "VL_SEQ", 24)
    monkeypatch.setattr(cs, "VL_TEXT", 3)
    monkeypatch.setattr(cs, "VL_GRID", (3, 4))


def test_phase11_helpers_on_a_reduced_qwen2_vl(cs, vl_model, monkeypatch):
    """Phase 11's inputs, gate and (a) on the CPU, where both paths are
    plain and launch nothing: the vision batch masks exactly the image's
    labels; the plain path's sensitivity moves the logits; (a) holds the
    logits, and the text rows before the image do not move under index
    positions (they are the same positions)."""
    import torch
    _small_vl(cs, monkeypatch)
    model, params = vl_model
    emb, pos, img = cs.vl_inputs(model, 2, cs.VL_SEQ)
    assert emb.dtype == torch.float32 and tuple(emb.shape) == (
        2, 24, model.cfg.d_model)
    assert tuple(pos.shape) == (3, 2, 24) and int(img.sum()) == 2 * 12
    batch = cs.vl_batch(model, 2, cs.VL_SEQ, seed=3)
    assert torch.equal(batch["labels"] < 0, img)
    assert torch.equal(batch["positions"], pos)
    assert not torch.equal(batch["inputs_embeds"], emb)
    ref, change = cs.vl_sensitivity(model, params, emb, pos)
    assert change > 0 and tuple(ref.shape) == (2, 24, model.cfg.vocab_size)
    gate, _ = cs.hymba_gate(change)
    res = cs.vl_apply(model, params, emb, pos, ref, gate)
    assert res["launches"] == 0 and res["logit_err"][0] == 0
    assert res["index_positions_text_rows_change"] == 0
    assert res["index_positions_change"] > 0
    with pytest.raises(AssertionError, match="logits differ"):
        cs.vl_apply(model, params, emb, pos, -ref, gate)


def test_vl_train_on_a_reduced_qwen2_vl(cs, monkeypatch):
    """(d) through the trainer's functions at a tiny batch on the CPU
    (float32): finite losses, step 0 on the plain path's loss and grad
    norm, the layer cut, no launch."""
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    _small_vl(cs, monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in ("reset_peak_memory_stats",):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "VL_TRAIN_LAYERS", 1)
    try:
        res = cs.vl_train(reduce_for_smoke(get_model_config(
            "qwen2-vl-72b")), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert res["layers"] == 1 and len(res["losses"]) == cs.VL_TRAIN_STEPS
    assert res["launches"] == 0
    assert res["loss_rel"] < 1e-6 and res["gnorm_rel"] < 1e-5


def test_serve_gate_rejects_faked_launches_and_leaks(cs):
    ok = {"launches": {"paged_prefill": 16 * 9, "paged_decode": 16 * 40},
          "prefill_launches": 9, "decode_launches": 40, "pages_used": 0}
    cs.serve_gate("ok", ok, 16)
    for bad, match in (
            (dict(ok, launches={"paged_prefill": 16 * 9 - 1,
                                "paged_decode": 16 * 40}), "launched"),
            (dict(ok, launches={"paged_prefill": 16 * 9,
                                "paged_decode": 16 * 40 + 1}), "launched"),
            (dict(ok, pages_used=3), "3 pages leaked")):
        with pytest.raises(AssertionError, match=match):
            cs.serve_gate("faked", bad, 16)


def test_kernels_line_gains_vl_entries(cs):
    """Each attention kernel's entry gets vl_* (flash_decode's from phase
    11 (c)'s caches, its phase-2 case as vl_case_*) and vl_launches;
    mlstm_chunkwise's entry nothing."""
    def res(tag):
        return {"err": 1e-3, "ms": tag, "device_ms": tag / 2,
                "plain_ms": 9.0, "bound_ms": 0.01, "bound_by": "bytes",
                "library_ms": 1.0, "library_device_ms": 0.5}
    names = ("paged_prefill", "paged_decode", "fastattn_fwd",
             "flash_decode", "mlstm_chunkwise")
    kernels = [{"name": n} for n in names]
    cases = {n: res(float(i + 1)) for i, n in enumerate(names[:4])}
    run = {"flash_decode": res(7.0), "launches": {
        "paged_prefill": 144, "paged_decode": 640, "flash_decode": 2544,
        "fastattn_fwd": {"apply": 16, "train": 12}}}
    cs.add_vl_entries(kernels, cases, run)
    by = {k["name"]: k for k in kernels}
    assert by["mlstm_chunkwise"] == {"name": "mlstm_chunkwise"}
    assert by["paged_prefill"]["vl_ms"] == 1.0
    assert by["fastattn_fwd"]["vl_launches"] == {"apply": 16, "train": 12}
    assert by["flash_decode"]["vl_ms"] == 7.0
    assert by["flash_decode"]["vl_case_device_ms"] == 2.0
    for n in names[:4]:
        assert {f"vl_{x}" for x in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")} <= set(by[n])


def test_phase11_runs_qwen2_vl_after_whisper(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index("phase_whisper()") < main.index("phase_vl()") \
        < main.index("print(json.dumps(line))")
    assert "add_vl_entries" in main
    assert cs.VL_LAYERS == 16 and cs.VL_TRAIN_LAYERS == 2
    assert cs.VL_TEXT + cs.VL_GRID[0] * cs.VL_GRID[1] + 448 == cs.VL_SEQ


def test_phase6_trains_the_first_layers_of_both_kinds(cs):
    """Phase 6 (b) trains xlstm-125m's first XLSTM_TRAIN_LAYERS layers:
    mlstm, mlstm, slstm -- both block kinds and the kernel, 2 x 2 x 3
    launches, at a quarter of (a)'s sequence."""
    import dataclasses
    from repro_torch.config import get_model_config
    cfg = dataclasses.replace(get_model_config("xlstm-125m"),
                              num_layers=cs.XLSTM_TRAIN_LAYERS)
    assert cfg.blocks() == ("mlstm", "mlstm", "slstm")
    assert cfg.blocks().count("mlstm") * 2 * cs.XLSTM_STEPS == 12
    assert 4 * cs.XLSTM_TRAIN_SEQ == cs.XLSTM_SEQ == 2048


# ---------------------------------------------------------------------------
# phase 8 (g)-(i): qwen3-moe trained, expert-parallel and served at tp=2
# ---------------------------------------------------------------------------

def _moe_rank_result(cs, r, **kw):
    n = cs.MOE_DIST_STEPS
    res = {"coords": {"data": r // 2, "model": r % 2},
           "loss": [10.0, 9.05][:n], "grad_norm": [5.05, 4.0][:n],
           "lr": [3e-4, 1.65e-4][:n],
           "launches": cs.MOE_TRAIN_LAYERS * 2 * n,
           "q_offsets": [(r % 2) * 1024], "init_keys": [(r, 1), (7, 7)],
           "numel": [64 * 8, 3], "experts": [64] * 6}
    res.update(kw)
    return res


@pytest.mark.parametrize("bad,match", [
    (dict(loss=[10.2, 9.05]), "step 0"),
    (dict(grad_norm=[5.05, 4.1]), "step 1"),
    (dict(lr=[3e-4, 1.66e-4]), "step 1"),
    (dict(launches=7), "launched fastattn_fwd 7"),
    (dict(q_offsets=[0, 1024]), "q_offsets"),
    (dict(init_keys=[(9, 9), (7, 7)]), "initial pieces"),
    (dict(experts=[128] * 6), "expert leaves"),
    (dict(numel=[128 * 8, 3]), "1/2 of the whole"),
])
def test_moe_dist_gate_rejects_faked_failures(cs, bad, match):
    """(h)'s gate, phase 4b's ``dist_gate`` at (h)'s layers and steps
    without the checkpoint: the ranks agree, each step within phase 4b's
    bounds of (g)'s and lr exact, fastattn_fwd MOE_TRAIN_LAYERS x 2 x
    MOE_DIST_STEPS launches at the rank's q_offset, the initial pieces
    (g)'s slices, each expert leaf the rank's 64 experts, half of it."""
    torch = pytest.importorskip("torch")
    assert cs.MOE_DIST_STEPS == 2 and cs.MOE_TRAIN_LAYERS == 2
    ref = {"loss": [10.0, 9.0, 8.0], "grad_norm": [5.0, 4.0, 3.0],
           "lr": [3e-4, 1.65e-4, 3e-5],
           "init": [torch.zeros(128, 8), torch.zeros(3)]}
    keys = [[(r, 1), (7, 7)] for r in range(4)]
    kw = dict(layers=cs.MOE_TRAIN_LAYERS, steps=cs.MOE_DIST_STEPS,
              experts=64, checkpoint=False)
    specs = [("model", None), ()]
    cs.dist_gate("ok", [_moe_rank_result(cs, r) for r in range(4)],
                 ref, keys, specs, 2048, 2, **kw)
    ranks = [_moe_rank_result(cs, r) for r in range(4)]
    for k, v in bad.items():
        for res in ranks if k in ("loss", "grad_norm", "lr") else \
                ranks[1:2]:
            res[k] = v
    with pytest.raises(AssertionError, match=match):
        cs.dist_gate("bad", ranks, ref, keys, specs, 2048, 2, **kw)
    ranks = [_moe_rank_result(cs, r) for r in range(4)]
    ranks[3]["grad_norm"] = [5.05, 4.01]
    with pytest.raises(AssertionError, match="differs from rank 0"):
        cs.dist_gate("disagree", ranks, ref, keys, specs, 2048, 2, **kw)


def test_delta_gate_sums_each_leafs_distinct_pieces(cs):
    """A leaf sharded over model is summed over the model ranks of data
    coordinate 0, a replicated leaf read once; a leaf one device left
    unchanged must stay so."""
    coords = [{"data": r // 2, "model": r % 2} for r in range(4)]
    # leaf 0 sharded over model: pieces 0.3^2 + 0.4^2 of 10^2 (the data
    # replicas' pieces read once); leaf 1 whole
    ranks = [{"coords": c, "delta": [((0.3 if c["model"] == 0 else 0.4)
                                      ** 2, 50.0), (0.01, 4.0),
                                     (0.0, 0.0)]}
             for c in coords]
    rel = cs.delta_gate("ok", ["/a", "/b", "/c"], ranks,
                        [("model",), (), ()])
    assert rel == pytest.approx({"/a": 0.05, "/b": 0.05, "/c": 0.0})
    ranks[1]["delta"][0] = (4.0, 50.0)      # model rank 1's piece
    with pytest.raises(AssertionError, match="/a"):
        cs.delta_gate("bad", ["/a", "/b", "/c"], ranks,
                      [("model",), (), ()])
    ranks[1]["delta"][0] = (0.16, 50.0)
    ranks[0]["delta"][2] = (1e-6, 0.0)
    with pytest.raises(AssertionError, match="/c"):
        cs.delta_gate("bad", ["/a", "/b", "/c"], ranks,
                      [("model",), (), ()])


def test_delta_gate_holds_moe_leaves_to_their_own_bound(cs):
    """(h)'s MoE leaves (a path through /moe/) within MOE_DELTA_RTOL,
    every other leaf still within DIST_DELTA_RTOL."""
    assert cs.DIST_DELTA_RTOL < cs.MOE_DELTA_RTOL < 0.6
    paths = ["/layers/1/moe/router", "/layers/1/attn/wq"]

    def ranks(moe, attn):
        return [{"coords": {}, "delta": [(moe ** 2, 1.0), (attn ** 2, 1.0)]}]
    rel = cs.delta_gate("ok", paths, ranks(0.25, 0.1), [(), ()],
                        cs.MOE_DELTA_RTOL)
    assert rel[paths[0]] == pytest.approx(0.25)
    with pytest.raises(AssertionError, match="moe/router"):
        cs.delta_gate("phase 4b's bound", paths, ranks(0.25, 0.1), [(), ()])
    with pytest.raises(AssertionError, match="moe/router"):
        cs.delta_gate("control", paths, ranks(0.6, 0.1), [(), ()],
                      cs.MOE_DELTA_RTOL)
    with pytest.raises(AssertionError, match="attn/wq"):
        cs.delta_gate("attention", paths, ranks(0.1, 0.2), [(), ()],
                      cs.MOE_DELTA_RTOL)


def test_whole_experts_gate_rejects_a_sliced_rank(cs):
    ok = [{"experts": [128] * 4} for _ in range(2)]
    cs.whole_experts_gate("ok", ok, 128, 4)
    bad = [{"experts": [128] * 4}, {"experts": [64] * 4}]
    with pytest.raises(AssertionError, match="rank 1 holds"):
        cs.whole_experts_gate("bad", bad, 128, 4)
    with pytest.raises(AssertionError, match="rank 0 holds"):
        cs.whole_experts_gate("short", [{"experts": [128] * 3}], 128, 4)


def test_phase8g_h_on_a_reduced_bf16_moe_and_cpu_ranks(cs, monkeypatch):
    """(g) and (h) on the CPU before the card: reduced qwen3-moe in bf16
    at 2 x 64 (the random router drops at capacity factor 1.25), (g)'s
    steps through the trainer's functions with their drop shares, then
    (h)'s four gloo ranks from the same draw and batches held by its
    gates -- phase 4b's bounds against (g), each leaf's update from the
    ranks' pieces, the rule table's 2 of 4 experts a rank -- with the
    launch and q_offset check fed the card's counts (the CPU runs the
    plain attention, which counts no launches).  The same ranks then
    decode phase 15's qwen3-moe job, held by its gates."""
    import dataclasses
    import sys
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    # the ranks unpickle chip_smoke's rank body by its module's name
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    for name in ("reset_peak_memory_stats", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "MOE_TRAIN_SEQ", 64)
    gate = cs.dist_gate

    def card_counts(what, ranks, ref, keys, specs, seq, model, **kw):
        for r in ranks:
            assert r["launches"] == 0
            r["launches"] = cs.MOE_TRAIN_LAYERS * 2 * cs.MOE_DIST_STEPS
            r["q_offsets"] = [r["coords"]["model"] * seq // model]
        return gate(what, ranks, ref, keys, specs, seq, model, **kw)
    monkeypatch.setattr(cs, "dist_gate", card_counts)
    cfg = dataclasses.replace(
        reduce_for_smoke(get_model_config("qwen3-moe-30b-a3b")),
        dtype="bfloat16", param_dtype="bfloat16")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        g = cs.moe_train(cfg, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert g["layers"] == cs.MOE_TRAIN_LAYERS and g["launches"] == 0
    assert len(g["losses"]) == cs.MOE_TRAIN_STEPS
    assert all(0 < x < 1 for x in g["drop_share"])
    assert g["loss_rel"] <= cs.LOSS_RTOL and g["gnorm_rel"] <= cs.GNORM_RTOL
    arch = "qwen3-moe-30b-a3b"
    cut = dataclasses.replace(cfg, num_layers=cs.MOE_TRAIN_LAYERS)
    job = _decode_job(cs, arch, cut)
    h = cs.moe_dist(g, cfg, decode=job)
    print(f"(h) worst update {h['worst_delta']}, loss {h['loss']} vs "
          f"{h['ref_loss']}, grad norm {h['grad_norm']} vs "
          f"{h['ref_grad_norm']}")
    assert h["experts"] == [2] * 4
    assert h["worst_delta"][1] <= cs.DIST_DELTA_RTOL
    # phase 15's qwen3-moe job rode (h)'s ranks
    torch.set_num_threads(1)
    try:
        dec = cs.phase_mesh_decode({arch: (job, h.pop("decode_ranks"))},
                                   device="cpu")
    finally:
        torch.set_num_threads(n)
    _check_decode(cs, dec, {arch: (cut, None)})


def test_phase8_parallel_runs_after_phase8_and_feeds_the_kernels_line(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index("phase_moe()") < main.index("phase_moe_parallel(") \
        < main.index("phase_hymba()")
    assert "add_moe_parallel_entries" in main
    kernels = [{"name": n} for n in ("paged_prefill", "paged_decode",
                                     "fastattn_fwd", "flash_decode")]
    cs.add_moe_parallel_entries(kernels, {
        "train": {"launches": 12},
        "dist": {"launches": [8] * 4, "q_offsets": [[0], [1024]] * 2},
        "tp": {"launches": [{"paged_prefill": 40, "paged_decode": 124}] * 2}})
    k = {e["name"]: e for e in kernels}
    assert k["fastattn_fwd"]["moe_train_launches"] == 12
    assert k["fastattn_fwd"]["moe_ep_launches"] == [8] * 4
    assert k["paged_prefill"]["moe_tp_launches"] == [40, 40]
    assert k["paged_decode"]["moe_tp_launches"] == [124, 124]
    assert "moe_tp_launches" not in k["flash_decode"]


def test_phase3d_runs_the_first_16_layers(cs):
    """Phase 3d's cut: llama2-7b's first FEATURE_LAYERS = 16 of 32
    layers, the weights shared; a model with fewer layers runs whole."""
    pytest.importorskip("torch")
    import inspect
    from repro_torch.config import get_model_config, reduce_for_smoke
    from repro_torch.models import build_model
    assert cs.FEATURE_LAYERS == 16
    assert "first_layers(model, params, FEATURE_LAYERS)" in \
        inspect.getsource(cs.phase_features)
    cfg = reduce_for_smoke(get_model_config("llama2-7b"))
    model = build_model(cfg, "cpu")
    params = model.init(model.generator(0))
    cut, cut_params = cs.first_layers(model, params, 1)
    assert cut.cfg.num_layers == 1 and len(cut_params["layers"]) == 1
    assert cut_params["layers"][0] is params["layers"][0]
    assert cut_params["embedding"] is params["embedding"]
    whole, _ = cs.first_layers(model, params, cs.FEATURE_LAYERS)
    assert whole.cfg.num_layers == cfg.num_layers


def test_moe_checks_variants_still_apply():
    """``moe_checks.py ep``'s variants are text changes to a copy of this
    checkout: each text they replace is still there, as often as when
    they were measured (the seeds' in every TrainConfig and DataConfig
    of chip_smoke.py that (g) and (h) build)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("moe_checks",
                                                  ROOT / "moe_checks.py")
    mc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mc)
    counts = {}
    for variant in ("f32", "ctrl", "seed1"):
        for rel, old, new in mc._patches(variant):
            text = (ROOT / rel).read_text()
            counts[(variant, old)] = text.count(old)
            assert old in text and new not in text, (variant, rel, old)
    assert counts[("seed1", "TrainConfig(learning_rate=3e-4, ")] == 8
    assert counts[("seed1", "DataConfig(vocab_size=cfg.vocab_size,")] == 6
    assert all(n == 1 for (v, _), n in counts.items() if v != "seed1")
    assert mc._patches("seed0") == []
    with pytest.raises(SystemExit):
        mc._patches("bf17")


# ---------------------------------------------------------------------------
# phase 12: the recurrent cells and the encoder-decoder on a (2, 2) mesh
# ---------------------------------------------------------------------------

def test_phase12_expects_each_ranks_launches(cs):
    """Each model's cut and the launches a (2, 2) rank must make: two
    mLSTM blocks at 2 of xlstm-125m's 4 heads and no attention; hymba's
    2 attention layers at the rank's first row; whisper's 2 encoder, 2
    self- and 2 cross-attentions at its first frame, first token and 0 --
    each twice a step under remat, MESH_STEPS steps."""
    import dataclasses
    from repro_torch.config import get_model_config
    cfgs = {a: dataclasses.replace(get_model_config(a), **keep)
            for a, (keep, _) in cs.MESH_MODELS.items()}
    assert cfgs["xlstm-125m"].blocks() == ("mlstm", "mlstm", "slstm")
    assert cfgs["hymba-1.5b"].blocks() == ("hymba", "hymba_local")
    assert (cfgs["whisper-small"].encoder_layers,
            cfgs["whisper-small"].num_layers) == (2, 2)
    n = 2 * cs.MESH_STEPS
    x = cs.mesh_expected(cfgs["xlstm-125m"], 1024, 2)
    assert (x["fastattn_fwd"], x["mlstm_chunkwise"], x["mlstm_heads"]) == \
        (0, 2 * n, [2])
    h = cs.mesh_expected(cfgs["hymba-1.5b"], 1024, 2)
    assert (h["fastattn_fwd"], h["mlstm_chunkwise"]) == (2 * n, 0)
    assert [h["offsets"](m) for m in (0, 1)] == [[0], [512]]
    w = cs.mesh_expected(cfgs["whisper-small"], 448, 2)
    assert w["fastattn_fwd"] == 6 * n
    assert [w["offsets"](m) for m in (0, 1)] == [[0], [0, 224, 750]]
    # reduced xlstm at a model axis of 4: its 2 heads run whole
    from repro_torch.config import reduce_for_smoke
    r = dataclasses.replace(reduce_for_smoke(get_model_config("xlstm-125m")),
                            num_layers=3)
    assert cs.mesh_expected(r, 64, 4)["mlstm_heads"] == [2]
    name, kw = cs.MLSTM_CASES[-1]
    assert name == cs.MESH_MLSTM_CASE and (kw["b"], kw["h"], kw["s"]) == (
        cs.MESH_BATCH // 2, 2, 1024) and kw["dk"] == kw["dv"] == 384
    # phase 2 holds fastattn_fwd at each shape a model rank 1 launches it
    # with: whisper's encoder, hymba's rows, whisper's decoder and cross
    fwd = dict(cs.FWD_CASES)
    shapes = {pre: (kw["b"], kw["hq"], kw["hkv"], kw["sq"], kw["skv"],
                    kw.get("causal", True), kw.get("q_offset", 0),
                    kw.get("window"))
              for pre, (name, kw) in cs.MESH_FWD_CASES.items()
              if fwd[name] is kw}
    b = cs.MESH_BATCH // 2
    assert shapes == {"mesh": (b, 12, 12, 750, 1500, False, 750, None),
                      "mesh_hymba": (b, 25, 5, 512, 1024, True, 512,
                                     cfgs["hymba-1.5b"].window_size),
                      "mesh_dec": (b, 12, 12, 224, 448, True, 224, None),
                      "mesh_cross": (b, 12, 12, 224, 1500, False, 0, None)}
    assert {v[6] for v in shapes.values()} <= set(
        h["offsets"](1) + w["offsets"](1))


def test_phase12_gates_reject_faked_failures(cs):
    ok = [{"mlstm_launches": 8, "mlstm_heads": [2]} for _ in range(4)]
    want = {"mlstm_chunkwise": 8, "mlstm_heads": [2]}
    cs.mesh_launch_gate("ok", ok, want)
    for bad in ({"mlstm_launches": 7}, {"mlstm_heads": [4]}):
        ranks = [dict(r) for r in ok]
        ranks[3].update(bad)
        with pytest.raises(AssertionError, match="rank 3 launched"):
            cs.mesh_launch_gate("bad", ranks, want)
    torch = pytest.importorskip("torch")
    init = [torch.zeros(4), torch.zeros(4)]
    grad = torch.linspace(-1, 1, 1000)
    ref = {"paths": ["/w", "/b"], "loss": [10.0, 9.0],
           "grad_norm": [2.0, 1.0], "init": init,
           "snapshot": [torch.ones(4), torch.ones(4)],
           "grad0": [grad, grad]}
    small = dict(ref, loss=[10.001, 9.0], grad_norm=[2.0, 1.001],
                 snapshot=[torch.ones(4) * 1.01, torch.ones(4)],
                 grad0=[grad * 1.01, grad])
    g = cs.measured_mesh_gate(ref, small)
    assert (g["loss"], g["grad_norm"], g["delta"], g["grad0"]) == (
        [cs.DIST_LOSS_RTOL] * 2, [cs.DIST_GNORM_RTOL] * 2,
        cs.DIST_DELTA_RTOL, cs.MESH_GRAD_RTOL)
    # step 0 keeps phase 4b's bounds, a later step takes twice the largest
    # change over the steps, every leaf twice the largest leaf's change
    large = dict(ref, loss=[10.0, 9.9], grad_norm=[3.0, 1.0],
                 snapshot=[torch.ones(4) * 1.5, torch.ones(4)],
                 grad0=[grad, grad * 1.1])
    g = cs.measured_mesh_gate(ref, large)
    assert g["loss"] == [cs.DIST_LOSS_RTOL, pytest.approx(0.2)]
    assert g["grad_norm"] == [cs.DIST_GNORM_RTOL, 1.0]
    assert g["delta"] == pytest.approx(1.0)
    assert g["measured"]["delta"] == ["/w", pytest.approx(0.5)]
    assert g["grad0"] == pytest.approx(0.2)
    assert g["measured"]["grad0"] == ["/b", pytest.approx(0.1)]
    # a measured gradient bound at MESH_GRAD_CAP could pass a dropped leaf
    with pytest.raises(AssertionError, match="MESH_GRAD_CAP"):
        cs.measured_mesh_gate(ref, dict(large, grad0=[grad, grad * 1.4]))


def test_phase12_gradient_gate_sees_a_dropped_or_scrambled_leaf(cs):
    """Step 0's gradients from the ranks' pieces at the bound phase 12
    gives a leaf: a leaf of the right gradient passes, one the mesh
    dropped (1.0 of one device's) or scrambled -- the right size in
    another direction (about 1.41) -- fails under MESH_GRAD_CAP, and one
    piece of a leaf sharded over the model axis left at zero (about
    0.71) under MESH_GRAD_RTOL."""
    torch = pytest.importorskip("torch")
    gen = torch.Generator().manual_seed(0)
    one = torch.randn(2, 1000, generator=gen)
    coords = [{"data": r // 2, "model": r % 2} for r in range(4)]

    def ranks(rows):         # the leaf sharded over model by rows
        return [{"coords": c, "grad0": [(
            (rows[c["model"]] - one[c["model"]]).square().sum().item(),
            one[c["model"]].square().sum().item())]} for c in coords]
    near = one * 1.02
    rel = cs.delta_gate("ok", ["/w"], ranks(near), [("model",)],
                        bound=cs.MESH_GRAD_RTOL, key="grad0")
    assert rel["/w"] == pytest.approx(0.02)
    scrambled = torch.randn(2, 1000, generator=gen)
    for bad, bound in ((torch.zeros_like(one), cs.MESH_GRAD_CAP),
                       (scrambled, cs.MESH_GRAD_CAP),
                       (torch.stack([one[0], torch.zeros(1000)]),
                        cs.MESH_GRAD_RTOL)):
        with pytest.raises(AssertionError, match="step-0 gradient off"):
            cs.delta_gate("bad", ["/w"], ranks(bad), [("model",)],
                          bound=bound, key="grad0")


def test_phase12_on_reduced_bf16_models_and_cpu_ranks(cs, monkeypatch):
    """Phase 12 on the CPU before the card: reduced xlstm-125m (3
    layers), hymba-1.5b and whisper-small in bf16, each one-device run and
    then one spawn of four gloo ranks that trains the three in turn, held
    by the phase's gates -- with the launch counts fed the card's (the
    CPU runs the plain attention and the plain mLSTM, which count no
    launches).  The same ranks then decode each model's phase 15 job
    (``REHEARSAL_DECODE``), held by phase 15's gates after the spawn."""
    import dataclasses
    import sys
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    for name in ("reset_peak_memory_stats", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    gate, launch_gate = cs.dist_gate, cs.mesh_launch_gate

    def card_counts(what, ranks, ref, keys, specs, seq, model, **kw):
        for r in ranks:
            assert r["launches"] == 0
            r["launches"] = kw["launches"]
            r["q_offsets"] = (kw["offsets"](r["coords"]["model"])
                              if kw["launches"] else [])
        return gate(what, ranks, ref, keys, specs, seq, model, **kw)

    def card_mlstm(what, ranks, want):
        for r in ranks:
            assert r["mlstm_launches"] == 0
            r["mlstm_launches"] = want["mlstm_chunkwise"]
            r["mlstm_heads"] = want["mlstm_heads"]
        return launch_gate(what, ranks, want)
    monkeypatch.setattr(cs, "dist_gate", card_counts)
    monkeypatch.setattr(cs, "mesh_launch_gate", card_mlstm)

    def small(arch, **kw):
        return dataclasses.replace(reduce_for_smoke(get_model_config(arch)),
                                   dtype="bfloat16", param_dtype="bfloat16",
                                   **kw)
    configs = {"xlstm-125m": (small("xlstm-125m", num_layers=3), 32),
               "hymba-1.5b": (small("hymba-1.5b"), 48),
               "whisper-small": (small("whisper-small"), 16)}
    decode = {arch: _decode_job(cs, arch, cfg)
              for arch, (cfg, _) in configs.items()}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.phase_mesh(device="cpu", configs=configs, decode=decode)
        assert set(out["decode"]) == set(configs)
        for arch, (job, ranks) in out["decode"].items():
            assert job is decode[arch] and len(ranks) == 4
        dec = cs.phase_mesh_decode(out.pop("decode"), device="cpu")
    finally:
        torch.set_num_threads(n)
    _check_decode(cs, dec, configs)
    for arch, res in out["models"].items():
        print(f"{arch}: worst update {res['worst_delta']}, loss "
              f"{res['loss']} vs {res['ref_loss']}, grad norm "
              f"{res['grad_norm']} vs {res['ref_grad_norm']}, gates "
              f"{res['gates']}")
        assert len(res["loss"]) == cs.MESH_STEPS
        assert res["worst_grad0"][1] <= cs.MESH_GRAD_RTOL
    assert "measured" in out["models"]["xlstm-125m"]["gates"]
    kernels = [{"name": k} for k in ("fastattn_fwd", "flash_decode",
                                     "mlstm_chunkwise")]
    case = {"err": 1e-3, "ms": 0.2, "device_ms": 0.1, "plain_ms": 9.0,
            "bound_ms": 0.05, "bound_by": "operations", "library_ms": None}
    cs.add_mesh_entries(kernels, {"mlstm_chunkwise": {"mesh": case},
                                  "fastattn_fwd": {
                                      pre: case for pre in
                                      cs.MESH_FWD_CASES}}, out)
    k = {e["name"]: e for e in kernels}
    assert k["flash_decode"] == {"name": "flash_decode"}
    assert k["fastattn_fwd"]["mesh_cross_bound_by"] == "operations"
    assert k["mlstm_chunkwise"]["mesh_launches"] == [
        2 * 2 * cs.MESH_STEPS] * 4
    assert set(k["fastattn_fwd"]["mesh_launches"]) == {"hymba-1.5b",
                                                       "whisper-small"}
    assert k["fastattn_fwd"]["mesh_device_ms"] == 0.1


# arch -> (cache width, positions) of phase 15's rehearsal at reduced
# widths: slices of 48 (hymba: its window of 32 empties slice 0 at 80,
# 81), 16 (whisper) and 32 (qwen3-moe) positions at model = 2
REHEARSAL_DECODE = {"xlstm-125m": (16, (0, 1, 2)),
                    "hymba-1.5b": (96, (46, 47, 48, 80, 81)),
                    "whisper-small": (32, (14, 15, 16, 17)),
                    "qwen3-moe-30b-a3b": (64, (30, 31, 32, 33))}


def _decode_job(cs, arch, cfg):
    width, positions = REHEARSAL_DECODE[arch]
    return cs.decode_job_for(arch, cfg, batch=4, width=width,
                             positions=positions)


def _check_decode(cs, dec, configs):
    """Phase 15's summary of a rehearsal: every model gated, the CPU's
    plain path launching nothing, every local attention asked for the
    log-sum-exp, each rank's worst rows and states within the bound, and
    a MoE model's last MoE block on every rank held to the plain block
    on the rank's own input, its routing choices counted."""
    assert set(dec["models"]) == set(configs) and dec["card"] == "cpu"
    for arch, res in dec["models"].items():
        cfg = configs[arch][0]
        steps = len(REHEARSAL_DECODE[arch][1])
        want = cs.decode_expected(cfg, steps, on_card=False)
        assert res["launches"] == [0] * 4, arch
        assert res["lse_calls"] == [want["lse_calls"]] * 4, arch
        assert res["fastattn_launches"] == [0] * 4, arch
        assert all(w <= 1.0 for w in res["written_worst"] +
                   res["state_worst"] + res["moe_worst"]), arch
        moe = "moe" in cfg.blocks()
        assert len(res["moe_worst"]) == (4 if moe else 0), arch
        assert res["moe_choices"] == ([2 * steps * cfg.num_experts_per_tok]
                                      * 4 if moe else []), arch
        print(f"[15] {arch}: gate {res['gate']:.3g} ({res['rule']}), "
              f"written {res['written_worst']}, states "
              f"{res['state_worst']}, last MoE block {res['moe_worst']}, "
              f"routing flips {res['moe_flips']} of {res['moe_choices']}")


def test_phase12_runs_last_and_phase3e_pays_for_it(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index("phase_vl()") < main.index("phase_mesh()") < \
        main.index('done("12")') < main.index("add_mesh_entries")
    assert cs.TP_LAYERS == 8
    assert "first_layers(model, params, TP_LAYERS)" in inspect.getsource(
        cs.phase_tp)


def _smoke_llama(**kw):
    import dataclasses
    from repro_torch.config import get_model_config, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_model_config(
        "llama2-7b")), dtype="bfloat16", param_dtype="bfloat16", **kw)


def test_phase3f_on_a_reduced_bf16_llama(cs):
    """Phase 3f on the CPU before the card: both layouts of a reduced
    bf16 llama2-7b within JAX's rules, no launch on the plain path, and
    the stacked layout's shared scales counted once."""
    torch = pytest.importorskip("torch")
    from repro_torch.models import build_model
    model = build_model(_smoke_llama(), "cpu")
    params = model.init(model.generator(0))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.phase_int8(model, params)
    finally:
        torch.set_num_threads(n)
    assert out["launches"] == [0, 0, 0]
    stacked, own = out["layouts"]["True"], out["layouts"]["False"]
    # scan_layers=True: the 2 layers' 9 leaves (norm scales too) share
    # one scale each, beside the embed's and the head's
    assert stacked["scale_tensors"] == 9 + 2
    assert own["scale_tensors"] == own["quantized_leaves"] == 2 * 7 + 2
    for res in (stacked, own):
        assert 0.45 < res["size_ratio"] < cs.INT8_SIZE
        assert res["agree"] > cs.INT8_AGREE and res["agree_where_decisive"]


def test_int8_gate_rejects_faked_failures(cs):
    torch = pytest.importorskip("torch")
    gen = torch.Generator().manual_seed(0)
    base = torch.randn(4, 8, 256, generator=gen)
    assert cs.int8_gate("ok", base + 1e-3, base, 0.5)["agree"] == 1.0
    for got, size, match in ((base * 1.3, 0.5, "fail"),
                             (base.flip(-1), 0.5, "fail"),
                             (base, 0.7, "fail"),
                             (base * float("nan"), 0.5, "non-finite")):
        with pytest.raises(AssertionError, match=match):
            cs.int8_gate("bad", got, base, size)


def test_phase13_on_reduced_bf16_llama_and_cpu_ranks(cs, monkeypatch):
    """Phase 13 on the CPU before the card: four gloo ranks take a
    reduced bf16 llama2-7b's gradients through the train step and three
    rounds of compressed_psum, then GPipe over four of its blocks, held
    by the phase's gates (no launch on the plain path)."""
    import sys
    torch = pytest.importorskip("torch")
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    out = cs.phase_compress_pipeline(
        device="cpu", cfg_a=_smoke_llama(num_layers=2),
        cfg_b=_smoke_llama(num_layers=cs.PIPE_STAGES), seq=32, pipe_seq=16)
    c, p = out["compress"], out["pipeline"]
    assert len(c["rounds"]) == cs.COMPRESS_ROUNDS
    assert c["rounds"][-1]["worst_ulps"][1] <= cs.COMPRESS_ULPS
    for rnd in c["rounds"]:
        assert rnd["bytes"] - 4 * len(rnd["mean_err"]) == c["f32_bytes"]
    assert c["launches"] == [0] * cs.PIPE_WORLD
    assert p["launches"] == [0] * cs.PIPE_WORLD and p["ticks"] == 11
    assert p["bubble"] == 3 / 11
    del torch


def test_phase13_gates_reject_faked_failures(cs):
    torch = pytest.importorskip("torch")

    def ranks(**bad):
        rnd = {"keys": [(1, 2), (3, 4)], "residual_exact": [True, True],
               "counts": {"all_reduce": 4, "bytes": 8 + 80},
               "ulps": [0.5, 1.0], "mean_err": [0.01, 0.02],
               "wall_s": 0.1}
        out = []
        for r in range(4):
            c = {"paths": ["/a", "/b"], "f32_bytes": 80, "numel": 20,
                 "launches": 4, "rounds": [dict(rnd)]}
            p = {"key": (5, 6), "launches": 11, "carry_bytes": 8,
                 "counts": {"ppermute": 11, "all_reduce": 1,
                            "bytes": 11 * 8 + 8 * 8 * 4},
                 "out": torch.ones(8, 8), "wall_s": 0.1}
            if r == 1:
                for k, v in bad.items():
                    (c["rounds"][0] if k in rnd else p if k in p
                     else c)[k] = v
            out.append({"compress": c, "pipeline": p, "device": "cpu",
                        "backend": "gloo"})
        return out
    cs.compress_gate("ok", ranks(), 4)
    cs.pipeline_gate("ok", ranks(), torch.ones(8, 8), 11)
    for bad, match in ((dict(keys=[(1, 2), (3, 5)]), "differs"),
                       (dict(residual_exact=[True, False]), "residual"),
                       (dict(counts={"all_reduce": 4, "bytes": 8 + 20}),
                        "collectives")):
        with pytest.raises(AssertionError, match=match):
            cs.compress_gate("bad", ranks(**bad), 4)
    r = ranks()
    r[1]["compress"]["launches"] = 3
    with pytest.raises(AssertionError, match="launched"):
        cs.compress_gate("bad", r, 4)
    r = ranks()
    r[0]["compress"]["rounds"][0]["ulps"] = [0.5, cs.COMPRESS_ULPS + 1]
    with pytest.raises(AssertionError, match="ulps"):
        cs.compress_gate("bad", r, 4)
    r[0]["compress"]["rounds"][0]["ulps"] = [0.5]   # a leaf not checked
    with pytest.raises(AssertionError, match="float64 check"):
        cs.compress_gate("bad", r, 4)
    with pytest.raises(AssertionError, match="differs"):
        cs.pipeline_gate("bad", ranks(key=(5, 7)), torch.ones(8, 8), 11)
    with pytest.raises(AssertionError, match="launches"):
        cs.pipeline_gate("bad", ranks(launches=10), torch.ones(8, 8), 11)
    with pytest.raises(AssertionError, match="max_abs_err"):
        cs.pipeline_gate("bad", ranks(), torch.ones(8, 8) * 2, 11)


def test_roofline_readings_and_kernels_line(cs):
    trained = {"layers": 4, "seq": 2048, "batch": 4, "steady_step_s": 0.42}
    long_step = {"kv_len": cs.LONG_KV, "step_bytes": 4.76e10,
                 "device_ms": 19.2, "wall_ms": 31.0}
    out = cs.roofline_readings(trained, long_step)
    assert 0.05 < out["mfu"] < 0.15
    assert out["decode_terms"]["dominant"] == "memory_s"
    assert out["decode_bound_ms"] == pytest.approx(4.76e10 / 3.35e12 * 1e3)
    assert out["decode_share_wall"] < out["decode_share_device"] < 1.05
    with pytest.raises(AssertionError, match="1.05"):
        cs.roofline_readings(dict(trained, steady_step_s=0.01), long_step)
    kernels = [{"name": n} for n in ("paged_prefill", "fastattn_fwd")]
    cs.add_int8_pipeline_entries(kernels, {"launches": [32, 32, 32]},
                                 {"pipeline": {"launches": [11] * 4}})
    assert kernels[0] == {"name": "paged_prefill"}
    assert kernels[1]["int8_launches"] == [32, 32, 32]
    assert kernels[1]["pipeline_launches"] == [11] * 4


def test_phase3f_and_13_run_in_order_and_4b_pays(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index('done("3e")') < main.index("phase_int8(") < \
        main.index('done("3f")') < main.index("del model, params")
    assert main.index('done("12")') < main.index(
        "phase_compress_pipeline(") < main.index('done("13")') < \
        main.index("roofline_readings(") < main.index(
            "add_int8_pipeline_entries")
    # phase 4b writes its checkpoint once, gathers it once, and the
    # parent reads it back once for both the (2, 2) and (1, 2) checks
    job = inspect.getsource(cs._dist_job)
    assert "gather_host" not in job and "final_keys" in job
    assert inspect.getsource(cs.phase_dist_training).count(
        "read_checkpoint(") == 1
    assert "checkpoint_leaves" not in inspect.getsource(cs._dist_resume)


def _cp_job(cs, **kw):
    """Phase 14's run at a reduced size: a reduced bf16 llama2-7b's 2
    layers, 4 rows on a 64-position cache (slices of 32), steps in slice
    0, across its end and in slice 1."""
    cfg = _smoke_llama(num_layers=2)
    return cs.cp_job_for([[1.0, 0.8], [0.9, 1.1]], cfg=cfg, batch=4,
                         width=64, positions=kw.get(
                             "positions", (10, 29, 30, 31, 32, 33)))


def test_phase14_alone_on_a_reduced_bf16_llama_and_cpu_ranks(cs,
                                                              monkeypatch):
    """Phase 14 on the CPU before the card: four gloo ranks at (2, 2)
    decode a reduced bf16 llama2-7b from their cache slices, held by
    ``cp_gate`` to the one-device run (no launch on the plain path, every
    local attention asked for the log-sum-exp)."""
    import sys
    pytest.importorskip("torch")
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    job = _cp_job(cs)
    out = cs.phase_cp_decode(job, device="cpu")
    assert out["launches"] == [0] * 4 and out["lse_calls"] == [12] * 4
    assert out["merges_a_step"] == [4.0] * 4        # 2 layers x (max, sum)
    assert all(w <= 1.0 for rank in out["written_worst"] for w in rank)
    assert out["ref_launches"] == 0 and out["card"] == "cpu"


def test_phase14_rides_phase13s_spawn(cs, monkeypatch):
    """On the card phase 14's ranks run in phase 13's spawn after (b):
    the same ranks' results feed ``phase_cp_decode``."""
    import sys
    pytest.importorskip("torch")
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    job = _cp_job(cs, positions=(31, 32))
    out = cs.phase_compress_pipeline(
        device="cpu", cfg_a=_smoke_llama(num_layers=2),
        cfg_b=_smoke_llama(num_layers=cs.PIPE_STAGES), seq=32, pipe_seq=16,
        cp_job=job)
    assert out["pipeline"]["ticks"] == 11 and len(out["cp_ranks"]) == 4
    cp = cs.phase_cp_decode(job, out.pop("cp_ranks"), device="cpu")
    assert cp["lse_calls"] == [4] * 4


def test_cp_cache_pieces_are_the_whole_caches_slices(cs):
    """A rank's slice drawn alone equals the one-device cache's rows and
    positions: the pieces are seeded by (layer, k/v, row, slice)."""
    torch = pytest.importorskip("torch")
    from repro_torch.models import build_model
    job = _cp_job(cs)
    model = build_model(job["cfg"], "cpu")
    whole = model.init_cache(4, 64)
    cs._cp_fill(job, whole, range(4), range(2), torch.device("cpu"))
    mine = model.init_cache(2, 32)
    cs._cp_fill(job, mine, range(2, 4), [1], torch.device("cpu"))
    for w, m in zip(whole, mine):
        assert torch.equal(m.k, w.k[2:4, 32:64])
        assert torch.equal(m.v, w.v[2:4, 32:64])
    assert not torch.equal(whole[0].k[0], whole[0].v[0])
    assert whole[1].v.float().square().mean().sqrt().item() == \
        pytest.approx(1.1, rel=0.05)


def test_phase14_gate_rejects_faked_failures(cs):
    torch = pytest.importorskip("torch")
    import numpy as np
    job = _cp_job(cs, positions=(31, 32))
    b_l, s_l = 2, 32
    rng = np.random.default_rng(0)
    logits = [rng.normal(size=(4, 256)).astype(np.float32) for _ in range(2)]
    logits[0][:, 0] += 50           # clear top-1 margins
    kv = {pos: [(rng.normal(size=(4, 2, 16)).astype(np.float32),
                 rng.normal(size=(4, 2, 16)).astype(np.float32))
                for _ in range(2)] for pos in (31, 32)}
    ref = {"logits": [torch.from_numpy(x) for x in logits],
           "written": {p: [(torch.from_numpy(k), torch.from_numpy(v))
                           for k, v in layers] for p, layers in kv.items()},
           "wall_s": 0.1, "launches": 4, "cache_gb": 0.1}

    def ranks(**bad):
        out = []
        for r in range(4):
            d, m = divmod(r, 2)
            rows = slice(d * b_l, (d + 1) * b_l)
            pos = 31 if m == 0 else 32
            res = {"coords": {"data": d, "model": m},
                   "shapes": [(b_l, s_l, 2, 16)] * 2,
                   "logits": [x[rows].copy() for x in logits],
                   "launches": 4, "lse_calls": 4, "plain_cuda": 0,
                   "written": {pos: [(k[rows].copy(), v[rows].copy())
                                     for k, v in kv[pos]]},
                   "wall_s": [0.1, 0.1], "peak_gb": 1.0,
                   "merges": {"all_reduce": 8, "bytes": 800},
                   "gathers": {"all_gather": 32, "bytes": 3200},
                   "kernel_device_ms": 0.3}
            if r == 3:
                for k, v in bad.items():
                    res[k] = v(res) if callable(v) else v
            out.append(res)
        return out
    cs.cp_gate("ok", ranks(), ref, job, on_card=True)

    def off_logits(res):
        return [x + 100.0 for x in res["logits"]]

    def off_rows(res):
        return {32: [(k + 1.0, v) for k, v in res["written"][32]]}

    def off_deep_rows(res):
        (k0, v0), (k1, v1) = res["written"][32]
        return {32: [(k0, v0), (k1 * 1.1, v1)]}

    def deep_in_scale(res):
        (k0, v0), (k1, v1) = res["written"][32]
        return {32: [(k0, v0), (k1 * 1.02 + 0.03, v1)]}

    def deep_in_bound(res):
        (k0, v0), (k1, v1) = res["written"][32]
        return {32: [(k0, v0), (k1 + 0.01, v1)]}

    def one_ulp(res):
        return [x + np.float32(1e-3) for x in res["logits"]]
    for bad, match in ((dict(shapes=[(b_l, 64, 2, 16)] * 2), "rule table"),
                       (dict(launches=3), "launched"),
                       (dict(lse_calls=3), "log-sum-exp"),
                       (dict(plain_cuda=1), "plain attention"),
                       (dict(logits=off_logits), "logits differ"),
                       (dict(logits=one_ulp), "other rank"),
                       (dict(written={31: kv[31]}), "owns"),
                       (dict(written=off_rows), "bf16 bound"),
                       (dict(written=off_deep_rows), "layer 1 k.*bf16 bound"),
                       (dict(written=deep_in_scale), "layer 1 k.*bf16 bound")):
        with pytest.raises(AssertionError, match=match):
            cs.cp_gate("bad", ranks(**bad), ref, job, on_card=True)
    with pytest.raises(AssertionError, match="launched"):
        cs.cp_gate("cpu", ranks(), ref, job, on_card=False)
    # every layer's rows are held to the bf16 bound, each layer's worst
    # ratio reported
    out = cs.cp_gate("deep", ranks(written=deep_in_bound), ref, job,
                     on_card=True)
    assert out["written_worst"][3][0] == 0.0
    assert 0.0 < out["written_worst"][3][1] <= 1.0


def test_phase2_slice_cases_cover_phase14s_edges(cs):
    """Phase 2 holds flash_decode's slice and log-sum-exp on llama2-7b's
    32/32 heads at a rank's second slice of decode_32k (no valid key, 6,
    the whole slice) and gemma2-2b's head shape where the window empties
    slice 0 and cuts slice 1."""
    keys = {pre: cs.slice_keys(kw["lens"], kw["kv_start"], kw["s"],
                               kw.get("window"))
            for pre, (_, kw) in cs.CP_SLICE_CASES.items()}
    assert keys["cp_empty"].tolist() == [0] * 4
    assert keys["cp_start"].tolist() == [6] * 4
    assert keys["cp_full"].tolist() == [16384] * 4
    full = cs.CP_SLICE_CASES["cp_full"][1]
    assert (full["b"], full["hq"], full["hkv"], full["d"], full["s"],
            full["kv_start"]) == (4, 32, 32, 128, 16384, 16384)
    assert keys["cp_gemma_s0"].tolist() == [0] * 8
    s1 = keys["cp_gemma_s1"]
    assert 0 in s1 and s1.max() == 4096 and sorted(s1)[1] == 1
    g = cs.CP_SLICE_CASES["cp_gemma_s1"][1]
    assert (g["hq"], g["hkv"], g["d"], g["window"], g["softcap"]) == (
        8, 4, 256, 4096, 50.0)
    # a window that starts inside the slice (cuts it from below)
    import numpy as np
    lo = np.asarray(g["lens"]) - g["window"]
    assert ((lo > g["kv_start"]) & (lo < g["kv_start"] + g["s"])).any()


def test_kernels_line_gains_cp_entries(cs):
    kernels = [{"name": n} for n in ("fastattn_fwd", "flash_decode")]
    res = {"err": 1e-3, "lse_err": 2e-6, "ms": 0.4, "device_ms": 0.33,
           "plain_ms": 9.0, "bound_ms": 0.32, "bound_by": "bytes",
           "library_ms": 0.5, "library_device_ms": 0.45}
    cs.add_cp_entries(kernels, {"cp_full": res},
                      {"launches": [28] * 4, "lse_calls": [28] * 4,
                       "kernel_device_ms": [0.33, 0.01, 0.33, 0.01]})
    assert kernels[0] == {"name": "fastattn_fwd"}
    k = kernels[1]
    assert k["cp_full_max_abs_err"] == 1e-3 and k["cp_full_lse_err"] == 2e-6
    assert k["cp_full_bound_ms"] == 0.32 and k["cp_launches"] == [28] * 4
    assert k["cp_lse_calls"] == [28] * 4


def test_phase14_runs_after_13_in_its_spawn(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index('done("12")') < main.index("cp_job_for(") < \
        main.index("phase_compress_pipeline(cp_job=cp_job)") < \
        main.index('done("13")') < main.index("phase_cp_decode(") < \
        main.index('done("14")') < main.index("roofline_readings(") < \
        main.index("add_cp_entries(")
    job = cs.cp_job_for([[1.0, 1.0]] * 32)
    assert job["cfg"].num_layers == 4 and job["cfg"].d_model == 4096
    assert (job["batch"], job["width"], job["mesh"]) == (
        8, 32768, {"data": 2, "model": 2})
    assert [p for p, _ in job["steps"]] == [1000, 16381, 16382, 16383,
                                            16384, 16385, 16386]


# ---------------------------------------------------------------------------
# phase 15: dense decode on a mesh for every block kind
# ---------------------------------------------------------------------------

def _small(arch, **kw):
    import dataclasses
    from repro_torch.config import get_model_config, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_model_config(arch)),
                               dtype="bfloat16", param_dtype="bfloat16",
                               **kw)


def test_phase15_alone_on_reduced_bf16_models_and_cpu_ranks(cs,
                                                             monkeypatch):
    """Phase 15 spawned alone on the CPU (``phase_mesh_decode`` with no
    ranks' results: one spawn of four gloo ranks runs every job): reduced
    bf16 xlstm-125m (3 layers), hymba-1.5b, whisper-small and qwen3-moe
    (2 layers), each held by ``decode_gate`` to its one-device run."""
    import sys
    torch = pytest.importorskip("torch")
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    configs = {"xlstm-125m": (_small("xlstm-125m", num_layers=3), None),
               "hymba-1.5b": (_small("hymba-1.5b"), None),
               "whisper-small": (_small("whisper-small"), None),
               "qwen3-moe-30b-a3b": (_small("qwen3-moe-30b-a3b"), None)}
    runs = {arch: (_decode_job(cs, arch, cfg), None)
            for arch, (cfg, _) in configs.items()}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dec = cs.phase_mesh_decode(runs, device="cpu")
    finally:
        torch.set_num_threads(n)
    _check_decode(cs, dec, configs)
    assert dec["models"]["whisper-small"]["collectives_a_step"][0][
        "all_gather"] > 0


def _decode_case(cs):
    """A faked phase 15 run of a reduced bf16 hymba (2 layers, B=4 on 96
    positions at (2, 2)): the one-device results and four ranks' that
    pass ``decode_gate`` (each rank's slices of the same values)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import (flatten, is_logical_leaf,
                                            is_spec, local_shape,
                                            param_sharding_tree)
    cfg = _small("hymba-1.5b")
    job = cs.decode_job_for("hymba-1.5b", cfg, batch=4, width=96,
                            positions=(46, 48))
    rng = np.random.default_rng(0)
    logits = [rng.normal(size=(4, 256)).astype(np.float32) for _ in range(2)]
    logits[0][:, 0] += 50           # clear top-1 margins
    kv = {pos: [tuple(rng.normal(size=(4, 2, 16)).astype(np.float32)
                      for _ in range(2)) for _ in range(2)]
          for pos in (46, 48)}
    di = cfg.q_dim
    states = [(li, name, rng.normal(size=shape).astype(np.float32))
              for li in range(2) for name, shape in (
                  ("MambaState.h", (4, di, 16)),
                  ("MambaState.conv", (4, 3, di)))]
    ref = {"logits": [torch.from_numpy(x) for x in logits],
           "written": {p: [tuple(torch.from_numpy(t) for t in layer)
                           for layer in layers] for p, layers in kv.items()},
           "states": [(li, name, torch.from_numpy(x))
                      for li, name, x in states],
           "wall_s": 0.1, "launches": 4, "fastattn_launches": 0,
           "gate": 0.05, "rule": "LOGIT_TOL", "change": 0.01}
    # a MoE block's records (the gate checks them wherever ref has them)
    moe = [rng.normal(size=(4, 32)).astype(np.float32) for _ in range(2)]
    ref["moe"] = [[{"plain": torch.from_numpy(x[2 * (r // 2):][:2]),
                    "flips": r % 2, "choices": 4} for x in moe]
                  for r in range(4)]
    logical = build_model(cfg, "cpu").cache_logical(4, 96)

    def ranks(**bad):
        out = []
        for r in range(4):
            d, m = divmod(r, 2)
            rows = slice(2 * d, 2 * d + 2)
            mesh = make_mesh((2, 2), ("data", "model"), r)
            specs = flatten(param_sharding_tree(logical, mesh), is_spec)
            pos = 46 if m == 0 else 48
            half = slice(m * di // 2, (m + 1) * di // 2)
            res = {"coords": {"data": d, "model": m},
                   "shapes": [local_shape(shape, sp, mesh) for (_, shape), sp
                              in zip(flatten(logical, is_logical_leaf),
                                     specs)],
                   "logits": [x[rows].copy() for x in logits],
                   "launches": 4, "lse_calls": 4, "fastattn_launches": 0,
                   "plain_cuda": 0,
                   "written": {pos: [tuple(t[rows].copy() for t in layer)
                                     for layer in kv[pos]]},
                   "states": [x[rows][:, half].copy()
                              if name.endswith(".h")
                              else x[rows][:, :, half].copy()
                              for _, name, x in states],
                   "moe": [(x[rows].copy(), x[rows].copy()) for x in moe],
                   "wall_s": [0.1, 0.1], "job_s": 1.0, "peak_gb": 1.0,
                   "merges": {"all_reduce": 8, "bytes": 800},
                   "collectives": {"all_gather": 32, "bytes": 3200}}
            if r == 3:
                for k, v in bad.items():
                    res[k] = v(res) if callable(v) else v
            out.append(res)
        return out
    return job, ref, ranks


def test_phase15_gate_rejects_faked_failures(cs):
    np = pytest.importorskip("numpy")
    pytest.importorskip("torch")
    job, ref, ranks = _decode_case(cs)
    out = cs.decode_gate("ok", ranks(), ref, job, on_card=True)
    assert out["written_worst"] == [0.0] * 4
    assert out["state_worst"] == [0.0] * 4
    assert out["moe_worst"] == [0.0] * 4
    assert out["moe_flips"] == [0, 2, 0, 2]
    assert out["moe_choices"] == [8] * 4
    without = {k: v for k, v in ref.items() if k != "moe"}
    assert cs.decode_gate("no moe", ranks(), without, job,
                          on_card=True)["moe_worst"] == []

    def off_logits(res):
        return [x + 100.0 for x in res["logits"]]

    def one_ulp(res):
        return [x + np.float32(1e-3) for x in res["logits"]]

    def off_rows(res):
        return {48: [(res["written"][48][0][0] + 1.0,
                      res["written"][48][0][1]), res["written"][48][1]]}

    def off_state(res):
        return res["states"][:3] + [res["states"][3] * 1.5]

    def whole_state(res):
        return res["states"][:1] + [np.concatenate(
            [res["states"][1]] * 2, axis=2)] + res["states"][2:]

    def off_moe(res):
        return [res["moe"][0], (res["moe"][1][0], res["moe"][1][1] + 1.0)]

    def wrong_shape(res):
        return [tuple(s[:1]) + (s[1] * 2,) + tuple(s[2:])
                for s in res["shapes"]]
    for bad, match in ((dict(shapes=wrong_shape), "rule table"),
                       (dict(launches=3), "launched"),
                       (dict(lse_calls=3), "launched"),
                       (dict(fastattn_launches=1), "launched"),
                       (dict(plain_cuda=1), "plain attention"),
                       (dict(logits=off_logits), "logits differ"),
                       (dict(logits=one_ulp), "model group"),
                       (dict(written={46: ranks()[0]["written"][46]}),
                        "owns"),
                       (dict(written=off_rows), "KV layer 0 k.*bf16 bound"),
                       (dict(states=off_state),
                        "layer 1 MambaState.conv.*bf16 bound"),
                       (dict(states=whole_state),
                        "layer 0 MambaState.conv.*bf16 bound"),
                       (dict(states=lambda res: res["states"][:3]),
                        "state leaves"),
                       (dict(moe=off_moe), "last MoE block at 48.*bf16 bound"),
                       (dict(moe=lambda res: res["moe"][:1]),
                        "MoE block records")):
        with pytest.raises((AssertionError, RuntimeError), match=match):
            cs.decode_gate("bad", ranks(**bad), ref, job, on_card=True)
    # the CPU's plain path launches nothing
    with pytest.raises(AssertionError, match="launched"):
        cs.decode_gate("cpu", ranks(), ref, job, on_card=False)
    # a measured gate lets logits through that LOGIT_TOL would not
    loose = dict(ref, gate=0.5)
    near = [x * 1.1 for x in ranks()[0]["logits"]]
    with pytest.raises(AssertionError, match="logits differ"):
        cs.decode_gate("tight", ranks(logits=near), ref, job, on_card=True)
    with pytest.raises(AssertionError, match="model group"):
        cs.decode_gate("loose", ranks(logits=near), loose, job,
                       on_card=True)


def test_phase15_measured_gate_and_launches(cs):
    assert cs.hymba_gate(0.01) == (cs.LOGIT_TOL, "LOGIT_TOL")
    assert cs.hymba_gate(0.2) == (0.4, "G")
    from repro_torch.config import get_model_config
    want = {arch: cs.decode_expected(get_model_config(arch), 4, True)
            for arch in ("xlstm-125m", "whisper-small")}
    assert want["whisper-small"] == {"lse_calls": 48, "flash_decode": 48,
                                     "fastattn_fwd": 48}
    cut = cs.decode_expected(_small("xlstm-125m", num_layers=3), 4, True)
    assert cut == {"lse_calls": 0, "flash_decode": 0, "fastattn_fwd": 0}
    hymba = cs.decode_expected(_small("hymba-1.5b"), 6, False)
    assert hymba == {"lse_calls": 12, "flash_decode": 0, "fastattn_fwd": 0}


def test_phase15_cache_pieces_are_the_whole_caches_slices(cs):
    """A rank's slice of every leaf drawn alone equals the one-device
    cache's (``decode_fill``): rows, KV positions and state channels."""
    torch = pytest.importorskip("torch")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import (axis_rules, flatten, is_spec,
                                            param_sharding_tree, shard_of)
    from repro_torch.training import tree
    for arch, cfg in (("hymba-1.5b", _small("hymba-1.5b")),
                      ("xlstm-125m", _small("xlstm-125m", num_layers=3))):
        job = _decode_job(cs, arch, cfg)
        model = build_model(cfg, "cpu")
        whole = model.init_cache(4, job["width"])
        cs.decode_fill(job, model, whole)
        for r in range(4):
            mesh = make_mesh((2, 2), ("data", "model"), r)
            with axis_rules(mesh=mesh):
                mine = model.init_cache(4, job["width"])
            cs.decode_fill(job, model, mine, mesh.coords)
            specs = param_sharding_tree(model.cache_logical(
                4, job["width"]), mesh)
            for t, w, sp in zip(tree.leaves(mine), tree.leaves(whole),
                                flatten(specs, is_spec), strict=True):
                assert torch.equal(t, shard_of(w, sp, mesh)), (arch, r)
        leaves = [t for t in tree.leaves(whole) if t.numel()]
        assert all(t.float().std().item() > 0.5 for t in leaves)


def test_phase2_slice_cases_cover_phase15s_shapes(cs):
    """Phase 2 holds flash_decode's slice and log-sum-exp at phase 15's
    head shapes, each on a (2, 2) rank's second slice."""
    keys = {pre: cs.slice_keys(kw["lens"], kw["kv_start"], kw["s"],
                               kw.get("window")).tolist()
            for pre, (_, kw) in cs.CP_SLICE_CASES.items()}
    cases = {pre: kw for pre, (_, kw) in cs.CP_SLICE_CASES.items()}
    h, m, w = cases["cp_hymba"], cases["cp_moe"], cases["cp_whisper"]
    assert (h["hq"], h["hkv"], h["d"], h["window"], h["s"], h["kv_start"]) \
        == (25, 5, 64, 1024, 4096, 4096)
    assert keys["cp_hymba"] == [1024] * 4
    assert (m["hq"], m["hkv"], m["d"], m["s"], m["kv_start"]) == (
        32, 4, 128, 2048, 2048) and keys["cp_moe"] == [2048] * 4
    assert (w["hq"], w["hkv"], w["d"], w["s"], w["kv_start"]) == (
        12, 12, 64, 224, 224) and keys["cp_whisper"] == [224] * 4
    width, positions = cs.MESH_DECODE["hymba-1.5b"]
    assert (width, h["lens"][0] - 1) == (2 * h["s"], positions[-1])


def test_kernels_line_gains_mesh_decode_entries(cs):
    kernels = [{"name": n} for n in ("fastattn_fwd", "flash_decode")]
    cs.add_mesh_decode_entries(kernels, {"models": {
        "hymba-1.5b": {"launches": [12] * 4, "lse_calls": [12] * 4,
                       "fastattn_launches": [0] * 4},
        "whisper-small": {"launches": [8] * 4, "lse_calls": [8] * 4,
                          "fastattn_launches": [8] * 4}}})
    k = {e["name"]: e for e in kernels}
    assert k["flash_decode"]["mesh_decode_launches"] == {
        "hymba-1.5b": [12] * 4, "whisper-small": [8] * 4}
    assert k["flash_decode"]["mesh_decode_lse_calls"]["hymba-1.5b"] == \
        [12] * 4
    assert k["fastattn_fwd"]["mesh_decode_launches"] == {
        "whisper-small": [8] * 4}


def test_phase15_rides_phase12_and_8h_and_runs_after_14(cs):
    """On the card phase 15's ranks run in phase 12's spawn (xlstm-125m,
    hymba-1.5b, whisper-small) and phase 8 (h)'s (qwen3-moe) after their
    training jobs; the one-device runs and the gates after phase 14."""
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index("phase_moe_parallel(") < main.index("phase_mesh()") \
        < main.index('done("14")') < main.index("phase_mesh_decode(") < \
        main.index('done("15")') < main.index("add_mesh_decode_entries(")
    assert 'mesh.pop("decode")' in main and \
        'moe_par.pop("decode")' in main
    assert "_decode_job(mesh" in inspect.getsource(cs._mesh_models_rank)
    assert "_decode_job(mesh" in inspect.getsource(cs._dist_rank)
    assert "decode=job" in inspect.getsource(cs.phase_moe_parallel)
    assert set(cs.MESH_DECODE) == set(cs.MESH_MODELS) | {cs.MOE_ARCH}
    hymba = cs.MESH_DECODE["hymba-1.5b"]
    assert hymba[0] == 8192 and min(hymba[1]) < 4096 <= max(hymba[1])
    assert max(hymba[1]) + 1 - 1024 > 4096       # slice 0 out of the window
    assert cs.MESH_DECODE["whisper-small"][0] == 448
    assert cs.MESH_DECODE["qwen3-moe-30b-a3b"][0] == 4096
    assert cs.MESH_DECODE_BATCH == 8


def _dryrun_cells():
    """Phase 16 (b)'s three cells, reduced in size and run at (2, 2): a
    dense decode, hymba's one row and a dense training step."""
    from repro_torch.config import (ShapeConfig, get_model_config,
                                    reduce_for_smoke)
    qwen = reduce_for_smoke(get_model_config("qwen2.5-32b"))
    hymba = reduce_for_smoke(get_model_config("hymba-1.5b"))
    return [(qwen, ShapeConfig("decode_r", 64, 8, "decode"), (10, 11, 12)),
            (hymba, ShapeConfig("long_r", 64, 1, "decode"), (10, 11)),
            (qwen, ShapeConfig("train_r", 32, 8, "train"), ())]


def test_phase16_on_reduced_cells_and_the_cpu(cs, monkeypatch):
    """Phase 16 on the CPU: (a) the whole dry run in process (64 ok
    cells, JAX's 16 skipped, no error) beside (b) three spawned
    processes, each rank 0 of a fake world of four, that run reduced
    versions of the card's cells: each step's collectives are the
    record's (times the decode steps), every attention layer's local
    decode asked for the log-sum-exp, no plain attention on CUDA."""
    import sys
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    out = cs.phase_dryrun("cpu", _dryrun_cells(), dict(data=2, model=2))
    assert {k: out["a"][k] for k in ("ok", "skipped", "error")} == \
        {"ok": 64, "skipped": 16, "error": 0}
    b = out["b"]
    assert list(b) == ["qwen2.5-32b decode_r", "hymba-1.5b long_r",
                       "qwen2.5-32b train_r"]
    assert b["qwen2.5-32b decode_r"]["launches"] == {"lse_calls": 2 * 3,
                                                     "plain_cuda": 0}
    assert b["hymba-1.5b long_r"]["launches"]["lse_calls"] == 2 * 2
    merges = b["hymba-1.5b long_r"]["collectives"]["merge"]
    assert merges["all_reduce"] == 2 * 2 * 2
    train = b["qwen2.5-32b train_r"]["collectives"]["sharding"]
    assert train["reduce_scatter"] > 0 and train["all_reduce"] > 0
    assert all(r["grown_bytes"] is None for r in b.values())


def test_dryrun_gate_rejects_faked_failures(cs):
    """``dryrun_gate`` fails a step whose collectives are not the
    record's, a launch count off by one, plain attention on CUDA, state
    bytes outside the allocator's rounding of the count, and a peak at
    the card's 80 GB."""
    from repro_torch.config import get_model_config
    cfg = get_model_config("qwen2.5-32b")
    coll = {"sharding": {"all_gather": 450, "reduce_scatter": 0,
                         "all_reduce": 0, "ppermute": 0, "bytes": 10},
            "merge": {"all_reduce": 128, "bytes": 20}}
    mem = {"param_bytes": 1000, "opt_bytes": 0, "cache_bytes": 24,
           "argument_bytes": 1030, "activation_bytes_estimate": 5}
    ok = {"memory": mem, "collectives": coll, "steps": 2,
          "tensors": (3, 1), "grown": 1024 + 512, "requested": 1024,
          "wall_s": 0.1, "peak": 2000,
          "counts": {p: {k: 2 * v for k, v in c.items()}
                     for p, c in coll.items()},
          "flash_decode": 128, "fastattn_fwd": 0, "lse_calls": 128,
          "plain_cuda": 0}
    got = cs.dryrun_gate("ok", ok, cfg, "decode", True)
    assert got["launches"]["flash_decode"] == 128
    bad = [dict(ok, counts={**ok["counts"], "merge": coll["merge"]}),
           dict(ok, flash_decode=127), dict(ok, plain_cuda=1),
           dict(ok, grown=1023), dict(ok, requested=1025),
           dict(ok, grown=1024 + 3 * 512 + (1 << 20) + 1),
           dict(ok, peak=int(80e9))]
    for res in bad:
        with pytest.raises(AssertionError):
            cs.dryrun_gate("bad", res, cfg, "decode", True)


def test_phase16_runs_after_15_and_enters_the_kernels_line(cs):
    import inspect
    main = inspect.getsource(cs.main)
    assert main.index('done("15")') < main.index("phase_dryrun()") < \
        main.index('done("16")') < main.index("add_dryrun_entries(")
    assert [(a, s) for a, s, _ in cs.DRYRUN_CELLS] == [
        ("qwen2.5-32b", "decode_32k"), ("hymba-1.5b", "long_500k"),
        ("qwen2.5-32b", "train_4k")]
    assert cs.DRYRUN_MESH == dict(data=16, model=16)
    kernels = [{"name": "flash_decode"}, {"name": "fastattn_fwd"}]
    run = {"b": {"q d": {"launches": {"flash_decode": 256}},
                 "q t": {"launches": {"fastattn_fwd": 128}}}}
    cs.add_dryrun_entries(kernels, run)
    assert kernels[0]["dryrun_launches"] == {"q d": 256}
    assert kernels[1]["dryrun_launches"] == {"q t": 128}
