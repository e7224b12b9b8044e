#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build, check, serve.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository's
``src/repro_torch`` package; it imports nothing of JAX.  Phases, each of
which raises on failure (the script then exits non-zero):

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel of the port from ``src/repro_torch/**/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of llama2-7b's and gemma2-2b's serving path and at page size 16
   in float32, with the maximum absolute error held to a stated tolerance;
   the median time of 20 launches beside the least time the card could
   take (its bound), the plain version's time and, where one PyTorch call
   computes the same function, that call's time (``library_ms``:
   ``scaled_dot_product_attention`` on the pre-gathered dense view, the
   gather excluded; the port never calls it).
3. Serving: an ``EngineCore`` on llama2-7b at full width and depth (bf16,
   random weights from a seeded CUDA generator) answers 12 greedy
   requests of 37-1800 prompt tokens with 32 new tokens each.  Both
   kernels' launch counts must be above 0, no page may leak, and the
   first request's first chunk and one decode step must agree with the
   plain attention path within a stated tolerance.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12           # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # FP32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# bf16 outputs: kernel and plain version both accumulate in f32 and
# round once to bf16 (2^-8 relative); inputs are N(0, 1), outputs |o| < 4.
# f32: only the summation order differs.


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` launches (CUDA events
    around each launch, after ``warmup`` untimed launches)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------

def phase_card_and_build() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] {len(report)} kernels in {time.perf_counter() - t0:.1f}s "
        "(nvcc in parallel)")
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.1f}s"
            f"{' (cached)' if r['cached'] else ''}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    return report


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pools(gen, hkv, num_pages, ps, d, dtype):
    import torch
    shape = (hkv, num_pages, ps, d)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def _tables(rng, b, n_kv, num_pages):
    """Scrambled page tables: every sequence owns distinct pages spread
    over the pool (page 0 is the scratch page)."""
    import numpy as np
    perm = rng.permutation(np.arange(1, num_pages))[:b * n_kv]
    return perm.reshape(b, n_kv).astype(np.int32)


def _report(kind: str, name: str, res: dict) -> None:
    lib = ("n/a (no single PyTorch call applies a softcap or window)"
           if res["library_ms"] is None else
           f"{res['library_ms']:.4f} ms (scaled_dot_product_attention on the "
           "gathered view, gather excluded)")
    log(f"[{kind}] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), library {lib}")


def decode_case(name, *, b, hq, hkv, d, ps, n_kv, dtype, window=None,
                softcap=None, seed=0, idle_row=True, library=True):
    """paged_flash_decode vs paged_decode_reference on one shape.  With
    ``idle_row`` the last row is an idle engine slot: all-scratch table
    row and kv_len 1."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    from repro_torch.kernels.flash_decode.ref import (paged_decode_reference,
                                                      paged_gather)
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    num_pages = b * n_kv + 8
    kp, vp = _pools(gen, hkv, num_pages, ps, d, tdt)
    table = _tables(rng, b, n_kv, num_pages)
    lens = rng.integers(1, n_kv * ps + 1, size=b).astype(np.int32)
    lens[0] = n_kv * ps                              # one full-length row
    if idle_row:
        table[-1] = 0
        lens[-1] = 1
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(tdt)
    table_t = torch.from_numpy(table).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    kw = dict(window=window, softcap=softcap)

    def kernel():
        return paged_flash_decode(q, kp, vp, table_t, lens_t, **kw)

    def plain():
        return paged_decode_reference(q[:, :, None], kp, vp, table_t,
                                      lens_t, **kw)[:, :, 0]

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    log(f"[decode] {name}: max_abs_err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")

    # work this data needs: each valid K/V row read once per kv head
    keys = np.minimum(lens, window) if window else lens
    esize = torch.empty((), dtype=tdt).element_size()
    n_bytes = (2 * hkv * int(keys.sum()) * d + 2 * b * hq * d) * esize \
        + table.nbytes + lens.nbytes
    n_ops = 4.0 * (hq // hkv) * hkv * int(keys.sum()) * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "ms": time_ms(kernel), "plain_ms": time_ms(plain,
                                                                 reps=5),
           "bound_ms": bnd, "bound_by": by, "library_ms": None}
    if library and window is None and softcap is None:
        kd = paged_gather(kp, table_t)
        vd = paged_gather(vp, table_t)
        pos = torch.arange(kd.shape[2], device="cuda")
        mask = (pos[None, :] < lens_t[:, None].long())[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask,
                enable_gqa=hq != hkv)
        res["library_ms"] = time_ms(lib)
    _report("decode", name, res)
    return res


def prefill_case(name, *, hq, hkv, d, ps, n_kv, chunk, dtype, starts,
                 nvalid, window=None, softcap=None, seed=0, library=True):
    """fastattn_paged_prefill vs paged_prefill_reference on one launch of
    ``len(starts)`` rows.  A row with n_valid 0 is a padded batch row:
    all-scratch table row, pos_start 0, kv_len 0 -- its output must be
    exactly 0."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fastattn.ops import fastattn_paged_prefill
    from repro_torch.kernels.fastattn.ref import paged_prefill_reference
    from repro_torch.kernels.flash_decode.ref import paged_gather
    tdt = getattr(torch, dtype)
    b = len(starts)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    num_pages = b * n_kv + 8
    kp, vp = _pools(gen, hkv, num_pages, ps, d, tdt)
    table = _tables(rng, b, n_kv, num_pages)
    starts = np.asarray(starts, np.int32)
    nvalid = np.asarray(nvalid, np.int32)
    table[nvalid == 0] = 0
    lens = starts + nvalid
    q = torch.randn((b, hq, chunk, d), generator=gen, device="cuda").to(tdt)
    table_t = torch.from_numpy(table).cuda()
    starts_t = torch.from_numpy(starts).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    kw = dict(window=window, softcap=softcap)

    def kernel():
        return fastattn_paged_prefill(q, kp, vp, table_t, starts_t, lens_t,
                                      **kw)

    def plain():
        return paged_prefill_reference(q, kp, vp, table_t, starts_t, lens_t,
                                       **kw)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = 0.0
    for i in range(b):
        n = int(nvalid[i])
        if n == 0:
            if out[i].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: padded row {i} is not 0")
            continue
        e = (out[i, :, :n].float() - ref[i, :, :n].float()).abs().max()
        err = max(err, e.item())
    tol = TOL[dtype]
    log(f"[prefill] {name}: max_abs_err {err:.3e} (tol {tol:g}), padded "
        "rows exactly 0")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")

    # work this data needs: valid (row, key) pairs of the valid rows, and
    # every key any valid row sees read once per kv head
    pairs, keys_read = 0, 0
    for i in range(b):
        n = int(nvalid[i])
        if n == 0:
            continue
        rows = starts[i] + np.arange(n)
        lo = np.maximum(rows - window + 1, 0) if window else np.zeros_like(
            rows)
        pairs += int((rows + 1 - lo).sum())
        keys_read += int(lens[i] - lo.min())
    esize = torch.empty((), dtype=tdt).element_size()
    n_valid_rows = int(nvalid.sum())
    n_bytes = (2 * hkv * keys_read * d + 2 * hq * n_valid_rows * d) * esize \
        + table.nbytes + starts.nbytes + lens.nbytes
    n_ops = 4.0 * hq * pairs * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None}
    if library and window is None and softcap is None:
        kd = paged_gather(kp, table_t)
        vd = paged_gather(vp, table_t)
        cols = torch.arange(kd.shape[2], device="cuda")
        rows = starts_t[:, None].long() + torch.arange(chunk, device="cuda")
        mask = ((cols[None, None, :] <= rows[:, :, None])
                & (cols[None, None, :] < lens_t[:, None, None].long()))
        mask = mask[:, None]

        def lib():
            return F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask, enable_gqa=hq != hkv)
        res["library_ms"] = time_ms(lib)
    _report("prefill", name, res)
    return res


def phase_kernels() -> dict:
    """Every kernel against its plain version.  Returns the main-path
    (llama2-7b) numbers of each kernel."""
    dec = decode_case("llama2-7b B=8 H=32/32 D=128 bf16 ps=128",
                      b=8, hq=32, hkv=32, d=128, ps=128, n_kv=16,
                      dtype="bfloat16")
    decode_case("gemma2-2b B=8 H=8/4 D=256 bf16 ps=128 window=256 cap=50",
                b=8, hq=8, hkv=4, d=256, ps=128, n_kv=16, dtype="bfloat16",
                window=256, softcap=50.0, seed=1)
    decode_case("ps=16 f32 B=4 H=8/2 D=128 window=100 cap=30",
                b=4, hq=8, hkv=2, d=128, ps=16, n_kv=24, dtype="float32",
                window=100, softcap=30.0, seed=2)
    pre = prefill_case("llama2-7b B=4 chunk=512 H=32/32 D=128 bf16 ps=128",
                       hq=32, hkv=32, d=128, ps=128, n_kv=16, chunk=512,
                       dtype="bfloat16", starts=[0, 512, 1024, 0],
                       nvalid=[512, 300, 512, 0])
    prefill_case("gemma2-2b B=4 chunk=512 H=8/4 D=256 bf16 window=256 "
                 "cap=50", hq=8, hkv=4, d=256, ps=128, n_kv=16, chunk=512,
                 dtype="bfloat16", starts=[0, 512, 1536, 0],
                 nvalid=[512, 37, 512, 0], window=256, softcap=50.0, seed=1)
    prefill_case("ps=16 f32 chunk=64 H=8/2 D=128 window=40 cap=30",
                 hq=8, hkv=2, d=128, ps=16, n_kv=12, chunk=64,
                 dtype="float32", starts=[0, 64, 100, 0],
                 nvalid=[64, 64, 20, 0], window=40, softcap=30.0, seed=2)
    return {"paged_decode": dec, "paged_prefill": pre}


# ---------------------------------------------------------------------------
# phase 3: serving llama2-7b
# ---------------------------------------------------------------------------

def phase_serving(n_requests: int = 12, new_tokens: int = 32) -> dict:
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig, get_model_config
    from repro_torch.kernels.fastattn.ops import fastattn_paged_prefill
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    from repro_torch.models import build_model
    from repro_torch.serving.core import EngineCore
    from repro_torch.serving.scheduler import FINISHED, SamplingParams

    cfg = get_model_config("llama2-7b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.2f}B params ({cfg.param_dtype}) "
        f"initialised in {time.perf_counter() - t0:.1f}s")
    serve = ServeConfig(max_batch=8, max_seq_len=2048, page_size=128,
                        prefill_chunk=512)
    core = _make_timed_core()(model, params, cfg, serve, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(37, 1801, size=n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    greedy = SamplingParams(max_new_tokens=new_tokens)

    paged_flash_decode.launches = 0
    fastattn_paged_prefill.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = [core.add_request(p, greedy) for p in prompts]
    tokens = {i: [] for i in ids}
    while core.has_work:
        for ev in core.step():
            if ev.kind != "token":
                raise AssertionError(f"request {ev.request_id}: {ev}")
            tokens[ev.request_id].append(ev.token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": paged_flash_decode.launches,
                "paged_prefill": fastattn_paged_prefill.launches}
    stats = core.stats()
    log(f"[serve] launches on the main path: {launches}")
    for rid, req_len in zip(ids, lens):
        toks = tokens[rid]
        if len(toks) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    if stats["finished"] != n_requests or any(
            r.state != FINISHED for r in core.sched.finished):
        raise AssertionError("a request did not finish")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if stats["pages_used"] != 0:
        raise AssertionError(f"{stats['pages_used']} pages leaked")
    pre_s, dec_s = core.device_seconds()
    n_prompt = int(lens.sum())
    n_decode = n_requests * (new_tokens - 1)
    out = {"requests": n_requests, "prompt_tokens": n_prompt,
           "decode_tokens": n_decode, "steps": stats["steps"],
           "prefill_launches": stats["prefill_launches"],
           "decode_launches": stats["decode_launches"],
           "pages_peak": stats["pages_peak"], "pool_pages":
           serve.pool_pages(), "wall_s": wall,
           "prefill_device_s": pre_s, "decode_device_s": dec_s,
           "prefill_tok_s": n_prompt / pre_s,
           "decode_tok_s": n_decode / dec_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    log(f"[serve] {n_requests} requests ({n_prompt} prompt tokens, "
        f"{n_decode} decode tokens) in {stats['steps']} steps, "
        f"{wall:.2f}s wall; prefill {out['prefill_tok_s']:.0f} tok/s "
        f"({pre_s:.3f}s device), decode {out['decode_tok_s']:.1f} tok/s "
        f"({dec_s:.3f}s device); peak pages {stats['pages_peak']}/"
        f"{serve.pool_pages() - 1}; peak memory {out['peak_mem_gb']:.1f} GB")
    log("[serve] " + json.dumps({k: v for k, v in out.items()}))
    check_against_plain(model, params, prompts[0], tokens[ids[0]][0])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _make_timed_core():
    from repro_torch.serving.core import EngineCore

    class TimedCore(EngineCore):
        """EngineCore that brackets every prefill and decode launch with
        CUDA events, so their device time is read without extra
        synchronisation on the serving path."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._ev = {"prefill": [], "decode": []}

        def _timed(self, kind, fn, *args):
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self._ev[kind].append((start, end))
            return out

        def _prefill(self, *args):
            return self._timed("prefill", super()._prefill, *args)

        def _decode(self, *args):
            return self._timed("decode", super()._decode, *args)

        def device_seconds(self):
            import torch
            torch.cuda.synchronize()
            return tuple(sum(s.elapsed_time(e) for s, e in self._ev[k]) / 1e3
                         for k in ("prefill", "decode"))

    return TimedCore


def check_against_plain(model, params, prompt, first_token) -> None:
    """The first request's first chunk, then one decode step, through the
    kernels and through the plain attention path on fresh pools: the
    last-row logits must agree within LOGIT_TOL of the logits' scale, and
    the greedy tokens wherever the plain path's top-1 margin exceeds that
    tolerance."""
    import torch
    ps, chunk, n_kv = 128, 512, 16
    n = min(len(prompt), chunk)
    toks = torch.zeros((1, chunk), dtype=torch.int32, device="cuda")
    toks[0, :n] = torch.from_numpy(prompt[:n]).cuda()
    table = torch.zeros((1, n_kv), dtype=torch.int32, device="cuda")
    table[0, :8] = torch.arange(1, 9, dtype=torch.int32)
    z = torch.zeros((1,), dtype=torch.int32, device="cuda")
    nv = torch.full((1,), n, dtype=torch.int32, device="cuda")
    res = {}
    for impl in ("paged", "paged_reference"):
        pools = model.init_paged_cache(9, ps)
        logits, pools = model.prefill_chunk_paged(
            params, toks, pools, table, z, nv, impl=impl)
        last = logits[0, n - 1].float()
        tok = torch.argmax(last).to(torch.int32).reshape(1)
        dl, _ = model.decode_step_paged(params, tok, pools, table, nv,
                                        impl=impl)
        res[impl] = (last, dl[0].float())
    for what, i in (("prefill last row", 0), ("decode step", 1)):
        got, ref = res["paged"][i], res["paged_reference"][i]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite logits")
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        tol = LOGIT_TOL * scale
        top2 = torch.topk(ref, 2).values
        margin = (top2[0] - top2[1]).item()
        same = int(torch.argmax(got)) == int(torch.argmax(ref))
        log(f"[serve] kernels vs plain, {what}: max_abs_err {err:.4f} "
            f"(tol {tol:.4f} = {LOGIT_TOL} x max|logit| {scale:.3f}), "
            f"top-1 margin {margin:.4f}, same greedy token {same}")
        if not err <= tol:
            raise AssertionError(f"{what}: logits differ by {err} > {tol}")
        if margin > tol and not same:
            raise AssertionError(f"{what}: greedy tokens differ")
    if n == len(prompt) and int(torch.argmax(res["paged"][0])) != first_token:
        log("[serve] note: engine's first token differs from the fresh-pool "
            "rerun (batched launch rounding)")


# bf16 activations through 32 layers: the two attention paths round their
# outputs to bf16 at different points, so the logits drift by a few
# percent of their scale at most.
LOGIT_TOL = 0.05


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_card_and_build()
    kern = phase_kernels()
    served = phase_serving()
    sources = {"paged_decode": (
        "src/repro_torch/kernels/flash_decode/csrc/paged_decode.cu",
        "src/repro/kernels/flash_decode/kernel.py:171"),
        "paged_prefill": (
        "src/repro_torch/kernels/fastattn/csrc/paged_prefill.cu",
        "src/repro/kernels/fastattn/kernel.py:322")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1],
         "launches": served["launches"][name],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"]}
        for name in ("paged_prefill", "paged_decode")]}
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
