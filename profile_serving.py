#!/usr/bin/env python3
"""Where the time goes in the port's serving path on one GPU.

    python3 profile_serving.py [--out chiprun_out/profile]

Serves the ``chip_smoke.py`` workload (llama2-7b at full width and depth,
bf16, random weights from seed 0; 12 greedy requests of 37-1800 prompt
tokens, 32 new tokens each) once to warm up, then twice more under
``torch.profiler`` (kernel tracing only), each window also timed once
without the profiler to show what tracing costs:

* the whole workload -- the device's busy and idle share over the run;
* a steady decode window -- 8 running sequences of 37-token prompts, 10
  decode steps, no prefill in the window.

For each window it prints the wall time, the summed device time of all
kernels, the idle share (1 - kernel time / wall time; kernels run on one
stream, so they do not overlap) and the kernels by total device time,
grouped into the port's attention kernels, matrix products and the rest.
The steady-decode Chrome trace and a JSON summary go to ``--out``.
Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _group(name: str) -> str:
    n = name.lower()
    if "paged_decode_kernel" in n:
        return "attention: paged_decode.cu"
    if "paged_prefill_kernel" in n:
        return "attention: paged_prefill.cu"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "cutlass", "sm90_",
                            "cublas")):
        return "matrix products (cuBLAS)"
    if "index_put" in n or "indexing" in n or "scatter" in n:
        return "pool writes / indexing"
    if "reduce" in n:
        return "reductions (norms, argmax, isfinite)"
    if "copy" in n or "memcpy" in n or "memset" in n:
        return "copies / casts"
    return "elementwise and other"


def summarize(prof, wall_s: float, label: str) -> dict:
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type is not None
               and "cuda" in str(e.device_type).lower()]
    total_us = sum(_device_us(e) for e in kernels)
    groups = defaultdict(float)
    for e in kernels:
        groups[_group(e.key)] += _device_us(e)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    out = {"window": label, "wall_s": wall_s,
           "kernel_s": total_us / 1e6,
           "idle_share": (1.0 - total_us / 1e6 / wall_s) if total_us
           else None,
           "groups_s": {k: v / 1e6 for k, v in sorted(
               groups.items(), key=lambda kv: -kv[1])},
           "top": [{"name": e.key[:90], "calls": e.count,
                    "device_s": _device_us(e) / 1e6} for e in top]}
    print(f"== {label}: wall {wall_s:.3f}s, kernels {out['kernel_s']:.3f}s"
          f", idle share {out['idle_share']}", flush=True)
    for k, v in out["groups_s"].items():
        print(f"   {v:9.4f}s  {k}")
    for t in out["top"]:
        print(f"   {t['device_s']:9.4f}s  {t['calls']:6d}x  {t['name']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.config import ServeConfig, get_model_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.serving.core import EngineCore
    from repro_torch.serving.scheduler import RUNNING, SamplingParams

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    build.build_all()
    cfg = get_model_config("llama2-7b")
    model = build_model(cfg, device="cuda")
    params = model.init(model.generator(0))
    serve = ServeConfig(max_batch=8, max_seq_len=2048, page_size=128,
                        prefill_chunk=512)
    rng = np.random.default_rng(0)
    lens = rng.integers(37, 1801, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]

    def workload(core, max_new=32):
        for p in prompts:
            core.add_request(p, SamplingParams(max_new_tokens=max_new))
        while core.has_work:
            core.step()
        torch.cuda.synchronize()

    core = EngineCore(model, params, cfg, serve, device="cuda")
    workload(core)                                   # warm-up
    t0 = time.perf_counter()
    workload(core)
    plain_wall = time.perf_counter() - t0
    acts = [ProfilerActivity.CUDA]      # kernel tracing only: least overhead
    results = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        workload(core)
        wall = time.perf_counter() - t0
    results.append(summarize(prof, wall, "whole workload (12 requests)"))
    results[-1]["unprofiled_wall_s"] = plain_wall

    short = [rng.integers(0, cfg.vocab_size, size=37) for _ in range(8)]
    for p in short:
        core.add_request(p, SamplingParams(max_new_tokens=40))
    while not all(r is not None and r.state == RUNNING
                  for r in core.sched.slots):
        core.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        core.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            core.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(out_dir / "decode_steady.json"))
    results.append(summarize(prof, wall, "steady decode (8 slots, 10 steps)"))
    results[-1]["unprofiled_wall_s"] = plain_wall
    while core.has_work:
        core.step()
    (out_dir / "summary.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "windows": [{k: r[k] for k in (
                          "window", "wall_s", "unprofiled_wall_s",
                          "kernel_s", "idle_share")} for r in results]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
