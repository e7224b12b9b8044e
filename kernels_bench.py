#!/usr/bin/env python3
"""Time the split-KV decode kernels (paged and dense) and the chunkwise
mLSTM kernel on one GPU, at the main paths' shapes, beside another
checkout's kernels.

    python3 kernels_bench.py [--parent DIR] [--sweep]

Needs one CUDA card and nvcc; imports nothing of JAX.  Each tree's
kernels run in a child process of their own, which imports that tree's
``src/repro_torch`` (built there at first use) and this tree's
``chip_smoke.py`` for its timing helpers.  Per case it prints, as one
JSON line each:

* ``ms``: median of 20 launches with CUDA events around each (the host's
  work between the events included, as ``chip_smoke.py``'s ``ms``);
* ``device_ms``: 20 launches queued behind a spin kernel
  (``torch.cuda._sleep``), events around the run: the card's time alone;
* ``host_us``: the host's time a call while the card is still busy (the
  least of 20 runs of 100 calls: the host's noise only adds);
* for the mLSTM, each CUDA kernel's device time a call (torch.profiler).

Cases: paged decode at llama2-7b's serving shape (B=8, H=32/32, D=128,
page 128, 16 pages a row, kv_len drawn as ``chip_smoke.py`` draws it) and
gemma2-2b's (B=8, H=8/4, D=256, window 256, softcap 50); dense decode
(``flash_decode``, "bshd" caches, bf16) at phase 3b's shape (llama2-7b
B=8, 161-token caches, kv_len 159), llama2-7b at B=1 on a 65536-token
cache, qwen2.5-32b's GQA 40/8 at B=2 on 32768 tokens and llama2-7b at
B=8 on ragged 4096-token caches; the mLSTM at
xlstm-125m's training shape (B=8, H=4, S=2048, dk=dv=384, bf16, the
model's (B, S, H, D) layout).  ``--parent DIR`` runs DIR's kernels and
this tree's in turns (parent, this, this, parent) in one call.
``--sweep`` times this tree's paged decode at several ``CTAS_PER_SM``
of the split planner, and its ``flash_decode`` at several
``DENSE_CTAS_PER_SM``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (this tree's timing helpers)


def host_us(fn, reps: int = 100, runs: int = 20) -> float:
    """The host's time a call, the least of ``runs`` runs of ``reps``
    calls (the host's noise only adds)."""
    import torch
    best = float("inf")
    for _ in range(runs):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)     # the card stays busy meanwhile
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / reps * 1e6


def decode_inputs(b, hq, hkv, d, ps, n_kv, seed):
    """The inputs of ``chip_smoke.decode_case`` with its default kv_len."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    num_pages = b * n_kv + 8
    kp, vp = cs._pools(gen, hkv, num_pages, ps, d, torch.bfloat16)
    table = cs._tables(rng, b, n_kv, num_pages)
    lens = rng.integers(1, n_kv * ps + 1, size=b)
    lens[0] = n_kv * ps
    lens[-1] = 1
    lens = lens.astype(np.int32)
    table[lens == 1] = 0
    q = torch.randn((b, hq, d), generator=gen, device="cuda").bfloat16()
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(lens).cuda())


DECODE = [("paged_decode llama2-7b B=8 H=32/32 D=128 ps=128",
           dict(b=8, hq=32, hkv=32, d=128, ps=128, n_kv=16, seed=0), {}),
          ("paged_decode gemma2-2b B=8 H=8/4 D=256 window=256 cap=50",
           dict(b=8, hq=8, hkv=4, d=256, ps=128, n_kv=16, seed=1),
           dict(window=256, softcap=50.0))]


def dense_inputs(b, hq, hkv, s, kv_len, seed, d=128):
    """q (B, Hq, D) and "bshd" caches (B, S, Hkv, D), N(0, 1) in bf16, and
    kv_len (B,): ``kv_len`` for every row, or a list of B lengths."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    k, v = (torch.randn((b, s, hkv, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    q = torch.randn((b, hq, d), generator=gen, device="cuda").bfloat16()
    lens = torch.tensor(kv_len if isinstance(kv_len, list) else [kv_len] * b,
                        dtype=torch.int32, device="cuda")
    return q, k, v, lens


DENSE = [("flash_decode phase 3b llama2-7b B=8 H=32/32 S=161 kv_len=159",
          dict(b=8, hq=32, hkv=32, s=161, kv_len=159, seed=0)),
         ("flash_decode llama2-7b B=1 H=32/32 S=65536",
          dict(b=1, hq=32, hkv=32, s=65536, kv_len=65536, seed=1)),
         ("flash_decode qwen2.5-32b B=2 H=40/8 S=32768",
          dict(b=2, hq=40, hkv=8, s=32768, kv_len=32768, seed=2)),
         # chip_smoke.py's ragged B=8 case: rows that fill the card by
         # count and are long, which the shape-only plan does not split
         ("flash_decode llama2-7b B=8 H=32/32 S=4096 ragged",
          dict(b=8, hq=32, hkv=32, s=4096, seed=3,
               kv_len=[4096, 2609, 2094, 1106, 1261, 168, 309, 1]))]


def child(tree: Path, sweep: bool) -> None:
    """Measure the cases with ``tree``'s kernels; print JSON lines."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import ops as dops
    from repro_torch.kernels.mlstm.ops import mlstm_chunkwise_fwd
    build.build_all(["paged_decode", "flash_decode", "mlstm_chunkwise"])
    tag = str(tree)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def emit(**kw):
        print(json.dumps({"tree": tag, **kw}), flush=True)

    for name, shape, kw in DECODE:
        args = decode_inputs(**shape)

        def fn():
            return dops.paged_flash_decode(*args, **kw)
        emit(case=name, ms=cs.time_ms(fn), device_ms=cs.device_ms(fn),
             host_us=host_us(fn))
    for name, shape in DENSE:
        args = dense_inputs(**shape)

        def fn():
            return dops.flash_decode(*args, layout="bshd")
        emit(case=name, ms=cs.time_ms(fn), device_ms=cs.device_ms(fn),
             host_us=host_us(fn))
        del args
    if sweep:
        planned = dops.CTAS_PER_SM, dops.DENSE_CTAS_PER_SM
        for ctas in (4, 8, 16, 32, 64):
            dops.CTAS_PER_SM = ctas
            dops.plan_splits.cache_clear()
            for name, shape, kw in DECODE:
                args = decode_inputs(**shape)
                split = dops.plan_splits(
                    shape["b"], shape["hkv"], shape["hq"] // shape["hkv"],
                    shape["n_kv"], shape["ps"], kw.get("window"), sms)
                emit(case=name, ctas_per_sm=ctas, split=list(split),
                     device_ms=cs.device_ms(
                         lambda: dops.paged_flash_decode(*args, **kw)))
        for ctas in (1, 1.5, 1.75, 1.9, 2, 3, 4, 8):
            dops.DENSE_CTAS_PER_SM = ctas
            dops.plan_dense_splits.cache_clear()
            for name, shape in DENSE:
                args = dense_inputs(**shape)
                split = dops.plan_dense_splits(
                    shape["b"], shape["hq"], shape["hkv"], shape["s"], None,
                    sms)
                emit(case=name, dense_ctas_per_sm=ctas, split=list(split),
                     device_ms=cs.device_ms(
                         lambda: dops.flash_decode(*args, layout="bshd")))
                del args
        dops.CTAS_PER_SM, dops.DENSE_CTAS_PER_SM = planned
        dops.plan_splits.cache_clear()
        dops.plan_dense_splits.cache_clear()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b, h, s, dk = 8, 4, 2048, 384
    q, k, v = (torch.randn((b, s, h, dk), generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)
               for _ in range(3))
    ig = torch.randn((b, h, s), generator=gen, device="cuda")
    fg = torch.randn((b, h, s), generator=gen, device="cuda") + 3.0

    def mlstm():
        return mlstm_chunkwise_fwd(q, k, v, ig, fg, chunk=128)
    name = "mlstm_chunkwise xlstm-125m B=8 H=4 S=2048 dk=dv=384 bf16"
    emit(case=name, ms=cs.time_ms(mlstm), device_ms=cs.device_ms(mlstm),
         host_us=host_us(mlstm))
    from torch.profiler import ProfilerActivity, profile
    mlstm()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            mlstm()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernel = re.search(r"mlstm_chunkwise_\w+", e.key)
        if us > 0 and kernel:
            per[kernel.group(0)] = us / 5 / 1e3
    emit(case=name, kernels_device_ms=per)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--tree", type=Path, default=None)
    args = ap.parse_args()
    if args.tree is not None:
        child(args.tree.resolve(), args.sweep)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernels_bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    trees = [ROOT]
    if args.parent is not None:
        trees = [args.parent, ROOT, ROOT, args.parent]
    for i, tree in enumerate(trees):
        cmd = [sys.executable, str(ROOT / "kernels_bench.py"), "--tree",
               str(tree)]
        if args.sweep and tree == ROOT and i == trees.index(ROOT):
            cmd.append("--sweep")
        subprocess.run(cmd, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
