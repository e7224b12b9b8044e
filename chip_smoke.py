#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build, check, serve, train,
offload, xLSTM.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository's
``src/repro_torch`` package; it imports nothing of JAX.  Phases, each of
which raises on failure (the script then exits non-zero):

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel of the port from ``src/repro_torch/**/csrc``; the
   ``-Xptxas -v`` log must show no spills in the tensor-core (``*_wgmma``)
   kernels and the dense decode kernel (``flash_decode_*``), and no
   serialized ``wgmma``.
2. Each kernel against its plain PyTorch version on the card, with the
   maximum absolute error held to a stated tolerance (the attention
   checks also hold each output row's error to that row's scale): the
   paged kernels at the shapes of llama2-7b's and gemma2-2b's serving
   path and at page size 16 in float32, qwen2.5-32b's GQA 40/8 at page
   size 16 in bf16 (ragged chunks, a padded row), and paged decode at its
   split-KV edges (``DECODE_CASES``: kv_len one below, at and one above a
   split, a window narrower than the table, 4096 keys in one sequence,
   only idle rows); ``fastattn_fwd`` at llama2-7b's training shape, a
   gemma2-2b band (GQA, window, softcap), a ragged case with a q_offset
   and a kv_valid tail in float32 and in bf16, and a non-causal case;
   ``flash_decode`` on dense caches (``DENSE_DECODE_CASES``, every
   (batch, head) row to its own scale) at llama2-7b's decode shape in both
   layouts, a gemma2-2b window/softcap case, a float32 case, llama2-7b
   at B=1 on a 65536-token cache (the kernels line's long shape) and on
   the paper's longest, 262144 tokens, qwen2.5-32b's GQA 40/8 at B=2 on
   32768 tokens, and its split-KV edges (kv_len one below, at and one
   above a split; a window narrower than a split); ``mlstm_chunkwise_fwd``
   (``MLSTM_CASES``) at xlstm-125m's training shape (the model's
   (B, S, H, D) projections read in place), a ragged float32 case, a
   sequence shorter than the chunk, 16 chunks at a small dk/dv, a ragged
   S over eight chunks and a forget bias of -2, h held to the plain
   version as an unbounded output and the float32 state (C, n, m) to 1e-3
   of its scale.  Each is timed (median of 20 launches, CUDA events
   around each: the wrapper's host work included) and on the device
   alone (``device_ms``: 20 launches queued behind a spin kernel) beside
   the least time the card could take (its bound), the plain version's
   time and, where one PyTorch call computes the same function, that
   call's time (``library_ms``: ``scaled_dot_product_attention``, with a
   gather, GQA expansion or layout copy excluded from the time; the port
   never calls it), its achieved TFLOP/s on this data's useful operations
   and its time over ``library_ms``.
3. Serving: an ``EngineCore`` on llama2-7b at full width and depth (bf16,
   random weights from a seeded CUDA generator) answers 12 greedy
   requests of 37-1800 prompt tokens with 32 new tokens each.  Both
   paged kernels' launch counts must be above 0, no page may leak, and
   the first request's first chunk and one decode step must agree with
   the plain attention path within a stated tolerance.
3b. Dense generation, on phase 3's model before it is freed:
   ``ServeEngine.generate`` of 8 prompts of 128 tokens (numpy seed 0), 32
   greedy new tokens, dense KV caches through ``flash_decode``, which must
   launch exactly 32 layers x (128 + 31) steps; the paged ``EngineCore``
   must give the same greedy tokens wherever the top-1 margin exceeds the
   phase 3 tolerance, and kernel and plain ``decode_step`` logits must
   agree within it at positions 0-3 and 36-39.  ``flash_decode`` is held
   to its plain version on generate's own caches (B=8, kv_len 159) and
   timed there: those are the kernels line's numbers for it.
3c. One long-context decode step, on phase 3's model before it is
   freed: ``LM.decode_step`` at B=1 on a 65537-token dense cache (34.4
   GB; every layer's K/V seeded at the RMS of 3b's) at kv_len 65536,
   through ``flash_decode`` (exactly 32 launches) and the plain attention
   path, logits within the phase 3 tolerance; the step's wall time
   (median of 10), its device time and ``flash_decode``'s share of it
   (one profiled step).
4. Training: with phase 3's model freed, the trainer's own functions
   (``init_train_state``, ``make_train_step``, ``TokenPipeline``,
   ``CheckpointManager``, as ``repro_torch.launch.train`` calls them) take
   5 AdamW steps of llama2-7b at full width, cut to 4 layers, on batches
   of 4 x 2048 tokens.  Every loss must be finite, ``fastattn_fwd`` must
   have launched once per layer and forward pass (twice per layer and
   step under remat), a checkpoint must round-trip params and optimizer
   state bit for bit, and on one 1 x 2048 batch the kernel path's loss
   and gradient norm must agree with the plain attention path's within
   1% and 5%.  One more step is traced with ``torch.profiler`` for the
   share of the step's device time in ``fastattn_fwd``.
5. Cooperative offload (paper §4.4), after phase 4: ``plan_offload`` and
   ``max_context_length`` for llama2-7b on one 80 GB card, then one
   layer's decode attention at B=1, S=65536 with the KV on the host
   (``HostOffloadEngine``: Q down, host attention, output up) against
   classical offloading (upload the layer's bf16 KV from pinned memory,
   then ``flash_decode``), outputs held to each other per query head,
   times (the kernel's also on the device alone), the
   measured pinned copy rate and host GFLOP/s, and ``table3_row`` under
   those constants.  The host KV is f32 (twice the upload's bytes), so
   host attention is also timed once over the pinned bf16 copy.
6. xlstm-125m at full width and depth (12 layers: 10 mLSTM blocks on
   ``mlstm_chunkwise.cu``, 2 sLSTM blocks; random weights from a seeded
   CUDA generator), after phase 5.  (a) ``LM.apply`` on 8 x 2048 tokens
   through the kernel: exactly 10 launches, finite logits, and every
   mlstm block held on the inputs this run gave it -- its output and its
   input and weight gradients to the plain version's, and the recurrent
   cells' output over the first 128 positions to the kernel's -- within
   one bf16 ulp.  End to end this random-weight bf16 model is
   ill-conditioned, so the logits of the kernel and plain paths are
   compared beside the plain path against itself with one bf16 ulp
   added to 1% of every mlstm h (``_perturbed_h``), and held to
   max(5%, twice that).  (c) ``ServeEngine.generate`` of 8 prompts of 128
   tokens (the first 128 of (a)'s), 32 greedy new tokens through the
   recurrent cells (no kernel launch), its teacher-forced logits at the
   last prompt position held to (a)'s the same way, and one profiled
   decode step.  (b) The trainer's functions take 5 AdamW steps of
   8 x 2048 tokens: finite losses, exactly 10 x 2 (remat) x 5 launches, a
   bit-exact checkpoint; on one batch the kernel path's loss within 1% of
   the plain path's and its gradient norm within a factor of 2 (both
   paths also measured under two perturbations of h); one profiled step
   and one sLSTM block's forward and backward timed alone.

The line before the last is a JSON object with one entry per kernel
(``ms`` per launch as above, ``device_ms`` on the device alone;
``flash_decode`` also ``long_*``: phase 2's B=1, S=65536 case and phase
3c's step); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
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
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-3}
# the attention checks also hold each output row's error to its own scale
# (held_to_plain): one bf16 rounding apart is at most 2^-7 of the row's
# largest |output|.


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one launch of ``fn()``: ``reps`` launches queued
    behind a spin kernel (``torch.cuda._sleep``), so the card runs them
    back to back while the host is still enqueueing them; CUDA events
    around the run, mean per launch.  time_ms's window also holds the
    host's work between its two events (the wrapper's checks and the
    launch itself), which is most of a short kernel's time; this one
    holds only the card's."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)         # ~10 ms: longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


# entry functions that must not spill: the tensor-core kernels, and the
# dense decode kernel, bound by bytes, whose registers carry its loads in
# flight (a spill adds local-memory traffic to every step)
NO_SPILL_ENTRIES = ("_wgmma", "flash_decode_")


def ptxas_faults(log: str) -> list:
    """The faults of a ``-Xptxas -v`` build log: spill stores or loads in
    an entry function named with one of NO_SPILL_ENTRIES, and any
    "Performance Loss" advisory on ``wgmma`` (C7510 to C7520: ptxas
    serialized the wgmmas, which costs the kernel ~1.7x)."""
    faults, entry = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = _SPILLS.search(line)
        if m and entry and any(t in entry for t in NO_SPILL_ENTRIES) and (
                int(m.group(1)) or int(m.group(2))):
            faults.append(f"{entry}: {line.strip()}")
        if "Performance Loss" in line and "wgmma" in line:
            faults.append(line.strip())
    return faults


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
            if ("registers" in line or "spill" in line
                    or "entry function" in line or "Performance" in line
                    or "warning" in line):
                log(f"[build]   {line.strip()}")
    faults = [f"{name}: {f}" for name, r in report.items()
              for f in ptxas_faults(r["log"])]
    if faults:
        raise AssertionError("ptxas: spills or serialized wgmma in the "
                             "kernels that must have neither:\n"
                             + "\n".join(faults))
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


def _speed(res: dict, n_ops: float) -> str:
    """The kernel's achieved rate on this data's useful operations, and
    its time over the library call's (where there is one); then both
    again on device time alone (``device_ms``)."""
    ratio = ("" if res["library_ms"] is None else
             f", kernel / library {res['ms'] / res['library_ms']:.2f}x")
    dev = (f"; device time {res['device_ms']:.4f} ms (bound / device "
           f"{res['bound_ms'] / res['device_ms']:.1%}")
    if res["library_ms"] is not None:
        dev += (f", library {res['library_device_ms']:.4f} ms, kernel / "
                f"library {res['device_ms'] / res['library_device_ms']:.2f}x")
    return f"{n_ops / (res['ms'] * 1e-3) / 1e12:.1f} TFLOP/s{ratio}{dev})"


def _report(kind: str, name: str, res: dict, n_ops: float) -> None:
    lib = ("n/a (no single PyTorch call applies a softcap or window)"
           if res["library_ms"] is None else
           f"{res['library_ms']:.4f} ms (scaled_dot_product_attention on the "
           "gathered view, gather excluded)")
    log(f"[{kind}] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), library {lib}; {_speed(res, n_ops)}")


def decode_case(name, *, b, hq, hkv, d, ps, n_kv, dtype, window=None,
                softcap=None, seed=0, lens=None, library=True):
    """paged_flash_decode vs paged_decode_reference on one shape, every
    (sequence, query head) row held to its own scale (held_to_plain).
    kv_len: ``lens`` -- a list, or a function of the launch's split_keys
    (the split-KV edges) -- or else drawn in 1..n_kv * ps with the first
    row full and the last an idle engine slot.  A row of kv_len 1 is an
    idle slot: all-scratch table row."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (paged_flash_decode,
                                                      plan_splits)
    from repro_torch.kernels.flash_decode.ref import (paged_decode_reference,
                                                      paged_gather)
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    num_pages = b * n_kv + 8
    kp, vp = _pools(gen, hkv, num_pages, ps, d, tdt)
    table = _tables(rng, b, n_kv, num_pages)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_keys, n_split = plan_splits(b, hkv, hq // hkv, n_kv, ps, window,
                                      sms)
    if lens is None:
        lens = rng.integers(1, n_kv * ps + 1, size=b)
        lens[0] = n_kv * ps                          # one full-length row
        lens[-1] = 1
    elif callable(lens):
        lens = lens(split_keys)
    lens = np.asarray(lens, np.int32)
    table[lens == 1] = 0
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
    log(f"[decode] {name}: kv_len {lens.tolist()}; split planner "
        f"{split_keys}-key splits, {n_split} a row on {sms} SMs")
    err, rel = held_to_plain("decode", name, out.reshape(-1, d),
                             ref.reshape(-1, d), dtype)

    # work this data needs: each valid K/V row read once per kv head
    keys = np.minimum(lens, window) if window else lens
    esize = torch.empty((), dtype=tdt).element_size()
    n_bytes = (2 * hkv * int(keys.sum()) * d + 2 * b * hq * d) * esize \
        + table.nbytes + lens.nbytes
    n_ops = 4.0 * (hq // hkv) * hkv * int(keys.sum()) * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None, "split_keys": split_keys,
           "n_split": n_split}
    res["device_ms"] = device_ms(kernel)
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
        res["library_device_ms"] = device_ms(lib)
    _report("decode", name, res, n_ops)
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
    for i in range(b):
        if nvalid[i] == 0 and out[i].abs().max().item() != 0.0:
            raise AssertionError(f"{name}: padded row {i} is not 0")
    # every valid query row of every head, each to its own scale
    got = torch.cat([out[i, :, :n].reshape(-1, d)
                     for i, n in enumerate(nvalid) if n])
    want = torch.cat([ref[i, :, :n].reshape(-1, d)
                      for i, n in enumerate(nvalid) if n])
    err, rel = held_to_plain("prefill", f"{name} (padded rows exactly 0)",
                             got, want, dtype)

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
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None}
    res["device_ms"] = device_ms(kernel)
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
        res["library_device_ms"] = device_ms(lib)
    _report("prefill", name, res, n_ops)
    return res


def fwd_case(name, *, b, hq, hkv, sq, skv, d, dtype, causal=True,
             window=None, softcap=None, q_offset=0, kv_valid=None, seed=0):
    """fastattn_fwd vs flash_reference on one shape.  Rows with no visible
    key are 0 on both sides, so every row is compared."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.tiling_mask import dense_mask
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.kernels.fastattn.ref import flash_reference
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(tdt)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)

    def kernel():
        return fastattn_fwd(q, k, v, kv_valid=kv_valid, **kw)

    def plain():
        return flash_reference(q, k, v, kv_len=kv_valid, **kw)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    # every query row of every head, each to its own scale (a long causal
    # row's output is ~0.1, an early row's up to ~4)
    err, rel = held_to_plain("fastattn", name, out.reshape(-1, d),
                             ref.reshape(-1, d), dtype)

    # work this data needs: the visible (row, key) pairs of every head;
    # every input read once, the output written once
    mask = dense_mask(sq, skv, causal=causal, window=window,
                      q_offset=q_offset, device="cuda")
    if kv_valid is not None:
        mask[:, kv_valid:] = False
    pairs = int(mask.sum().item())
    esize = q.element_size()
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * esize
    n_ops = 4.0 * b * hq * pairs * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None, "pairs": pairs}
    res["device_ms"] = device_ms(kernel)
    if softcap is None:
        ke = k.repeat_interleave(hq // hkv, dim=1)      # GQA expanded
        ve = v.repeat_interleave(hq // hkv, dim=1)      # outside the time
        plain_causal = (causal and q_offset == 0 and sq == skv
                        and window is None and kv_valid in (None, skv))

        def lib():
            if plain_causal:
                return F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
        res["library_ms"] = time_ms(lib)
        res["library_device_ms"] = device_ms(lib)
    lib_s = ("n/a (no single PyTorch call applies a softcap)"
             if res["library_ms"] is None else
             f"{res['library_ms']:.4f} ms (scaled_dot_product_attention, "
             "GQA expansion excluded)")
    log(f"[fastattn] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}, {pairs} visible pairs per head), library "
        f"{lib_s}; {_speed(res, n_ops)}")
    return res


def held_to_plain(tag, name, out, ref, dtype, unbounded=False) -> tuple:
    """Hold ``out`` to its plain version ``ref`` (leading dim = rows: a
    batch row, or a query row of a head): the max abs error within TOL,
    and every row's max abs error within REL_TOL of that row's largest
    |ref|.  The second check matters
    on long caches, where an output's scale is about sqrt(e / kv_len) and
    TOL alone would pass a kernel that skipped part of the keys.  TOL
    assumes outputs below 4 in magnitude (an attention output).  For an
    ``unbounded`` output (the mLSTM's h, whose denominator can be small,
    reaches ~80 on N(0, 1) inputs at xlstm-125m's training shape; the
    xLSTM blocks' outputs and gradients) TOL is scaled by
    max(1, max|ref| / 2): two bf16 values one rounding apart differ by
    one ulp, at most 2^-7 of the largest value.
    Returns (max abs error, max error relative to its row's scale)."""
    import torch
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (out.float() - ref.float()).abs().flatten(1).amax(1)
    scale = ref.float().abs().flatten(1).amax(1)
    err = diff.max().item()
    rel = (diff / scale.clamp_min(1e-30)).max().item()
    tol, rtol = TOL[dtype], REL_TOL[dtype]
    if unbounded:
        tol *= max(1.0, scale.max().item() / 2)
    log(f"[{tag}] {name}: max_abs_err {err:.3e} (tol {tol:g}), max error "
        f"/ row scale {rel:.3e} (tol {rtol:g}), smallest row scale "
        f"{scale.min().item():.3e}")
    if not (err <= tol and rel <= rtol):
        raise AssertionError(f"{name}: max_abs_err {err} (tol {tol}), "
                             f"relative {rel} (tol {rtol})")
    return err, rel


def dense_decode_measure(name, q, k, v, lens, *, dtype, layout,
                         window=None, softcap=None) -> dict:
    """flash_decode vs decode_reference on given cache tensors (read in
    place in ``layout``) and host kv_len ``lens``; then the kernel, the
    plain version and SDPA timed, and the bound of this data's work."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import decode_reference
    b, hq, d = q.shape
    if layout == "bshd":
        s, hkv = k.shape[1], k.shape[2]
    else:
        hkv, s = k.shape[1], k.shape[2]
    split_keys, n_split = _dense_plan(b, hq, hkv, s, window)
    lens_t = torch.from_numpy(lens).cuda()
    kw = dict(window=window, softcap=softcap, layout=layout)

    def kernel():
        return flash_decode(q, k, v, lens_t, **kw)

    def plain():
        return decode_reference(q[:, :, None], k, v, lens_t,
                                **kw)[:, :, 0]

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    log(f"[flash_decode] {name}: kv_len {lens.tolist()}; split planner "
        f"{split_keys}-key splits, {n_split} a row")
    # every (batch, query head) row to its own scale
    err, rel = held_to_plain("flash_decode", name, out.reshape(-1, d),
                             ref.reshape(-1, d), dtype)

    # work this data needs: each valid K/V row read once per kv head
    keys = np.minimum(lens, window) if window else lens
    esize = q.element_size()
    n_bytes = (2 * hkv * int(keys.sum()) * d + 2 * b * hq * d) * esize \
        + lens.nbytes
    n_ops = 4.0 * hq * int(keys.sum()) * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None, "split_keys": split_keys,
           "n_split": n_split}
    res["device_ms"] = device_ms(kernel)
    lib_note = "n/a (no single PyTorch call applies a softcap or window)"
    if window is None and softcap is None:
        # SDPA takes (B, H, S, D): a "bshd" cache is copied to that layout
        # outside the timed region
        kd = k.transpose(1, 2).contiguous() if layout == "bshd" else k
        vd = v.transpose(1, 2).contiguous() if layout == "bshd" else v
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] < lens_t[:, None].long())[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask,
                enable_gqa=hq != hkv)
        res["library_ms"] = time_ms(lib)
        res["library_device_ms"] = device_ms(lib)
        lib_note = (f"{res['library_ms']:.4f} ms (scaled_dot_product_"
                    "attention, boolean mask"
                    + (", layout copy excluded)" if layout == "bshd"
                       else ")"))
    log(f"[flash_decode] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}, {n_bytes / 1e6:.1f} MB), library {lib_note}; "
        f"{_speed(res, n_ops)}")
    return res


def _dense_plan(b, hq, hkv, s, window):
    """(split_keys, n_split) of a flash_decode launch on this card."""
    import torch
    from repro_torch.kernels.flash_decode.ops import plan_dense_splits
    return plan_dense_splits(b, hq, hkv, s, window,
                             torch.cuda.get_device_properties(
                                 0).multi_processor_count)


def dense_decode_case(name, *, b, hq, hkv, s, d, dtype, layout,
                      window=None, softcap=None, seed=0, lens=None):
    """flash_decode vs decode_reference on random N(0, 1) inputs of one
    shape, the cache in ``layout``.  kv_len: ``lens`` -- a list, or a
    function of the launch's split_keys (the split-KV edges) -- or else
    ragged in 1..s with one row at s and (for b > 1) one at 1."""
    import numpy as np
    import torch
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (b, s, hkv, d) if layout == "bshd" else (b, hkv, s, d)
    k, v = (torch.randn(shape, generator=gen, device="cuda").to(tdt)
            for _ in range(2))
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(tdt)
    if lens is None:
        lens = rng.integers(1, s + 1, size=b)
        lens[0] = s
        if b > 1:
            lens[-1] = 1
    elif callable(lens):
        lens = lens(_dense_plan(b, hq, hkv, s, window)[0])
    return dense_decode_measure(name, q, k, v, np.asarray(lens, np.int32),
                                dtype=dtype, layout=layout, window=window,
                                softcap=softcap)


MLSTM_STATE_RTOL = 1e-3     # C, n, m: float32 on both sides


def mlstm_case(name, *, b, h, s, dk, dv, dtype, chunk=128, layout="bhsd",
               fbias=3.0, seed=0):
    """mlstm_chunkwise_fwd vs ref.mlstm_chunkwise on one shape: h under
    held_to_plain (an unbounded output), the float32 state (C, n, m)
    within MLSTM_STATE_RTOL of each one's largest |value|.  q/k/v are
    N(0, 1) in ``dtype``; with layout "bshd" they are (B, S, H, D) tensors
    passed transposed, as the model passes its projections.  Gates: i
    N(0, 1), f N(0, 1) + ``fbias`` (3: the model's forget-gate bias)."""
    import torch
    from repro_torch.kernels.mlstm import ref as mref
    from repro_torch.kernels.mlstm.ops import mlstm_chunkwise_fwd
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(d):
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        t = torch.randn(shape, generator=gen, device="cuda").to(tdt)
        return t.transpose(1, 2) if layout == "bshd" else t
    q, k, v = draw(dk), draw(dk), draw(dv)
    ig = torch.randn((b, h, s), generator=gen, device="cuda")
    fg = torch.randn((b, h, s), generator=gen, device="cuda") + fbias

    def kernel():
        return mlstm_chunkwise_fwd(q, k, v, ig, fg, chunk=chunk)

    def plain():
        return mref.mlstm_chunkwise(q, k, v, ig, fg, chunk=chunk,
                                    return_state=True)

    (out, state), (ref, ref_state) = kernel(), plain()
    torch.cuda.synchronize()
    err, rel = held_to_plain("mlstm", name, out.flatten(0, 1),
                             ref.flatten(0, 1), dtype, unbounded=True)
    for what, got, want in zip("Cnm", state, ref_state):
        serr = (got - want).abs().max().item()
        sscale = want.abs().max().item()
        log(f"[mlstm] {name}: state {what} max_abs_err {serr:.3e} "
            f"({serr / sscale:.3e} of its scale {sscale:.3e}, tol "
            f"{MLSTM_STATE_RTOL:g})")
        if not serr <= MLSTM_STATE_RTOL * sscale:
            raise AssertionError(f"{name}: state {what} differs by {serr}")

    # work this data needs: q, k, v and gates read once, h and the state
    # written once; operations: the causal (row, key) pairs of every chunk
    # (q.k and the weighted sum of v: 2 (dk + dv) each) and per token q C,
    # the k v^T update (2 dk dv each) and q.n, the n update (2 dk each)
    esize = q.element_size()
    n_bytes = ((2 * dk + 2 * dv) * b * h * s * esize + 2 * b * h * s * 4
               + (dk * dv + dk + 1) * b * h * 4)
    L = min(chunk, s)
    sizes = [L] * (s // L) + ([s % L] if s % L else [])
    pairs = sum(n * (n + 1) // 2 for n in sizes)
    n_ops = b * h * (2.0 * (dk + dv) * pairs + s * (4.0 * dk * dv + 4 * dk))
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None}
    res["device_ms"] = device_ms(kernel)
    log(f"[mlstm] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({by}, {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP), library "
        f"n/a (no single PyTorch call computes the mLSTM); "
        f"{_speed(res, n_ops)}")
    return res


# phase 2's attention-forward cases, (name, arguments): the first of each
# list is the main path's shape (the kernels line's numbers)
FWD_CASES = [
    ("llama2-7b train B=4 H=32/32 S=2048 D=128 bf16 causal",
     dict(b=4, hq=32, hkv=32, sq=2048, skv=2048, d=128, dtype="bfloat16")),
    ("gemma2-2b train B=4 H=8/4 S=2048 D=256 bf16 window=512 cap=50",
     dict(b=4, hq=8, hkv=4, sq=2048, skv=2048, d=256, dtype="bfloat16",
          window=512, softcap=50.0, seed=1)),
    ("f32 B=2 H=8/2 Sq=1000 Skv=1500 D=128 q_offset=300 kv_valid=1400",
     dict(b=2, hq=8, hkv=2, sq=1000, skv=1500, d=128, dtype="float32",
          q_offset=300, kv_valid=1400, seed=2)),
    ("non-causal B=2 H=8/8 Sq=512 Skv=777 D=64 bf16",
     dict(b=2, hq=8, hkv=8, sq=512, skv=777, d=64, dtype="bfloat16",
          causal=False, seed=3)),
    ("bf16 B=2 H=8/2 Sq=1000 Skv=1500 D=128 q_offset=300 kv_valid=1400",
     dict(b=2, hq=8, hkv=2, sq=1000, skv=1500, d=128, dtype="bfloat16",
          q_offset=300, kv_valid=1400, seed=4)),
]
PREFILL_CASES = [
    ("llama2-7b B=4 chunk=512 H=32/32 D=128 bf16 ps=128",
     dict(hq=32, hkv=32, d=128, ps=128, n_kv=16, chunk=512,
          dtype="bfloat16", starts=[0, 512, 1024, 0],
          nvalid=[512, 300, 512, 0])),
    ("gemma2-2b B=4 chunk=512 H=8/4 D=256 bf16 window=256 cap=50",
     dict(hq=8, hkv=4, d=256, ps=128, n_kv=16, chunk=512, dtype="bfloat16",
          starts=[0, 512, 1536, 0], nvalid=[512, 37, 512, 0], window=256,
          softcap=50.0, seed=1)),
    ("ps=16 f32 chunk=64 H=8/2 D=128 window=40 cap=30",
     dict(hq=8, hkv=2, d=128, ps=16, n_kv=12, chunk=64, dtype="float32",
          starts=[0, 64, 100, 0], nvalid=[64, 64, 20, 0], window=40,
          softcap=30.0, seed=2)),
    ("qwen2.5-32b ps=16 B=4 chunk=512 H=40/8 D=128 bf16",
     dict(hq=40, hkv=8, d=128, ps=16, n_kv=68, chunk=512, dtype="bfloat16",
          starts=[0, 512, 1000, 0], nvalid=[512, 301, 77, 0], seed=3)),
]


# phase 2's paged decode cases, (name, arguments): the first is the main
# path's shape (the kernels line's numbers).  kv_len as a function of the
# launch's split_keys puts rows one below, at and one above a split; then
# a window narrower than the table, one sequence over many splits, and
# only idle rows (kv_len 1, all-scratch table rows)
DECODE_CASES = [
    ("llama2-7b B=8 H=32/32 D=128 bf16 ps=128",
     dict(b=8, hq=32, hkv=32, d=128, ps=128, n_kv=16, dtype="bfloat16")),
    ("gemma2-2b B=8 H=8/4 D=256 bf16 ps=128 window=256 cap=50",
     dict(b=8, hq=8, hkv=4, d=256, ps=128, n_kv=16, dtype="bfloat16",
          window=256, softcap=50.0, seed=1)),
    ("ps=16 f32 B=4 H=8/2 D=128 window=100 cap=30",
     dict(b=4, hq=8, hkv=2, d=128, ps=16, n_kv=24, dtype="float32",
          window=100, softcap=30.0, seed=2)),
    ("split edges B=4 H=32/8 D=128 bf16 ps=128 kv_len split-1/split/"
     "split+1/1", dict(b=4, hq=32, hkv=8, d=128, ps=128, n_kv=16,
                       dtype="bfloat16", seed=3,
                       lens=lambda sk: [sk - 1, sk, sk + 1, 1])),
    ("window in a later split B=4 H=8/4 D=256 bf16 ps=16 window=300",
     dict(b=4, hq=8, hkv=4, d=256, ps=16, n_kv=128, dtype="bfloat16",
          window=300, seed=4, lens=[2048, 1337, 301, 1])),
    ("B=1 H=32/8 D=128 bf16 ps=128 kv_len=4096 (many splits)",
     dict(b=1, hq=32, hkv=8, d=128, ps=128, n_kv=32, dtype="bfloat16",
          seed=5, lens=[4096])),
    ("idle rows only B=2 H=8/8 D=64 bf16 ps=16",
     dict(b=2, hq=8, hkv=8, d=64, ps=16, n_kv=8, dtype="bfloat16", seed=6,
          lens=[1, 1])),
]
# phase 2's dense decode cases, (name, arguments).  The main path's own
# shape is phase 3b's (generate's caches); LONG_DECODE is the kernels
# line's long shape (llama2-7b at B=1 on a 65536-token cache), then the
# paper's longest input (262144 tokens), qwen2.5-32b's GQA 40/8 (a group
# of 5 in the 8-row instance) at its native context, kv_len one below, at
# and one above a split, and a window narrower than the 32-key split
LONG_DECODE = "llama2-7b B=1 H=32/32 D=128 bf16 bshd S=65536"
DENSE_DECODE_CASES = [
    ("llama2-7b B=8 H=32/32 D=128 bf16 bshd S=4096",
     dict(b=8, hq=32, hkv=32, s=4096, d=128, dtype="bfloat16",
          layout="bshd")),
    ("llama2-7b B=8 H=32/32 D=128 bf16 bhsd S=4096",
     dict(b=8, hq=32, hkv=32, s=4096, d=128, dtype="bfloat16",
          layout="bhsd")),
    ("gemma2-2b B=8 H=8/4 D=256 bf16 bshd S=8192 window=4096 cap=50",
     dict(b=8, hq=8, hkv=4, s=8192, d=256, dtype="bfloat16", layout="bshd",
          window=4096, softcap=50.0, seed=1)),
    ("f32 B=4 H=8/2 D=64 bshd S=1000",
     dict(b=4, hq=8, hkv=2, s=1000, d=64, dtype="float32", layout="bshd",
          seed=2)),
    (LONG_DECODE,
     dict(b=1, hq=32, hkv=32, s=65536, d=128, dtype="bfloat16",
          layout="bshd", seed=3)),
    ("llama2-7b B=1 H=32/32 D=128 bf16 bshd S=262144",
     dict(b=1, hq=32, hkv=32, s=262144, d=128, dtype="bfloat16",
          layout="bshd", seed=4)),
    ("qwen2.5-32b B=2 H=40/8 D=128 bf16 bshd S=32768",
     dict(b=2, hq=40, hkv=8, s=32768, d=128, dtype="bfloat16",
          layout="bshd", seed=5, lens=[32768, 32768])),
    ("split edges B=4 H=32/8 D=128 bf16 bhsd S=4096 kv_len split-1/split/"
     "split+1/1", dict(b=4, hq=32, hkv=8, s=4096, d=128, dtype="bfloat16",
                       layout="bhsd", seed=6,
                       lens=lambda sk: [sk - 1, sk, sk + 1, 1])),
    ("window narrower than a split B=4 H=8/2 D=256 bf16 bshd S=2048 "
     "window=20", dict(b=4, hq=8, hkv=2, s=2048, d=256, dtype="bfloat16",
                       layout="bshd", window=20, seed=7,
                       lens=[2048, 21, 20, 1])),
]
# phase 2's mLSTM cases: xlstm-125m's training shape first (the kernels
# line's numbers); then a ragged f32 case, S below the chunk, 16 chunks of
# state recurrence at a small dk/dv, a ragged S over eight chunks, and a
# forget bias of -2 (m falls across chunks, the stabiliser changes sign)
MLSTM_CASES = [
    ("xlstm-125m train B=8 H=4 S=2048 dk=dv=384 bf16 chunk=128 bshd",
     dict(b=8, h=4, s=2048, dk=384, dv=384, dtype="bfloat16",
          layout="bshd")),
    ("f32 B=2 H=3 S=1000 dk=64 dv=96 chunk=128 (ragged)",
     dict(b=2, h=3, s=1000, dk=64, dv=96, dtype="float32", seed=1)),
    ("bf16 B=2 H=4 S=77 dk=dv=384 chunk=128 (S below the chunk)",
     dict(b=2, h=4, s=77, dk=384, dv=384, dtype="bfloat16", layout="bshd",
          seed=2)),
    ("bf16 B=2 H=2 S=2048 dk=32 dv=48 chunk=128 (16 chunks)",
     dict(b=2, h=2, s=2048, dk=32, dv=48, dtype="bfloat16", seed=3)),
    ("bf16 B=2 H=4 S=1000 dk=dv=384 chunk=128 bshd (ragged, 8 chunks)",
     dict(b=2, h=4, s=1000, dk=384, dv=384, dtype="bfloat16",
          layout="bshd", seed=4)),
    ("bf16 B=2 H=4 S=2048 dk=dv=384 chunk=128 forget bias -2",
     dict(b=2, h=4, s=2048, dk=384, dv=384, dtype="bfloat16", fbias=-2.0,
          seed=5)),
]


def phase_kernels() -> dict:
    """Every kernel against its plain version.  Returns the main-path
    numbers of each kernel."""
    fwd = [fwd_case(name, **kw) for name, kw in FWD_CASES][0]
    dec = [decode_case(name, **kw) for name, kw in DECODE_CASES][0]
    pre = [prefill_case(name, **kw) for name, kw in PREFILL_CASES][0]
    dense = {name: dense_decode_case(name, **kw)
             for name, kw in DENSE_DECODE_CASES}
    mls = [mlstm_case(name, **kw) for name, kw in MLSTM_CASES][0]
    # flash_decode's numbers for the kernels line are taken at the main
    # path's own shape, in phase 3b; its long_* keys at LONG_DECODE
    return {"paged_decode": dec, "paged_prefill": pre, "fastattn_fwd": fwd,
            "mlstm_chunkwise": mls, "flash_decode_long": dense[LONG_DECODE]}


# ---------------------------------------------------------------------------
# phase 3: serving llama2-7b
# ---------------------------------------------------------------------------

def build_llama():
    """llama2-7b at full width and depth, random weights from seed 0."""
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import build_model
    cfg = get_model_config("llama2-7b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.2f}B params ({cfg.param_dtype}) "
        f"initialised in {time.perf_counter() - t0:.1f}s")
    return model, params


def phase_serving(model, params, n_requests: int = 12,
                  new_tokens: int = 32) -> dict:
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.kernels.fastattn.ops import fastattn_paged_prefill
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    from repro_torch.serving.scheduler import FINISHED, SamplingParams

    cfg = model.cfg
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

# ---------------------------------------------------------------------------
# phase 3b: dense generation on llama2-7b
# ---------------------------------------------------------------------------

DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 8, 128, 32
DENSE_CHECK_POS = (0, 1, 2, 3, 36, 37, 38, 39)


def _compare_logits(what, got, ref) -> None:
    """Hold kernel-path logits ``got`` (B, V) to ``ref``: within LOGIT_TOL
    of ``ref``'s scale, and the same greedy token in every row whose top-1
    margin exceeds that tolerance."""
    import torch
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    tol = LOGIT_TOL * scale
    if not err <= tol:
        raise AssertionError(f"{what}: logits differ by {err} > {tol}")
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = torch.argmax(got, -1) == torch.argmax(ref, -1)
    if bool((clear & ~same).any()):
        raise AssertionError(f"{what}: greedy tokens differ")
    log(f"[dense] {what}: max_abs_err {err:.4f} (tol {tol:.4f}), greedy "
        f"tokens equal in {int(clear.sum())} rows with a clear margin")


def phase_dense(model, params) -> dict:
    """ServeEngine.generate on phase 3's llama2-7b: B=8 prompts of 128
    tokens, 32 greedy new tokens, dense caches through flash_decode."""
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import decode_reference
    from repro_torch.serving.core import EngineCore
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import SamplingParams

    cfg = model.cfg
    b, s, n_new = DENSE_BATCH, DENSE_PROMPT, DENSE_NEW
    serve = ServeConfig(max_seq_len=s + n_new + 1, top_k=1)
    engine = ServeEngine(model=model, params=params, cfg=cfg, serve=serve)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(b, s))
    cache_gb = 2 * cfg.num_layers * b * serve.max_seq_len * cfg.kv_dim \
        * 2 / 1e9
    # the logits each generated token was sampled from, for the margins,
    # and the dense caches as generate left them
    seen, last_cache = [], []
    decode = engine._decode

    def recording(tok, cache, pos):
        logits, cache = decode(tok, cache, pos)
        if pos >= s - 1:
            seen.append(logits.float())
        last_cache[:] = [cache]
        return logits, cache
    engine._decode = recording

    torch.cuda.synchronize()
    flash_decode.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_decode.launches
    engine._decode = decode
    expected = cfg.num_layers * (s + n_new - 1)
    log(f"[dense] generate: B={b} x {s} prompt tokens, {n_new} new, dense "
        f"cache {cache_gb:.2f} GB, {wall:.2f}s wall; flash_decode launches "
        f"{launches} (expected {cfg.num_layers} layers x ({s} prompt + "
        f"{n_new - 1} decode steps) = {expected})")
    if launches != expected:
        raise AssertionError(f"flash_decode launched {launches} times, "
                             f"expected {expected}")
    out = out.cpu().numpy()
    if out.shape != (b, n_new) or not ((0 <= out) & (out < cfg.vocab_size)
                                       ).all():
        raise AssertionError(f"bad generated tokens {out.shape}")

    # the kernel against its plain version at the main path's own shape:
    # generate's caches (B=8, 161 token rows, "bshd") of the first and the
    # last layer, at the last step's kv_len (prompt + new - 1 = 159); the
    # first layer's numbers are the kernels line's
    cache, = last_cache
    del last_cache
    kv_len = s + n_new - 1
    lens = np.full((b,), kv_len, np.int32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    kern = None
    for layer in (0, cfg.num_layers - 1):
        q = torch.randn((b, cfg.num_heads, cfg.head_dim), generator=gen,
                        device="cuda").to(cache[layer].k.dtype)
        what = (f"generate's layer-{layer} cache B={b} "
                f"S={serve.max_seq_len} kv_len={kv_len} bshd")
        if kern is None:
            kern = dense_decode_measure(what, q, cache[layer].k,
                                        cache[layer].v, lens,
                                        dtype="bfloat16", layout="bshd")
            continue
        out_k = flash_decode(q, cache[layer].k, cache[layer].v,
                             torch.from_numpy(lens).cuda(), layout="bshd")
        ref_k = decode_reference(q[:, :, None], cache[layer].k,
                                 cache[layer].v, torch.from_numpy(lens),
                                 layout="bshd")[:, :, 0]
        held_to_plain("flash_decode", what, out_k.reshape(-1, cfg.head_dim),
                      ref_k.reshape(-1, cfg.head_dim), "bfloat16")
    # the RMS of the K and V rows generate wrote, per layer: phase 3c
    # fills its long cache to these scales
    kv_rms = [[t[:, :kv_len].float().square().mean().sqrt().item()
               for t in (c.k, c.v)] for c in cache]
    del cache

    # the same prompts through the paged EngineCore: equal greedy tokens
    # wherever the dense path's top-1 margin exceeds the tolerance; the
    # streams may fork only at a near-tie, after which contexts differ
    core = EngineCore(model, params, cfg, ServeConfig(
        max_batch=b, max_seq_len=s + n_new + 128, page_size=128,
        prefill_chunk=512), device="cuda")
    ids = [core.add_request(p, SamplingParams(max_new_tokens=n_new))
           for p in prompts]
    paged = {i: [] for i in ids}
    while core.has_work:
        for ev in core.step():
            if ev.kind != "token":
                raise AssertionError(f"request {ev.request_id}: {ev}")
            paged[ev.request_id].append(ev.token)
    logits = torch.stack(seen, dim=1)                 # (B, n_new, V)
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    tol = LOGIT_TOL * logits.abs().amax(dim=-1).cpu().numpy()
    compared = equal = 0
    for row, rid in enumerate(ids):
        for t in range(n_new):
            clear = margin[row, t] > tol[row, t]
            if paged[rid][t] != out[row, t]:
                if clear:
                    raise AssertionError(
                        f"row {row} token {t}: paged {paged[rid][t]} != "
                        f"dense {out[row, t]} at margin {margin[row, t]}")
                break                   # forked at a near-tie
            equal += 1
            compared += int(clear)
    log(f"[dense] paged EngineCore vs dense generate: {equal} of "
        f"{b * n_new} greedy tokens equal before the streams fork at a "
        f"near-tie, {compared} of them with a top-1 margin above the "
        "tolerance")
    del core, logits, seen

    # kernel vs plain attention path, each teacher-forced on its own
    # cache: the first 4 prompt positions, and 4 past one 32-key pass of
    # the kernel's thread groups (flash_decode.cu)
    caches = {impl: model.init_cache(b, serve.max_seq_len)
              for impl in ("kernel", "reference")}
    toks = torch.from_numpy(prompts).cuda()
    for pos in range(DENSE_CHECK_POS[-1] + 1):
        res = {}
        for impl, cache in caches.items():
            res[impl], _ = model.decode_step(params, toks[:, pos], cache,
                                             pos, impl=impl)
        if pos in DENSE_CHECK_POS:
            _compare_logits(f"decode_step pos {pos}, kernel vs plain",
                            res["kernel"], res["reference"])
    del caches
    tok_s = engine.throughput_tokens_per_s(b, s, n_new=8)
    res = {"batch": b, "prompt": s, "new_tokens": n_new,
           "wall_s": wall, "tokens_per_s_generate": b * n_new / wall,
           "throughput_tokens_per_s": tok_s, "launches": launches,
           "tokens_equal": equal, "tokens_clear": compared,
           "cache_gb": cache_gb, "kernel": kern, "kv_rms": kv_rms}
    log(f"[dense] generate {res['tokens_per_s_generate']:.1f} new tok/s "
        f"(prompt teacher-forced one position a step); "
        f"throughput_tokens_per_s(B={b}, prompt {s}, 8 steps) "
        f"{tok_s:.1f} tok/s")
    log("[dense] " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 3c: one long-context decode step of llama2-7b
# ---------------------------------------------------------------------------

LONG_KV = 65536       # kv_len of the step: the token at position LONG_KV - 1


def phase_long_decode(model, params, kv_rms) -> dict:
    """One ``LM.decode_step`` of phase 3's llama2-7b at B=1 on a dense
    cache of LONG_KV + 1 tokens, at position LONG_KV - 1 (kv_len
    LONG_KV): every layer's K/V drawn from a seeded CUDA generator at the
    RMS of what phase 3b's generate wrote (``kv_rms``), then the step
    through flash_decode (exactly one launch a layer) and through the
    plain attention path, logits held to each other; then the kernel
    step's wall time (median of 10, synchronised) and one profiled step:
    its device time and flash_decode's share."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode.ops import flash_decode

    cfg = model.cfg
    gc.collect()                  # phase 3's engines and pools
    torch.cuda.empty_cache()
    pos = LONG_KV - 1
    t0 = time.perf_counter()
    cache = model.init_cache(1, LONG_KV + 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for c, rms in zip(cache, kv_rms):
        for buf, r in zip((c.k, c.v), rms):
            buf.copy_(torch.randn(buf.shape, generator=gen,
                                  device="cuda").mul_(r))
    torch.cuda.synchronize()
    cache_gb = sum(c.k.nbytes + c.v.nbytes for c in cache) / 1e9
    log(f"[long] {cfg.name}: dense cache B=1 x {LONG_KV + 1} tokens, "
        f"{cache_gb:.1f} GB, filled at generate's K/V RMS in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1,)).astype(np.int32)).cuda()

    def step(impl):
        return model.decode_step(params, tok, cache, pos, impl=impl)[0]

    flash_decode.launches = 0
    got = step("kernel")
    torch.cuda.synchronize()
    launches = flash_decode.launches
    log(f"[long] decode_step at position {pos} (kv_len {LONG_KV}): "
        f"flash_decode launches {launches} (expected {cfg.num_layers}, one "
        "a layer)")
    if launches != cfg.num_layers:
        raise AssertionError(f"flash_decode launched {launches} times, "
                             f"expected {cfg.num_layers}")
    ref = step("reference")
    _compare_logits(f"long decode step kv_len {LONG_KV}, kernel vs plain",
                    got, ref)
    wall_ms, _ = _wall_ms(lambda: step("kernel"))
    plain_ms, _ = _wall_ms(lambda: step("reference"), reps=3)
    kernels, dev_s = _profile_kernels(lambda: step("kernel"))
    fd = [e for e in kernels if "flash_decode_" in e.key]
    fd_s = sum(_device_us(e) for e in fd) / 1e6
    # least time of the step: every weight read once (bf16; of an untied
    # embedding table only the token's row) and every layer's kv_len K/V
    # rows read once
    n_params = sum(t.numel() for t in _leaves(params))
    if not cfg.tie_embeddings:
        n_params -= params["embedding"]["embed"].numel() - cfg.d_model
    step_bytes = n_params * 2 + cfg.num_layers * 2 * LONG_KV \
        * cfg.kv_dim * 2
    res = {"kv_len": LONG_KV, "cache_gb": cache_gb, "launches": launches,
           "wall_ms": wall_ms, "plain_wall_ms": plain_ms,
           "device_ms": dev_s * 1e3, "flash_decode_device_ms": fd_s * 1e3,
           "flash_decode_calls": sum(e.count for e in fd),
           "flash_decode_share_of_device": fd_s / dev_s,
           "idle_share": 1 - dev_s * 1e3 / wall_ms,
           "bound_ms": step_bytes / H100_BYTES_PER_S * 1e3,
           "card": _card()}
    log(f"[long] {res['card']}: step {wall_ms:.2f} ms wall (median of 10; "
        f"plain attention path {plain_ms:.2f} ms), {res['device_ms']:.2f} "
        f"ms of kernels in one profiled step (idle share "
        f"{res['idle_share']:.3f}); flash_decode {fd_s * 1e3:.3f} ms in "
        f"{res['flash_decode_calls']} launches, "
        f"{res['flash_decode_share_of_device']:.1%} of the device time; "
        f"the step's byte bound {res['bound_ms']:.2f} ms")
    groups = {}
    for e in kernels:
        grp = ("attention: flash_decode.cu" if "flash_decode_" in e.key
               else _train_group(e.key))
        groups[grp] = groups.get(grp, 0.0) + _device_us(e) / 1e3
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[long]   {ms:9.3f} ms  {grp}")
    log("[long] " + json.dumps(res))
    del cache
    return res


# ---------------------------------------------------------------------------
# phase 4: training llama2-7b at full width
# ---------------------------------------------------------------------------

# Depth cut for memory: at 32 layers bf16 params + bf16 grads + two f32
# AdamW moments take about 13.5 + 13.5 + 54 GB, over one 80 GB card; 4
# layers keep every width (1.07 B params, about 13 GB of state).
TRAIN_LAYERS = 4
TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
# kernel path vs plain attention path on one 1 x 2048 batch: bf16
# activations through 4 layers, rounded at different points by the two
# attention paths (the kernel rounds its output once; the plain path's
# backward recomputes in f32), move the loss by well under 1% and the
# gradient norm by a few percent at most.
LOSS_RTOL = 0.01
GNORM_RTOL = 0.05


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# every CUDA kernel of mlstm_chunkwise.cu is named mlstm_chunkwise_*: the
# float32 FMA kernel, and bf16's gates, states and outputs kernels
MLSTM_KERNELS = "mlstm_chunkwise_"


def _train_group(name: str) -> str:
    n = name.lower()
    if "fastattn_fwd_" in n:
        return "attention forward: fastattn_fwd.cu"
    if MLSTM_KERNELS in n:
        return "mLSTM forward: mlstm_chunkwise.cu"
    if any(t in n for t in ("gemm", "gemv", "nvjet", "cutlass", "sm90_",
                            "cublas")):
        if "f32f32" in n or "sgemm" in n:
            return "matrix products, float32 (plain attention recompute)"
        return "matrix products, bf16 (projections, MLP, LM head)"
    if "reduce" in n or "softmax" in n or "logsumexp" in n:
        return "reductions"
    if "copy" in n or "memcpy" in n or "memset" in n or "cat" in n:
        return "copies / casts"
    return "elementwise and other"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_training() -> dict:
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import (ParallelConfig, TrainConfig,
                                    get_model_config)
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.fastattn.ops import fastattn, fastattn_fwd
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.training import tree
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = dataclasses.replace(get_model_config("llama2-7b"),
                              num_layers=TRAIN_LAYERS)
    parallel = ParallelConfig(remat="selective")   # as launch/train.py
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", parallel)
    state = init_train_state(model, model.generator(tcfg.seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(state.params))
    log(f"[train] {cfg.name} cut to {cfg.num_layers} layers: d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, {n_params / 1e9:.3f}B params ({cfg.param_dtype}, f32 "
        f"moments), remat {parallel.remat}; initialised in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))

    fastattn_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        batch = to_device(data.next(), model.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
        log(f"[train] step {i} loss {losses[-1]:.4f} lr "
            f"{float(metrics['lr']):.2e} gnorm "
            f"{float(metrics['grad_norm']):.4f} {step_s[-1] * 1e3:.1f} ms")
    launches = fastattn_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = TRAIN_LAYERS * (2 if parallel.remat != "none" else 1) \
        * TRAIN_STEPS
    log(f"[train] fastattn_fwd launches on the training path: {launches} "
        f"(expected {TRAIN_LAYERS} layers x 2 forward passes under remat x "
        f"{TRAIN_STEPS} steps = {expected})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"fastattn_fwd launched {launches} times, "
                             f"expected {expected}")
    steady_s = statistics.median(step_s[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / steady_s

    # checkpoint: params and optimizer state round-trip bit for bit
    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        t1 = time.perf_counter()
        mgr.save(TRAIN_STEPS, state, extras={"data": data.state()})
        save_s = time.perf_counter() - t1
        restored, manifest = mgr.restore(state)
        for (path, a), b in zip(tree.leaves_with_paths(restored),
                                tree.leaves(state)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"checkpoint leaf {path} changed")
        n_leaves = manifest["n_leaves"]
        del restored
    log(f"[train] checkpoint of {n_leaves} leaves saved in {save_s:.1f}s "
        "and restored bit for bit")

    # kernel path vs plain attention path on one 1 x 2048 batch
    one = {k: x[:1] for k, x in to_device(data.next(), model.device).items()}
    (k_loss, k_gn), (p_loss, p_gn) = (
        _loss_and_gnorm(model, state.params, one, impl)
        for impl in (None, "reference"))
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    gn_rel = abs(k_gn - p_gn) / abs(p_gn)
    log(f"[train] kernel vs plain path, 1 x {TRAIN_SEQ}: loss {k_loss:.5f}"
        f" vs {p_loss:.5f} (rel {loss_rel:.2e}, tol {LOSS_RTOL}), grad norm "
        f"{k_gn:.5f} vs {p_gn:.5f} (rel {gn_rel:.2e}, tol {GNORM_RTOL})")
    if not (loss_rel <= LOSS_RTOL and gn_rel <= GNORM_RTOL):
        raise AssertionError("kernel and plain training paths disagree")

    # one more step under the profiler: where the device time goes
    batch = to_device(data.next(), model.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    total_us = sum(_device_us(e) for e in kernels)
    if total_us <= 0:
        raise AssertionError("the profiler saw no device time")
    fa = [e for e in kernels if "fastattn_fwd_" in e.key]
    fa_us = sum(_device_us(e) for e in fa)
    groups = {}
    for e in kernels:
        grp = _train_group(e.key)
        groups[grp] = groups.get(grp, 0.0) + _device_us(e) / 1e6
    top = sorted(kernels, key=_device_us, reverse=True)[:8]

    # attention of one layer at the training shape, forward (kernel) plus
    # backward (plain recompute), and one AdamW update of every parameter
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    shape = (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, cfg.head_dim)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    attn_ms = time_ms(lambda: torch.autograd.grad(
        fastattn(q, k, v, impl="kernel"), (q, k, v), g), reps=5)
    del q, k, v, g
    zeros = tree.tree_map(torch.zeros_like, state.params)
    opt_ms = time_ms(lambda: adamw_update(zeros, state.opt, state.params,
                                          tcfg), reps=3, warmup=1)
    del zeros
    out = {"layers": TRAIN_LAYERS, "params": n_params, "steps": TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
           "step_s": step_s, "steady_step_s": steady_s, "tok_s": tok_s,
           "peak_mem_gb": peak_gb, "launches": launches,
           "loss_rel": loss_rel, "gnorm_rel": gn_rel,
           "profiled_kernel_s": total_us / 1e6,
           "fastattn_s": fa_us / 1e6,
           "fastattn_calls": sum(e.count for e in fa),
           "groups_s": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "fastattn_share_of_step": fa_us / 1e6 / steady_s,
           "fastattn_share_of_kernels": fa_us / total_us,
           "idle_share": 1.0 - total_us / 1e6 / steady_s,
           "attn_layer_fwd_bwd_ms": attn_ms, "adamw_ms": opt_ms,
           "card": _card()}
    log(f"[train] {out['card']}: steady step {steady_s * 1e3:.1f} ms "
        f"(median of steps 1-{TRAIN_STEPS - 1}), {tok_s:.0f} tok/s, peak "
        f"memory {peak_gb:.1f} GB")
    log(f"[train] profiled step: kernels {out['profiled_kernel_s']:.4f}s, "
        f"fastattn_fwd {out['fastattn_s']:.4f}s in {out['fastattn_calls']} "
        f"launches ({out['fastattn_share_of_step']:.1%} of the unprofiled "
        f"step, {out['fastattn_share_of_kernels']:.1%} of kernel time), "
        f"idle share {out['idle_share']:.3f}")
    for grp, sec in out["groups_s"].items():
        log(f"[train]   {sec:9.4f}s  {grp}")
    log(f"[train] one layer's attention, kernel forward + plain backward: "
        f"{attn_ms:.2f} ms (x{TRAIN_LAYERS} layers = "
        f"{TRAIN_LAYERS * attn_ms / 1e3 / steady_s:.1%} of the step); one "
        f"adamw_update of {n_params / 1e9:.2f}B params: {opt_ms:.2f} ms "
        f"({opt_ms / 1e3 / steady_s:.1%} of the step)")
    for e in top:
        log(f"[train]   {_device_us(e) / 1e6:9.4f}s {e.count:6d}x "
            f"{e.key[:90]}")
    log("[train] " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 5: the paper's CPU-GPU cooperative offload
# ---------------------------------------------------------------------------

OFFLOAD_SEQ = 65536


def _host_memory_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) / 2 ** 20      # kB -> GiB
    raise AssertionError("MemTotal not in /proc/meminfo")


def _wall_ms(fn, reps: int = 10):
    """Median host wall time of ``fn()`` (synchronised) and its last
    result."""
    import torch
    out, times = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def phase_offload() -> dict:
    """Per-layer decode attention at llama2-7b's layer shape, B=1,
    S=65536: the cooperative strategy (KV on the host, attention there,
    only Q and the output cross PCIe) against classical offloading
    (upload the layer's KV, then the kernel)."""
    import dataclasses as dc

    import torch
    from repro_torch.config import get_model_config
    from repro_torch.core.offload import (HostOffloadEngine,
                                          OffloadLatencyModel,
                                          max_context_length, plan_offload,
                                          table3_row)
    from repro_torch.kernels.flash_decode.ops import flash_decode

    cfg = get_model_config("llama2-7b")
    for seq in (131072, 196608):
        plan = plan_offload(cfg, batch=1, seq_len=seq, gen_len=64,
                            n_devices=1, device_memory_gb=80.0)
        log(f"[offload] plan_offload {cfg.name} B=1 S={seq} gen 64, one "
            f"80 GB device: {plan.summary()}")
    host_gb = _host_memory_gb()
    ctx = max_context_length(cfg, batch=1, n_devices=1,
                             device_memory_gb=80.0, host_memory_gb=host_gb)
    log(f"[offload] max_context_length with {host_gb:.1f} GiB of host "
        f"memory: {ctx['device_only']} tokens on the device alone, "
        f"{ctx['cooperative']} with the cooperative strategy")

    s, hkv, d = OFFLOAD_SEQ, cfg.num_kv_heads, cfg.head_dim
    plan = dc.replace(plan_offload(cfg, batch=1, seq_len=s, gen_len=64,
                                   n_devices=1),
                      l_gpu=cfg.num_layers - 2, l_cpu=2, needs_offload=True)
    t0 = time.perf_counter()
    eng = HostOffloadEngine(cfg, plan, max_batch=1, max_seq=s)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    k, v = (torch.randn((1, s, hkv, d), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    for layer in range(plan.l_cpu):
        eng.prefill_offload(layer, k[:, :s - 1], v[:, :s - 1])
        eng.decode_append(layer, k[:, s - 1:], v[:, s - 1:], s - 1)
    torch.cuda.synchronize()
    host_kv_gb = 2 * s * hkv * d * 4 / 1e9
    log(f"[offload] HostOffloadEngine l_cpu={plan.l_cpu}: host KV "
        f"{host_kv_gb:.2f} GB a layer (f32, pinned), filled by "
        f"prefill_offload + one decode_append in "
        f"{time.perf_counter() - t0:.1f}s")

    q = torch.randn((1, 1, cfg.num_heads, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lens = torch.full((1,), s, dtype=torch.int32)
    eng.decode_attention(0, q, lens)                      # warm-up
    down_ms, q_h = _wall_ms(lambda: q.to("cpu"))
    host_ms, out_h = _wall_ms(lambda: eng.host_attention(0, q_h, lens))
    up_ms, _ = _wall_ms(lambda: out_h.to("cuda"))
    coop_ms, coop = _wall_ms(lambda: eng.decode_attention(0, q, lens))

    # classical: the layer's bf16 KV in pinned host memory, uploaded, then
    # the kernel on it
    k_h, v_h = (t.cpu().pin_memory() for t in (k, v))
    k_d, v_d = torch.empty_like(k), torch.empty_like(v)
    lens_d = lens.cuda()
    kv_bytes = 2 * k.numel() * k.element_size()

    def upload():
        k_d.copy_(k_h, non_blocking=True)
        v_d.copy_(v_h, non_blocking=True)

    def classical():
        upload()
        return flash_decode(q[:, 0], k_d, v_d, lens_d, layout="bshd")
    classical()
    upload_ms = time_ms(upload, reps=10)
    calc_ms = time_ms(lambda: flash_decode(q[:, 0], k_d, v_d, lens_d,
                                           layout="bshd"), reps=10)
    calc_device_ms = device_ms(lambda: flash_decode(q[:, 0], k_d, v_d,
                                                    lens_d, layout="bshd"))
    classical_ms, ref = _wall_ms(classical)
    # every query head's output to its own scale
    err, rel = held_to_plain("offload", "host output vs flash_decode on "
                             "the uploaded KV", coop[:, 0].reshape(-1, d),
                             ref.reshape(-1, d), "bfloat16")

    # the host KV is f32 (JAX's layout), twice the bytes the classical path
    # uploads: host attention once more over the pinned bf16 copies, for a
    # comparison of equal bytes (f32 math on 4096-key slices widened from
    # bf16, so the bf16 bytes are read once)
    g, step = cfg.num_heads // hkv, 4096
    slices = [slice(i, i + step) for i in range(0, s, step)]

    def host_bf16():
        qg = q_h[0, 0].float().reshape(hkv, g, d) * d ** -0.5
        logits = torch.cat([torch.einsum("hgd,shd->hgs", qg,
                                         k_h[0, sl].float())
                            for sl in slices], dim=-1)
        p = torch.softmax(logits, dim=-1)
        out = sum(torch.einsum("hgs,shd->hgd", p[..., sl], v_h[0, sl].float())
                  for sl in slices)
        return out.reshape(1, -1, d).to(q_h.dtype)
    host_bf16_ms, out_b = _wall_ms(host_bf16, reps=5)
    held_to_plain("offload", "bf16 host attention vs flash_decode",
                  out_b.reshape(-1, d), ref.cpu().reshape(-1, d), "bfloat16")

    flops = 4.0 * s * cfg.q_dim
    pcie_gbps = kv_bytes / (upload_ms / 1e3) / 1e9
    host_gflops = flops / (host_ms / 1e3) / 1e9
    model = OffloadLatencyModel(pcie_gbps=pcie_gbps, host_gflops=host_gflops)
    pred_classical = (model.classical_upload_s(kv_bytes)
                      + model.device_attention_s(1, s, cfg.q_dim)) * 1e3
    pred_coop = (model.host_attention_s(1, s, cfg.q_dim)
                 + model.coop_offupload_s(1, cfg.q_dim)) * 1e3
    rows = [table3_row(cfg, seq, n_devices=1, model=model)
            for seq in (131072, 196608)]
    res = {"seq": s, "host_kv_gb_per_layer": host_kv_gb,
           "coop_ms": coop_ms, "coop_q_down_ms": down_ms,
           "coop_host_attention_ms": host_ms, "coop_out_up_ms": up_ms,
           "classical_ms": classical_ms, "classical_upload_ms": upload_ms,
           "classical_kernel_ms": calc_ms,
           "classical_kernel_device_ms": calc_device_ms,
           "classical_over_coop": classical_ms / coop_ms,
           "pinned_h2d_gbps": pcie_gbps, "host_attention_gflops":
           host_gflops, "predicted_classical_ms": pred_classical,
           "predicted_coop_ms": pred_coop,
           "host_attention_bf16_kv_ms": host_bf16_ms,
           "table3_rows": rows, "max_abs_err": err, "rel_err": rel,
           "host_memory_gib": host_gb, "max_context": ctx}
    log(f"[offload] cooperative {coop_ms:.2f} ms a layer (Q down "
        f"{down_ms:.3f}, host attention over {host_kv_gb:.2f} GB of f32 KV "
        f"{host_ms:.2f}, output up {up_ms:.3f}); classical "
        f"{classical_ms:.2f} ms (upload of {kv_bytes / 1e9:.2f} GB of bf16 "
        f"KV {upload_ms:.2f}, flash_decode {calc_ms:.3f}, on the device "
        f"{calc_device_ms:.3f}); classical / "
        f"cooperative {classical_ms / coop_ms:.3f} (the paper's Table 3: "
        f"1.27-1.48); host attention over the {kv_bytes / 1e9:.2f} GB of "
        f"bf16 KV {host_bf16_ms:.2f} ms")
    log(f"[offload] measured: pinned host->device {pcie_gbps:.2f} GB/s, "
        f"host attention {host_gflops:.2f} GFLOP/s; the latency model "
        f"with them predicts classical {pred_classical:.2f} ms, "
        f"cooperative {pred_coop:.2f} ms at S={s}")
    for row in rows:
        log(f"[offload] table3_row S={row['seq']} (measured constants): "
            + json.dumps({k: v for k, v in row.items() if k != "seq"}))
    log("[offload] " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 6: xlstm-125m at full width and depth
# ---------------------------------------------------------------------------

XLSTM_BATCH, XLSTM_SEQ, XLSTM_STEPS = 8, 2048, 5
XLSTM_PROMPT, XLSTM_NEW = 128, 32


def _profile_kernels(fn):
    """Run ``fn()`` under torch.profiler (kernels only) and return its
    kernel events and their summed device time in seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    total = sum(_device_us(e) for e in kernels) / 1e6
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    return kernels, total


def _wall_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _logit_err(got, ref) -> tuple:
    """(max abs difference, that over max |ref|, the median over
    positions of each position's max difference over max |ref|)."""
    import torch
    v = ref.shape[-1]
    diff = (got.float() - ref.float()).abs().reshape(-1, v).amax(-1)
    scale = ref.float().abs().max().item()
    return (diff.max().item(), diff.max().item() / scale,
            torch.median(diff).item() / scale)


@contextlib.contextmanager
def _perturbed_h(seed: int = 9, path: str = "reference"):
    """Within the block, every mlstm block runs ``path`` (the plain version
    or the kernel, whatever impl the model passes) with one bf16 ulp added to a seeded 1% of the elements
    of its h: what rounding alone does downstream.  (The mLSTM output h = q C / max(|q.n|,
    exp(-m)) changes fast where q.n crosses 0; with random weights ten
    such blocks make a 1-ulp difference as large as the logits
    themselves, so two correct paths that round h at different places
    disagree end to end by about the logits' scale, and their gradient
    norms by far more than 5%.)"""
    import torch
    from repro_torch.layers import ssm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    chunkwise = ssm.mlstm_chunkwise

    def perturbed(q, k, v, ig, fg, chunk=128, impl=None):
        h = chunkwise(q, k, v, ig, fg, chunk, impl=path)
        hb = h.to(torch.bfloat16).float()
        flip = torch.rand(h.shape, generator=gen, device="cuda") < 0.01
        return torch.where(flip, hb + hb.abs() * 2 ** -7, hb)
    ssm.mlstm_chunkwise = perturbed
    try:
        yield
    finally:
        ssm.mlstm_chunkwise = chunkwise


def _end_to_end_gate(what, err, base, rtol) -> None:
    """End to end the kernel and plain paths may differ by what rounding
    alone does (``base``, the largest difference measured under
    _perturbed_h), so the gate is ``rtol`` or twice that, whichever is
    larger: it catches non-finite or exploding results; the blocks
    themselves are held to their plain versions one by one on the same
    inputs, forward and backward (phase 6a)."""
    tol = max(rtol, 2 * base)
    if not err <= tol:
        raise AssertionError(f"{what}: kernel and plain paths differ by "
                             f"{err:.3g} (relative), above {tol:.3g}")


def _loss_and_gnorm(model, params, batch, impl):
    import torch
    from repro_torch.training import tree
    from repro_torch.training.optimizer import global_norm
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, batch["tokens"], batch["labels"],
                          impl=impl)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.item(), global_norm(list(grads)).item()


def phase_xlstm() -> dict:
    """xlstm-125m (12 layers: 10 mLSTM blocks through mlstm_chunkwise.cu,
    2 sLSTM blocks) at full width and depth, random weights from a seeded
    CUDA generator: (a) LM.apply on 8 x 2048 tokens, kernel vs plain; (b)
    5 AdamW steps through the trainer's functions; (c)
    ServeEngine.generate through the recurrent cells, held to (a)."""
    import math

    import numpy as np
    import torch

    from repro_torch.config import (ParallelConfig, ServeConfig,
                                    TrainConfig, get_model_config)
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.mlstm.ops import mlstm_chunkwise_fwd
    from repro_torch.launch.train import to_device
    from repro_torch.layers import ssm
    from repro_torch.models import blocks as B
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training import tree
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = get_model_config("xlstm-125m")
    kinds = cfg.blocks()
    n_mlstm = kinds.count("mlstm")
    parallel = ParallelConfig(remat="selective")   # as launch/train.py
    b, s = XLSTM_BATCH, XLSTM_SEQ
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", parallel)
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    log(f"[xlstm] {cfg.name}: {cfg.num_layers} layers ({n_mlstm} mlstm, "
        f"{kinds.count('slstm')} slstm), d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f}M params ({cfg.param_dtype}) initialised in "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- (a) forward through the kernel ----------------------------------
    # Each mlstm block's input is captured on the way, so that every block
    # can be held to its plain version (and to the recurrent cells) on the
    # very inputs the main path gave it: end to end the bf16 model is too
    # ill-conditioned for a logit comparison to test the kernel (see
    # _perturbed_plain below).
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)).cuda()
    apply_mlstm = ssm.apply_mlstm
    captured = []

    def capturing(bp, x, c, **kw):
        captured.append((bp, x))
        return apply_mlstm(bp, x, c, **kw)
    v = cfg.vocab_size
    with torch.no_grad():
        ssm.apply_mlstm = capturing
        try:
            mlstm_chunkwise_fwd.launches = 0
            fwd_s, logits = _wall_s(lambda: model.apply(params, tokens))
            fwd_launches = mlstm_chunkwise_fwd.launches
        finally:
            ssm.apply_mlstm = apply_mlstm
        log(f"[xlstm] (a) LM.apply B={b} S={s} through the kernel: "
            f"{fwd_s:.2f}s; mlstm_chunkwise_fwd launches {fwd_launches} "
            f"(expected {n_mlstm}, one per mlstm block)")
        if fwd_launches != n_mlstm or len(captured) != n_mlstm:
            raise AssertionError(f"mlstm_chunkwise_fwd launched "
                                 f"{fwd_launches} times, expected {n_mlstm}")
        if logits.shape != (b, s, v) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        # every block: the kernel's output against the plain version's,
        # and the recurrent cells' (generate's path) over the first
        # XLSTM_PROMPT positions, on the main path's own inputs
        p = XLSTM_PROMPT
        blk = {"kernel_vs_plain": [0.0, 0.0], "recurrent_vs_kernel": [0.0, 0.0],
               "grad_kernel_vs_plain": [0.0, 0.0]}
        for i, (bp, x) in enumerate(captured):
            out_k = apply_mlstm(bp, x, cfg)
            out_p = apply_mlstm(bp, x, cfg, impl="reference")
            out_r, _ = apply_mlstm(bp, x[:, :p], cfg, decode=True)
            for key, got, want in (
                    ("kernel_vs_plain", out_k, out_p),
                    ("recurrent_vs_kernel", out_r, out_k[:, :p])):
                e = held_to_plain("xlstm", f"mlstm block {i} output, "
                                  f"{key.replace('_', ' ')}",
                                  got.flatten(0, 1), want.flatten(0, 1),
                                  "bfloat16", unbounded=True)
                blk[key] = [max(a, c) for a, c in zip(blk[key], e)]
            # backward: the gradients of the block's input and weights
            # for one seeded upstream gradient, kernel path vs plain path
            gen = torch.Generator(device="cuda")
            gen.manual_seed(100 + i)
            g = torch.randn(out_k.shape, generator=gen,
                            device="cuda").to(out_k.dtype)
            grads = {}
            for impl in (None, "reference"):
                leaves = {k: t.detach().requires_grad_()
                          for k, t in bp.items()}
                xg = x.detach().requires_grad_()
                with torch.enable_grad():
                    out = apply_mlstm(leaves, xg, cfg, impl=impl)
                    grads[impl] = torch.autograd.grad(
                        out, [xg, *leaves.values()], g)
            for name, got, want in zip(["x", *bp], grads[None],
                                       grads["reference"]):
                e = held_to_plain("xlstm", f"mlstm block {i} gradient of "
                                  f"{name}, kernel vs plain",
                                  got.reshape(got.shape[0], -1)
                                  if got.dim() > 1 else got[None],
                                  want.reshape(want.shape[0], -1)
                                  if want.dim() > 1 else want[None],
                                  "bfloat16", unbounded=True)
                blk["grad_kernel_vs_plain"] = [
                    max(a, c) for a, c in zip(blk["grad_kernel_vs_plain"], e)]
        del captured, out_k, out_p, out_r, grads
        ref_s, ref = _wall_s(lambda: model.apply(params, tokens,
                                                 impl="reference"))
        with _perturbed_h():
            base = model.apply(params, tokens, impl="reference")
    fwd_err = _logit_err(logits, ref)
    base_err = _logit_err(base, ref)
    last_prompt = logits[:, XLSTM_PROMPT - 1].float()
    last_base = (base_err, _logit_err(base[:, XLSTM_PROMPT - 1],
                                      ref[:, XLSTM_PROMPT - 1]))
    del logits, ref, base
    log(f"[xlstm] (a) end to end, kernel vs plain path ({ref_s:.2f}s): "
        f"logits differ by {fwd_err[0]:.4f}, {fwd_err[1]:.3f} of their scale "
        f"(median position {fwd_err[2]:.3f}); the plain path against itself "
        f"with 1% of every mlstm h moved by one bf16 ulp: {base_err[0]:.4f}, "
        f"{base_err[1]:.3f} (median {base_err[2]:.3f})")
    _end_to_end_gate("LM.apply logits", fwd_err[1], base_err[1], LOGIT_TOL)

    # ---- (c) serving through the recurrent cells --------------------------
    prompts = tokens[:, :XLSTM_PROMPT].cpu().numpy()
    serve = ServeConfig(max_seq_len=XLSTM_PROMPT + XLSTM_NEW + 1, top_k=1)
    engine = ServeEngine(model=model, params=params, cfg=cfg, serve=serve)
    seen = {}
    decode = engine._decode

    def recording(tok, cache, pos):
        out, cache = decode(tok, cache, pos)
        if pos == XLSTM_PROMPT - 1:
            seen["logits"] = out.float()
        return out, cache
    engine._decode = recording
    mlstm_chunkwise_fwd.launches = 0
    gen_s, out = _wall_s(lambda: engine.generate(prompts, XLSTM_NEW))
    engine._decode = decode
    if mlstm_chunkwise_fwd.launches != 0:
        raise AssertionError("generate launched the chunkwise kernel")
    out = out.cpu().numpy()
    if out.shape != (b, XLSTM_NEW) or not ((0 <= out) & (out < v)).all():
        raise AssertionError(f"bad generated tokens {out.shape}")
    dec_err = _logit_err(seen["logits"], last_prompt)
    log(f"[xlstm] (c) recurrent decode_step logits at position "
        f"{XLSTM_PROMPT - 1} vs (a)'s kernel LM.apply: {dec_err[0]:.4f}, "
        f"{dec_err[1]:.3f} of their scale; the perturbed plain path there: "
        f"{last_base[1][0]:.4f}, {last_base[1][1]:.3f}")
    _end_to_end_gate("decode_step logits", dec_err[1], last_base[1][1],
                     LOGIT_TOL)
    steps = XLSTM_PROMPT + XLSTM_NEW - 1
    tok_s = engine.throughput_tokens_per_s(b, XLSTM_PROMPT, n_new=8)
    log(f"[xlstm] (c) generate B={b} x {XLSTM_PROMPT} prompt + {XLSTM_NEW} "
        f"greedy: {gen_s:.2f}s for {steps} decode steps "
        f"({gen_s / steps * 1e3:.1f} ms a step, {b * XLSTM_NEW / gen_s:.1f} "
        f"new tok/s, prompt teacher-forced); throughput_tokens_per_s(B={b}, "
        f"prompt {XLSTM_PROMPT}, 8 steps) {tok_s:.1f} tok/s")
    # where a decode step's device time goes: 9 decode steps (a 4-token
    # prompt, one warm-up step and 4 timed ones) under the profiler
    dec_kernels, dec_dev = _profile_kernels(
        lambda: engine.throughput_tokens_per_s(b, 4, n_new=4))
    dec_groups = {}
    for e in dec_kernels:
        grp = _train_group(e.key)
        dec_groups[grp] = dec_groups.get(grp, 0.0) + _device_us(e) / 9e6
    dec_step_dev = dec_dev / 9
    log(f"[xlstm] (c) a decode step: {dec_step_dev * 1e3:.2f} ms of kernels "
        f"against {gen_s / steps * 1e3:.1f} ms of wall (idle share "
        f"{1 - dec_step_dev / (gen_s / steps):.3f}), "
        f"{sum(e.count for e in dec_kernels) / 9:.0f} kernels a step")
    for grp, sec in sorted(dec_groups.items(), key=lambda kv: -kv[1]):
        log(f"[xlstm]   {sec * 1e3:9.3f} ms  {grp}")
    del engine, seen, last_prompt, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) training -------------------------------------------------------
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=XLSTM_STEPS)
    state = init_train_state(model, model.generator(tcfg.seed))
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    data = TokenPipeline(DataConfig(vocab_size=v, seq_len=s,
                                    global_batch=b))
    mlstm_chunkwise_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(XLSTM_STEPS):
        batch = to_device(data.next(), model.device)
        dt, (state, metrics) = _wall_s(lambda: step_fn(state, batch))
        step_s.append(dt)
        losses.append(float(metrics["loss"]))
        log(f"[xlstm] (b) step {i} loss {losses[-1]:.4f} gnorm "
            f"{float(metrics['grad_norm']):.4f} {dt * 1e3:.1f} ms")
    launches = mlstm_chunkwise_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = n_mlstm * (2 if parallel.remat != "none" else 1) * XLSTM_STEPS
    log(f"[xlstm] (b) mlstm_chunkwise_fwd launches on the training path: "
        f"{launches} (expected {n_mlstm} blocks x 2 forward passes under "
        f"remat x {XLSTM_STEPS} steps = {expected})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"mlstm_chunkwise_fwd launched {launches} "
                             f"times, expected {expected}")
    steady_s = statistics.median(step_s[1:])
    train_tok_s = b * s / steady_s

    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        mgr.save(XLSTM_STEPS, state, extras={"data": data.state()})
        restored, _ = mgr.restore(state)
        for (path, x), y in zip(tree.leaves_with_paths(restored),
                                tree.leaves(state)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"checkpoint leaf {path} changed")
        del restored
    log("[xlstm] (b) checkpoint saved and restored bit for bit")

    # kernel path vs plain path on one batch: loss and gradient norm,
    # beside the plain path under _perturbed_h
    one = to_device(data.next(), model.device)
    (k_loss, k_gn), (p_loss, p_gn) = (
        _loss_and_gnorm(model, state.params, one, impl)
        for impl in (None, "reference"))
    # both paths again under two perturbations of h each (seeded)
    perturbed = {impl: [] for impl in ("reference", "kernel")}
    for impl, runs in perturbed.items():
        for seed in (9, 10):
            with _perturbed_h(seed, impl):
                runs.append(_loss_and_gnorm(model, state.params, one,
                                            "reference"))
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    gn_rel = abs(k_gn - p_gn) / abs(p_gn)
    base_loss = max(abs(q - p_loss) / abs(p_loss)
                    for q, _ in perturbed["reference"])
    base_gn = max(abs(q - p_gn) / abs(p_gn)
                  for _, q in perturbed["reference"])
    log(f"[xlstm] (b) kernel vs plain path, {b} x {s}: loss {k_loss:.5f} vs "
        f"{p_loss:.5f} (rel {loss_rel:.2e}), grad norm {k_gn:.5f} vs "
        f"{p_gn:.5f} (rel {gn_rel:.2e})")
    for impl, runs in perturbed.items():
        log(f"[xlstm] (b) the {impl} path under two perturbations of h: "
            f"losses {', '.join(f'{q:.5f}' for q, _ in runs)}, grad norms "
            f"{', '.join(f'{q:.5f}' for _, q in runs)}")
    _end_to_end_gate("loss", loss_rel, base_loss, LOSS_RTOL)
    # the gradient norm of this model is heavy-tailed (a position where
    # |q.n| nearly cancels contributes ~1/den^2), so end to end it is only
    # guarded against exploding: within a factor of 2
    if not (math.isfinite(k_gn) and 0.5 <= k_gn / p_gn <= 2.0):
        raise AssertionError(f"grad norm {k_gn} against the plain path's "
                             f"{p_gn}")

    # one more step under the profiler: where the device time goes
    batch = to_device(data.next(), model.device)
    kernels, total_s = _profile_kernels(lambda: step_fn(state, batch))
    ml = [e for e in kernels if MLSTM_KERNELS in e.key]
    ml_s = sum(_device_us(e) for e in ml) / 1e6
    groups = {}
    for e in kernels:
        grp = _train_group(e.key)
        groups[grp] = groups.get(grp, 0.0) + _device_us(e) / 1e6

    # the sLSTM time loop alone: one slstm block's forward and backward at
    # the training shape, wall time and device time
    layer = kinds.index("slstm")
    bp = state.params["layers"][layer]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    g = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    pos = torch.arange(s, device="cuda").expand(b, s)

    def slstm_fwd():
        with torch.no_grad():
            return B.apply_block(bp, x, cfg, "slstm", positions=pos)

    def slstm_fwd_bwd():
        y = B.apply_block(bp, x, cfg, "slstm", positions=pos)
        return torch.autograd.grad(y, x, g)
    sl_fwd_s, _ = _wall_s(slstm_fwd)
    sl_fb_s, _ = _wall_s(slstm_fwd_bwd)
    _, sl_fwd_dev = _profile_kernels(slstm_fwd)
    _, sl_fb_dev = _profile_kernels(slstm_fwd_bwd)
    n_sl = kinds.count("slstm")
    # a step runs each block's forward twice (remat) and its backward once
    sl_wall = n_sl * (sl_fwd_s + sl_fb_s)
    sl_dev = n_sl * (sl_fwd_dev + sl_fb_dev)
    del x, g

    out = {"layers": cfg.num_layers, "params": n_params, "batch": b,
           "seq": s, "forward_s": fwd_s, "forward_plain_s": ref_s,
           "forward_launches": fwd_launches,
           "forward_logit_err": fwd_err, "perturbed_plain_logit_err": base_err,
           "block_kernel_vs_plain": blk["kernel_vs_plain"],
           "block_recurrent_vs_kernel": blk["recurrent_vs_kernel"],
           "block_grad_kernel_vs_plain": blk["grad_kernel_vs_plain"],
           "generate_s": gen_s,
           "generate_ms_per_step": gen_s / steps * 1e3,
           "generate_new_tok_s": b * XLSTM_NEW / gen_s,
           "decode_step_device_ms": dec_step_dev * 1e3,
           "decode_step_idle_share": 1 - dec_step_dev / (gen_s / steps),
           "decode_step_groups_ms": {k: x * 1e3 for k, x in
                                     dec_groups.items()},
           "throughput_tokens_per_s": tok_s, "decode_logit_err": dec_err,
           "perturbed_plain_logit_err_at_prompt_end": last_base[1],
           "steps": XLSTM_STEPS,
           "losses": losses, "step_s": step_s, "steady_step_s": steady_s,
           "tok_s": train_tok_s, "peak_mem_gb": peak_gb,
           "launches": launches, "loss_rel": loss_rel, "gnorm_rel": gn_rel,
           "perturbed_loss_rel": base_loss, "perturbed_gnorm_rel": base_gn,
           "perturbed_loss_gnorm": perturbed, "loss_gnorm": [
               [k_loss, k_gn], [p_loss, p_gn]],
           "profiled_kernel_s": total_s, "mlstm_s": ml_s,
           "mlstm_calls": sum(e.count for e in ml),
           "mlstm_share_of_kernels": ml_s / total_s,
           "mlstm_share_of_step": ml_s / steady_s,
           "idle_share": 1.0 - total_s / steady_s,
           "groups_s": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "slstm_block_fwd_s": sl_fwd_s, "slstm_block_fwd_bwd_s": sl_fb_s,
           "slstm_block_fwd_device_s": sl_fwd_dev,
           "slstm_block_fwd_bwd_device_s": sl_fb_dev,
           "slstm_share_of_step": sl_wall / steady_s,
           "slstm_share_of_kernels": sl_dev / total_s,
           "card": _card()}
    log(f"[xlstm] (b) {out['card']}: steady step {steady_s * 1e3:.1f} ms "
        f"(median of steps 1-{XLSTM_STEPS - 1}), {train_tok_s:.0f} tok/s, "
        f"peak memory {peak_gb:.1f} GB")
    log(f"[xlstm] (b) profiled step: kernels {total_s:.4f}s (idle share "
        f"{out['idle_share']:.3f}); mlstm_chunkwise.cu {ml_s:.4f}s in "
        f"{out['mlstm_calls']} CUDA kernels (gates, states, outputs a "
        f"wrapper launch; {out['mlstm_share_of_kernels']:.1%}"
        f" of kernel time, {out['mlstm_share_of_step']:.1%} of the step)")
    log(f"[xlstm] (b) sLSTM time loop, one block at {b} x {s}: forward "
        f"{sl_fwd_s:.3f}s wall / {sl_fwd_dev:.4f}s device, forward + "
        f"backward {sl_fb_s:.3f}s / {sl_fb_dev:.4f}s; the step's {n_sl} "
        f"blocks (forward, remat recompute, backward): "
        f"{out['slstm_share_of_step']:.1%} of the step's wall time, "
        f"{out['slstm_share_of_kernels']:.1%} of its kernel time")
    for grp, sec in out["groups_s"].items():
        log(f"[xlstm]   {sec:9.4f}s  {grp}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        log(f"[xlstm]   {_device_us(e) / 1e6:9.4f}s {e.count:6d}x "
            f"{e.key[:90]}")
    log("[xlstm] " + json.dumps(out))
    return out


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
    model, params = build_llama()
    served = phase_serving(model, params)
    dense = phase_dense(model, params)
    long_step = phase_long_decode(model, params, dense["kv_rms"])
    del model, params
    gc.collect()                  # phase 3's model, pools and engines
    torch.cuda.empty_cache()
    log(f"[train] {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        "allocated after serving")
    trained = phase_training()
    gc.collect()                  # phase 4's model and optimizer state
    torch.cuda.empty_cache()
    phase_offload()
    gc.collect()                  # phase 5's host engine and caches
    torch.cuda.empty_cache()
    xlstm = phase_xlstm()
    launches = {**served["launches"], "fastattn_fwd": trained["launches"],
                "flash_decode": dense["launches"],
                "mlstm_chunkwise": xlstm["launches"]}
    kern["flash_decode"] = dense["kernel"]
    sources = {"paged_decode": (
        "src/repro_torch/kernels/flash_decode/csrc/paged_decode.cu",
        "src/repro/kernels/flash_decode/kernel.py:171"),
        "paged_prefill": (
        "src/repro_torch/kernels/fastattn/csrc/paged_prefill.cu",
        "src/repro/kernels/fastattn/kernel.py:322"),
        "fastattn_fwd": (
        "src/repro_torch/kernels/fastattn/csrc/fastattn_fwd.cu",
        "src/repro/kernels/fastattn/kernel.py:156"),
        "flash_decode": (
        "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode/kernel.py:87"),
        "mlstm_chunkwise": (
        "src/repro_torch/kernels/mlstm/csrc/mlstm_chunkwise.cu",
        "src/repro/kernels/mlstm/kernel.py:116")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1],
         "launches": launches[name],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"],
         "device_ms": kern[name]["device_ms"]}
        for name in ("paged_prefill", "paged_decode", "fastattn_fwd",
                     "flash_decode", "mlstm_chunkwise")]}
    # flash_decode also at the long shape (phase 2's LONG_DECODE), and the
    # long-context decode step it carries (phase 3c)
    long = kern["flash_decode_long"]
    next(k for k in line["kernels"] if k["name"] == "flash_decode").update(
        long_device_ms=long["device_ms"], long_bound_ms=long["bound_ms"],
        long_library_device_ms=long["library_device_ms"],
        long_step_device_ms=long_step["device_ms"],
        long_step_wall_ms=long_step["wall_ms"])
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
