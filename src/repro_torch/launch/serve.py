"""Serving entry point of the port: dense batched generation (the
default), or the persistent paged EngineCore (``--stream``).

    # dense static-batch generation: ServeEngine.generate, decode attention
    # through the CUDA flash_decode kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --batch 4 --prompt-len 64 --gen 16

    # iteration-level serving: EngineCore.add_request/step with
    # per-request SamplingParams (every 3rd request samples, seeded)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --stream --requests 8 --prompt-len 24 --gen 12 [--metrics]

    # the paper's cooperative-offload plan (Eq. 15-20) for the run's shape
    PYTHONPATH=src python -m repro_torch.launch.serve --offload-report ...

``--device`` defaults to ``cuda`` and the run fails without a GPU;
``--device cpu`` runs the plain PyTorch path (with ``--smoke`` for the
reduced configs).  ``--spec-mode lookup`` is refused: speculative decoding
is not ported.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.config import (ParallelConfig, ServeConfig,
                                get_model_config, reduce_for_smoke)
from repro_torch.core.offload import max_context_length, plan_offload
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import build_model
from repro_torch.serving.core import EngineCore
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.faults import RequestRejected
from repro_torch.serving.scheduler import SamplingParams


def _run_stream(model, params, cfg, args) -> None:
    """Drive the persistent EngineCore directly: submit a queue of
    requests with mixed per-request SamplingParams, step the engine,
    and print tokens as they stream out."""
    page_size = 128 if model.device.type == "cuda" else 16
    serve = ServeConfig(
        max_batch=min(4, args.requests),
        max_seq_len=args.prompt_len + args.gen + page_size,
        page_size=page_size,
        max_waiting=args.max_waiting,
        queue_policy=args.queue_policy)
    core = EngineCore(model, params, cfg, serve, device=model.device)
    rng = np.random.default_rng(0)
    # --top-k 1 (the dense-path greedy default) would make the "sampled"
    # requests greedy too; give them a real truncation instead
    stream_top_k = args.top_k if args.top_k not in (0, 1) else 8
    deadline = args.deadline_ms if args.deadline_ms > 0 else None
    for i in range(args.requests):
        if i % 3 == 2:
            sp = SamplingParams(temperature=0.8, top_k=stream_top_k,
                                seed=i, max_new_tokens=args.gen,
                                deadline_ms=deadline)
        else:
            sp = SamplingParams(max_new_tokens=args.gen,
                                deadline_ms=deadline)   # greedy
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len)
        try:
            core.add_request(prompt, sp)
        except RequestRejected as e:
            # queue_policy="reject" surfaces a structured error at
            # submission; the engine keeps serving what it admitted
            print(f"rejected: {e.detail}")
    t0 = time.perf_counter()
    n_events = 0
    while core.has_work:
        for ev in core.step():
            if ev.kind == "error":
                print(f"req {ev.request_id} failed: {ev.detail}")
                continue
            n_events += 1
            if ev.finished:
                print(f"req {ev.request_id} finished "
                      f"({ev.index + 1} tokens)")
    synchronize(model.device)
    dt = time.perf_counter() - t0
    s = core.stats()
    print(f"{n_events} tokens in {dt:.2f}s ({n_events / dt:.1f} tok/s), "
          f"{s['steps']} engine steps, peak pool "
          f"{s['pages_peak']}/{core.mgr.usable_pages} pages "
          f"({s['peak_utilization']:.0%})")
    h = s["health"]
    print(f"health: {h['failed']} failed, {h['shed']} shed, "
          f"{h['timed_out']} timed out, slowest step "
          f"{h['step_s_high_water'] * 1e3:.1f}ms"
          + (f", last error: {h['last_error']}" if h["last_error"] else ""))
    if core.tracer is not None and core.tracer.completed:
        ttfts = sorted(r["first_token_t"] - r["submit_t"]
                       for r in core.tracer.completed
                       if r["first_token_t"] is not None)
        if ttfts:
            print(f"engine-native TTFT: p50 "
                  f"{ttfts[len(ttfts) // 2] * 1e3:.1f}ms, max "
                  f"{ttfts[-1] * 1e3:.1f}ms over {len(ttfts)} requests")
    if args.metrics is not None:
        print("---- prometheus " + "-" * 48)
        print(core.export_prometheus(), end="")
        if args.metrics != "-":
            with open(args.metrics, "w") as f:
                json.dump(core.chrome_trace(), f)
            print(f"---- chrome trace ({len(core.flight.records)} steps) "
                  f"written to {args.metrics}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--top-k", type=int, default=1)
    ap.add_argument("--offload-report", action="store_true",
                    help="print the cooperative-offload plan (paper Eq. "
                         "15-20) and the longest context it supports")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the paged EngineCore "
                         "(add_request/step) instead of dense generate")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests to stream (with --stream)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline in ms (0 = none; expired "
                         "requests are shed with a structured timeout)")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="bound on the waiting queue (0 = unbounded)")
    ap.add_argument("--queue-policy", default="reject",
                    choices=["reject", "shed_oldest"],
                    help="full-queue policy: reject new arrivals or "
                         "shed the oldest waiting request")
    ap.add_argument("--spec-mode", default="off",
                    choices=["off", "lookup"],
                    help="speculative decoding: only 'off' is ported")
    ap.add_argument("--metrics", nargs="?", const="-", default=None,
                    metavar="TRACE_JSON",
                    help="with --stream: print the Prometheus text "
                         "exposition at end of run; with a path, also "
                         "write the flight recorder's Chrome trace_event "
                         "JSON there (load in chrome://tracing)")
    args = ap.parse_args(argv)
    if args.spec_mode != "off":
        raise NotImplementedError(
            f"--spec-mode {args.spec_mode}: speculative decoding is not "
            "ported yet")

    cfg = get_model_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    parallel = ParallelConfig(remat="none")
    device = resolve_device(args.device)
    model = build_model(cfg, device, parallel)

    if args.offload_report:
        plan = plan_offload(cfg, batch=args.batch,
                            seq_len=args.prompt_len + args.gen,
                            gen_len=args.gen, n_devices=1,
                            device_memory_gb=parallel.device_memory_gb)
        print("T4 offload plan:", plan.summary())
        ctx = max_context_length(cfg, batch=args.batch, n_devices=1,
                                 device_memory_gb=parallel.device_memory_gb,
                                 host_memory_gb=parallel.host_memory_gb)
        print(f"T4 max context: {ctx['device_only']} tokens on the device "
              f"alone, {ctx['cooperative']} with cooperative offload "
              f"({parallel.device_memory_gb:g} GB device, "
              f"{parallel.host_memory_gb:g} GB host)")

    params = model.init(model.generator(0))
    if args.stream:
        _run_stream(model, params, cfg, args)
        return
    serve = ServeConfig(max_seq_len=args.prompt_len + args.gen + 1,
                        top_k=args.top_k)
    engine = ServeEngine(model=model, params=params, cfg=cfg, serve=serve)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len))
    t0 = time.perf_counter()
    out = engine.generate(tokens, args.gen)
    synchronize(device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", out[0, :16].tolist())


if __name__ == "__main__":
    main()
