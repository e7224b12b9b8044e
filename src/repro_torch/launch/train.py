"""End-to-end training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \
        --steps 50 --batch 8 --seq 256 [--smoke] [--device cuda]

The JAX package's ``launch/train.py`` on one device: data pipeline ->
train step (attention through the CUDA ``fastattn_fwd`` kernel on the
card) -> checkpointing -> fault-tolerance hooks.  ``--smoke`` shrinks the
arch to the reduced config.  ``--device`` defaults to ``cuda`` and the
run fails without a GPU; ``--device cpu`` runs the plain PyTorch path.
``--data`` / ``--model-axis`` above 1 are refused (one device).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.config import (ParallelConfig, TrainConfig,
                                get_model_config, reduce_for_smoke)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import (CadenceController,
                                                  StragglerDetector)
from repro_torch.training.train_step import (init_train_state,
                                             make_train_step)


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.data != 1 or args.model_axis != 1:
        ap.error("--data and --model-axis above 1 are not supported: the "
                 "port trains on one device")

    cfg = get_model_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    parallel = ParallelConfig(microbatches=args.microbatches,
                              remat="selective")
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.ckpt_every)
    device = resolve_device(args.device)
    model = build_model(cfg, device, parallel)
    ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
    cadence = CadenceController()
    stragglers = StragglerDetector()
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))

    state = init_train_state(model, model.generator(tcfg.seed))
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, manifest = ckpt.restore(state)
        start = manifest["step"]
        data.restore(manifest["extras"]["data"])
        print(f"resumed from step {start}")
    step_fn = make_train_step(model, cfg, parallel, tcfg)

    host = "host0"
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, to_device(data.next(), device))
        if step % 5 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])       # waits for the step
            dt = time.perf_counter() - t0
            tok_s = args.batch * args.seq / dt
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"{tok_s:9.0f} tok/s", flush=True)
        stragglers.record(host, time.perf_counter() - t0)
        cadence.record_steps()
        every = min(tcfg.checkpoint_every, cadence.cadence())
        if (step + 1) % every == 0:
            ckpt.save(step + 1, state, extras={"data": data.state()},
                      async_=True)
    ckpt.wait()
    ckpt.save(args.steps, state, extras={"data": data.state()})
    print(f"done; final checkpoint at step {args.steps} in "
          f"{tcfg.checkpoint_dir}")


if __name__ == "__main__":
    main()
