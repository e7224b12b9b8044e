"""End-to-end training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \\
        --steps 50 --batch 8 --seq 256 [--smoke] [--device cuda] \\
        [--data 2 --model-axis 2]

The JAX package's ``launch/train.py``: data pipeline -> train step
(attention through the CUDA ``fastattn_fwd`` kernel on the card) ->
checkpointing -> fault-tolerance hooks.  ``--smoke`` shrinks the arch to
the reduced config (``smoke_config``).  ``--device`` defaults to ``cuda``
and the run fails without a GPU; ``--device cpu`` runs the plain PyTorch
path.  An encoder-decoder arch (whisper-small) is refused
(``check_trainable``): the pipeline makes no frame embeddings.

``--data`` / ``--model-axis`` above 1 spawn ``data x model`` ranks
(``launch/mesh.spawn_ranks``), each training its piece of the
``(data, model)`` mesh (``training/train_step.py``): over NCCL with one
GPU a rank where ``torch.cuda.device_count()`` covers them, else over
gloo with the ranks sharing the card (or on the CPU).  Every rank draws
the same global batch and keeps its rows; rank 0 prints the steps and
writes the checkpoints.  Every decoder-only family trains on such a
mesh, the recurrent ones (xlstm-125m, hymba-1.5b) with their channels
and heads over the model axis.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.config import (ParallelConfig, TrainConfig,
                                get_model_config, reduce_for_smoke)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for, spawn_ranks, train_backend
from repro_torch.models import build_model
from repro_torch.sharding.rules import axis_rules
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import (CadenceController,
                                                  StragglerDetector)
from repro_torch.training.train_step import (init_train_state,
                                             make_train_step, state_specs)


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# the smallest head dim the attention kernels are built for
# (kernels/_launch.HEAD_DIMS)
CARD_SMOKE_HEAD_DIM = 64


def smoke_config(cfg, device: torch.device):
    """``reduce_for_smoke(cfg)``: head dim 16 on the CPU, as the JAX
    package's; on the card ``CARD_SMOKE_HEAD_DIM`` (the widths scaled with
    it), since the attention kernels take no head dim 16 and a CUDA
    tensor never falls back to the plain version."""
    small = reduce_for_smoke(cfg)
    if device.type != "cuda":
        return small
    d = small.num_heads * CARD_SMOKE_HEAD_DIM
    return dataclasses.replace(small, head_dim=CARD_SMOKE_HEAD_DIM,
                               d_model=d, d_ff=4 * d if small.d_ff else 0)


def check_trainable(cfg) -> None:
    """The launcher feeds ``TokenPipeline`` batches ({"tokens",
    "labels"}); an encoder-decoder also needs "enc_embeds", and the vision
    stub trains on "inputs_embeds" and "positions" instead of tokens,
    which no pipeline of either package makes (the JAX launcher cannot
    train them either): raise NotImplementedError naming the missing
    inputs."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder trains on batches of "
            "enc_embeds, tokens and labels, and TokenPipeline has no "
            "enc_embeds (frame embeddings); drive training.train_step "
            "with such batches directly")
    if cfg.modality == "vision_stub":
        raise NotImplementedError(
            f"{cfg.name}: the vision stub trains on batches of "
            "inputs_embeds, positions and labels, and TokenPipeline has "
            "no inputs_embeds (patch embeddings) or positions (M-RoPE's "
            "t, h, w); drive training.train_step with such batches "
            "directly")


def run(args, mesh=None) -> None:
    """The training loop of one process: the whole run, or one rank's
    share of it on ``mesh``."""
    device = resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        # spawn_ranks pinned this rank's GPU
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_model_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg, device)
    parallel = ParallelConfig(data=args.data, model=args.model_axis,
                              microbatches=args.microbatches,
                              remat="selective")
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.ckpt_every)
    lead = mesh is None or mesh.rank == 0
    model = build_model(cfg, device, parallel)
    cadence = CadenceController()
    stragglers = StragglerDetector()
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))

    with axis_rules(mesh=mesh):
        state = init_train_state(model, model.generator(tcfg.seed))
        specs = (state_specs(model.param_specs(mesh))
                 if mesh is not None else None)
        ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                 keep=tcfg.keep_checkpoints, mesh=mesh,
                                 specs=specs)
        start = 0
        if args.resume and ckpt.latest_step() is not None:
            state, manifest = ckpt.restore(state)
            start = manifest["step"]
            data.restore(manifest["extras"]["data"])
            if lead:
                print(f"resumed from step {start}")
        step_fn = make_train_step(model, cfg, parallel, tcfg)

    host = f"host{mesh.rank if mesh is not None else 0}"
    for step in range(start, args.steps):
        t0 = time.perf_counter()  # repro-lint: disable=raw-wall-clock (CLI wall time)
        state, metrics = step_fn(state, to_device(data.next(), device))
        if lead and (step % 5 == 0 or step == args.steps - 1):
            loss = float(metrics["loss"])       # waits for the step
            dt = time.perf_counter() - t0  # repro-lint: disable=raw-wall-clock (CLI wall time)
            tok_s = args.batch * args.seq / dt
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"{tok_s:9.0f} tok/s", flush=True)
        stragglers.record(host, time.perf_counter() - t0)  # repro-lint: disable=raw-wall-clock (straggler step time)
        cadence.record_steps()
        every = min(tcfg.checkpoint_every, cadence.cadence())
        if (step + 1) % every == 0:
            ckpt.save(step + 1, state, extras={"data": data.state()},
                      async_=True)
    ckpt.wait()
    ckpt.save(args.steps, state, extras={"data": data.state()})
    if mesh is not None:
        print(f"rank {mesh.rank} {mesh.coords}: {dist.get_backend()} on "
              f"{device}", flush=True)
    if lead:
        print(f"done; final checkpoint at step {args.steps} in "
              f"{tcfg.checkpoint_dir}")


def rank_main(rank: int, args) -> None:
    """One spawned rank of ``main``: its mesh, then ``run``."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    parallel = ParallelConfig(data=args.data, model=args.model_axis)
    run(args, make_mesh_for(parallel))


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
    check_trainable(get_model_config(args.arch))
    world = args.data * args.model_axis
    if world == 1:
        run(args)
        return
    device = resolve_device(args.device)
    backend, dev_of = train_backend(device, world)
    print(f"{world} ranks (data={args.data}, model={args.model_axis}) over "
          f"{backend} on {[dev_of(r) for r in range(world)]}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(rank_main, world, args=(args,), device_of_rank=dev_of,
                    backend=backend, init_method=f"file://{tmp}/pg",
                    timeout_s=3600.0, init_timeout_s=600.0)


if __name__ == "__main__":
    main()
