"""Process groups for tensor-parallel serving, and the ranks' launcher.

The JAX package binds one controller to a device mesh (``make_mesh``);
the port runs one process per rank over ``torch.distributed``.  Rank
``r`` is mesh coordinate ``(gi, si) = divmod(r, s)`` of a plan's
``(g, s)`` factoring (``sharding/tp.py``): its O-proj and down-proj
partial sums all-reduce over the whole world, its LSE merge over the
page-row subgroup ``[gi * s, (gi + 1) * s)``.

    results = spawn_ranks(body, 2, args=(...,), backend="gloo",
                          init_method=f"file://{tmp}/pg")

runs ``body(rank, *args)`` in ``tp`` fresh processes (the ``spawn``
start method), each inside a process group made by ``init_tp_group``,
and returns their results in rank order.  The backend is the caller's
choice: ``"gloo"`` for CPU tensors and for several ranks sharing one
GPU (it stages CUDA tensors through the host), ``"nccl"`` for one GPU a
rank.
"""
from __future__ import annotations

import datetime
import queue
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sharding.tp import make_seq_groups


def init_tp_group(tp: int, rank: int, *, backend: str, init_method: str,
                  timeout: float = 60.0) -> None:
    """Join the world of ``tp`` ranks and create every page-row subgroup
    a plan over this world can ask for (``sharding.tp.make_seq_groups``).
    ``timeout`` (seconds) bounds every collective, so a rank that dies
    fails the others instead of hanging them."""
    td = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=tp, rank=rank, timeout=td)
    make_seq_groups(tp, td)


def _rank_main(fn, rank, tp, device, backend, init_method, init_timeout,
               args, results) -> None:
    try:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        init_tp_group(tp, rank, backend=backend, init_method=init_method,
                      timeout=init_timeout)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, tp: int, *, args: Sequence = (),
                device_of_rank: Optional[Callable[[int], str]] = None,
                backend: str, init_method: str, timeout_s: float = 240.0,
                init_timeout_s: float = 60.0) -> list:
    """Run ``fn(rank, *args)`` on ``tp`` spawned ranks and return their
    results in rank order.

    ``fn`` must be importable by name (a module-level function) and
    return something picklable; ``args`` may hold CUDA tensors, which
    reach the ranks by CUDA IPC (the caller keeps them alive).  Each rank
    first pins ``device_of_rank(rank)`` when it is a CUDA device.  A rank
    that raises makes this raise RuntimeError with its traceback; past
    ``timeout_s`` every rank is killed and this raises TimeoutError.
    Every process started here is stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, tp, device_of_rank(r) if device_of_rank else None,
              backend, init_method, init_timeout_s, tuple(args), results))
        for r in range(tp)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out: dict = {}
    try:
        while len(out) < tp:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{tp} ranks: no result from ranks "
                    f"{sorted(set(range(tp)) - set(out))} within "
                    f"{timeout_s:g}s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {tp} failed:\n{val}")
            out[rank] = val
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(out) == tp else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(tp)]
