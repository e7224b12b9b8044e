"""Process groups for tensor-parallel serving and for the training mesh,
and the ranks' launcher.

The JAX package binds one controller to a device mesh (``make_mesh``);
the port runs one process per rank over ``torch.distributed``.

Serving: rank ``r`` is mesh coordinate ``(gi, si) = divmod(r, s)`` of a
plan's ``(g, s)`` factoring (``sharding/tp.py``): its O-proj and
down-proj partial sums all-reduce over the whole world, its LSE merge
over the page-row subgroup ``[gi * s, (gi + 1) * s)``.

Training: ``make_mesh_for(parallel)`` binds this rank to a ``Mesh`` of
``parallel.mesh_axes()`` / ``mesh_shape()``; rank ``r`` is the row-major
coordinate of ``r`` in that shape (``jax.make_mesh``'s device order), and
the mesh holds a process group for every set of axes a collective can
run over.

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
import gc
import itertools
import math
import os
import queue
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.config import ParallelConfig
from repro_torch.sharding.tp import make_seq_groups


@dataclass(frozen=True, eq=False)
class Mesh:
    """A device mesh as this rank sees it: axis names, sizes, this rank's
    coordinates and, after ``make_mesh_for``, one process group per set
    of axes (the ranks that differ only along those axes).  ``shape``
    maps each name to its size, as a JAX mesh's does, so the rule
    functions of ``sharding/rules.py`` take either."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0
    groups: dict = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> dict:
        """Axis name -> this rank's coordinate (row-major in ``sizes``)."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            r, out[name] = divmod(r, n)
        return {a: out[a] for a in self.axis_names}

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` holding this rank; None when
        the group is this rank alone (no collective to run)."""
        key = tuple(a for a in self.axis_names if a in axes)
        if self.size(key) == 1:
            return None
        if key not in self.groups:
            raise ValueError(f"mesh {self.shape}: no process group over "
                             f"{key} (make the mesh with make_mesh_for)")
        return self.groups[key]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              rank: int = 0) -> Mesh:
    """A mesh with no process groups, for the rule functions (the tests
    build JAX's production shapes with it)."""
    return Mesh(tuple(axes), tuple(shape), rank)


def make_mesh_for(parallel: ParallelConfig, *,
                  timeout: float = 60.0) -> Mesh:
    """This rank's mesh of ``parallel``'s shape.  With more than one rank
    the world must already be initialised with exactly
    ``pods * data * model`` ranks (``spawn_ranks`` does it); every rank
    calls this at the same point, since creating groups is collective."""
    axes, shape = parallel.mesh_axes(), parallel.mesh_shape()
    world = math.prod(shape)
    if world == 1:
        return Mesh(axes, shape)
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() != world:
        found = (dist.get_world_size() if dist.is_available()
                 and dist.is_initialized() else "no")
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs a "
                         f"torch.distributed world of {world} ranks, found "
                         f"{found}")
    rank = dist.get_rank()
    td = datetime.timedelta(seconds=timeout)
    groups: dict = {}
    # new_group is collective: every rank creates every group, in the
    # same order (subsets of axes, then the other axes' coordinates)
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            if math.prod(shape[i] for i in sub) == 1:
                continue
            key = tuple(axes[i] for i in sub)
            if k == len(axes):
                groups[key] = dist.group.WORLD
                continue
            others = [i for i in range(len(axes)) if i not in sub]
            for fixed in itertools.product(*(range(shape[i])
                                              for i in others)):
                members = []
                for varying in itertools.product(*(range(shape[i])
                                                   for i in sub)):
                    c = [0] * len(axes)
                    for i, v in zip(others, fixed):
                        c[i] = v
                    for i, v in zip(sub, varying):
                        c[i] = v
                    r = 0
                    for i, n in enumerate(shape):
                        r = r * n + c[i]
                    members.append(r)
                g = dist.new_group(sorted(members), timeout=td)
                if rank in members:
                    groups[key] = g
    return Mesh(axes, shape, rank, groups)


def parallel_for_mesh(mesh: Mesh) -> ParallelConfig:
    s = mesh.shape
    return ParallelConfig(pods=s.get("pod", 1), data=s.get("data", 1),
                          model=s.get("model", 1))


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
               box, results) -> None:
    try:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        init_tp_group(tp, rank, backend=backend, init_method=init_method,
                      timeout=init_timeout)
        # ``box`` is the only holder of the arguments here: a spawned
        # process ends without freeing its objects, and a CUDA tensor
        # received by IPC stays allocated in the sender until the
        # receiver frees it, so drop them before reporting
        args = box.pop()
        out = fn(rank, *args)
        del args
        gc.collect()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train_backend(device: torch.device, world: int) -> tuple:
    """(backend, device of each rank) for ``world`` ranks of the
    launchers (training, or serving at tp > 1) on ``device``'s type: NCCL
    with one GPU a rank where there are as many, else gloo (the ranks
    share cuda:0, or run on the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl", (lambda r: f"cuda:{r}")
    # every rank is on this host: gloo's sockets on the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device.type == "cuda":
        return "gloo", (lambda r: "cuda:0")
    return "gloo", (lambda r: "cpu")


def spawn_ranks(fn: Callable, tp: int, *, args: Sequence = (),
                device_of_rank: Optional[Callable[[int], str]] = None,
                backend: str, init_method: str, timeout_s: float = 240.0,
                init_timeout_s: float = 60.0) -> list:
    """Run ``fn(rank, *args)`` on ``tp`` spawned ranks and return their
    results in rank order.

    ``fn`` must be importable by name (a module-level function) and
    return something picklable; ``args`` may hold CUDA tensors, which
    reach the ranks by CUDA IPC (the caller keeps them alive; each rank
    frees its handles before it reports, so ``torch.cuda.ipc_collect()``
    after this returns gives their memory back).  Each rank
    first pins ``device_of_rank(rank)`` when it is a CUDA device.  A rank
    that raises makes this raise RuntimeError with its traceback; past
    ``timeout_s`` every rank is killed and this raises TimeoutError.
    Every process started here is stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, tp, device_of_rank(r) if device_of_rank else None,
              backend, init_method, init_timeout_s, [tuple(args)], results))
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
