"""Atomic, resumable checkpointing of trees of tensors (numpy files).

A copy of the JAX package's ``training/checkpoint.py`` with the same
layout:

    <dir>/step_<n>/
        manifest.json          (step, leaf paths/dtypes/shapes, extras)
        arr_<i>.npy            one file per tree leaf, in tree order
    <dir>/LATEST               text file naming the newest step dir

bfloat16 leaves are stored as their raw bytes (numpy has no bfloat16) and
rebuilt from the manifest's dtype and shape.  Writes go to a tmp dir and
an atomic rename, so a failure mid-save never corrupts the restore point.
Leaves are copied to the host before ``save`` returns, so the caller may
update them in place at once; async saves then write from a daemon
thread, and ``wait()`` joins it.

On a training mesh (``mesh`` and the state's ``specs``, as
``training/train_step.state_specs`` gives them) every rank holds pieces:
``save`` gathers each leaf whole over its mesh axes, as JAX's
``np.asarray`` of a sharded array does, and rank 0 writes the files the
one-device run writes for the same values; ``restore`` reads the whole
leaves and keeps this rank's pieces, so a run saved at one mesh resumes
at another.  Every rank calls both, at the same point.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import entry_axes, flatten, is_spec, shard_of
from repro_torch.training import tree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:      # raw bytes, rebuilt on restore
        return t.view(torch.int16).numpy().reshape(-1).view(np.uint8)
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *, mesh=None,
                 specs: Any = None):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.specs = specs
        if self.mesh is not None and specs is None:
            raise ValueError("a checkpoint on a mesh needs the state's "
                             "specs")

    def _specs(self, state) -> list:
        specs = flatten(self.specs, is_spec)
        if len(specs) != len(tree.leaves(state)):
            raise ValueError(f"{len(specs)} specs for "
                             f"{len(tree.leaves(state))} leaves")
        return specs

    # -- save -----------------------------------------------------------
    def gather_host(self, state: Any) -> Optional[list]:
        """[(path, whole leaf on the host)] of a state of pieces, on rank
        0 (None on the others): what ``save`` writes."""
        host = []
        for (path, t), spec in zip(tree.leaves_with_paths(state),
                                   self._specs(state)):
            whole = C.gather_leaf(t.detach(), spec, self.mesh,
                                  differentiable=False)
            if self.mesh.rank == 0:     # one leaf whole at a time
                host.append((path, whole.to("cpu", copy=True)))
            del whole
        return host if self.mesh.rank == 0 else None

    def save(self, step: int, state: Any, extras: Optional[dict] = None,
             async_: bool = False):
        if self.mesh is not None:
            self.wait()
            host = self.gather_host(state)
            if self.mesh.rank == 0 and async_:
                self._thread = threading.Thread(
                    target=self._write, args=(step, host, extras),
                    daemon=True)
                self._thread.start()
            elif self.mesh.rank == 0:
                self._write(step, host, extras)
            if not async_:
                self.wait()
            return
        host = [(path, t.detach().to("cpu", copy=True))
                for path, t in tree.leaves_with_paths(state)]
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extras), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extras)

    def _write(self, step, host, extras):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "leaves": [{"path": path, "dtype": _dtype_name(t),
                        "shape": list(t.shape)} for path, t in host],
            "extras": extras or {},
            "time": time.time(),  # repro-lint: disable=raw-wall-clock (manifest timestamp)
        }
        for i, (_, t) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), _to_numpy(t))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and ".tmp" not in d)
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def wait(self):
        """Join an async write; on a mesh also wait for every rank, so a
        save is on disk for all of them when this returns."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group(self.mesh.axis_names))

    # -- restore ---------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.dir, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, template: Any, step: Optional[int] = None):
        """Restore into the structure of ``template``: each leaf comes
        back with the template leaf's device and the stored dtype and
        shape, which must match the template's (on a mesh: this rank's
        pieces of the stored whole, whose shape must be the template's
        pieces put together)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = tree.leaves_with_paths(template)
        if [m["path"] for m in manifest["leaves"]] != [p for p, _ in flat]:
            raise ValueError(f"{d}: the tree structure changed")
        specs = (self._specs(template) if self.mesh is not None
                 else [()] * len(flat))
        out = []
        for i, ((path, ref), meta, spec) in enumerate(zip(
                flat, manifest["leaves"], specs)):
            whole = list(ref.shape)
            for dim, entry in enumerate(spec):
                whole[dim] *= self.mesh.size(entry_axes(entry))
            if meta["dtype"] != _dtype_name(ref) or meta["shape"] != whole:
                raise ValueError(f"{d}: leaf {path} is {meta['dtype']} "
                                 f"{meta['shape']}, the template's "
                                 f"{_dtype_name(ref)} {whole}")
            a = np.load(os.path.join(d, f"arr_{i}.npy"))
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).reshape(
                    meta["shape"])).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a).to(_DTYPES[meta["dtype"]])
            if self.mesh is not None:
                t = shard_of(t, spec, self.mesh)
            out.append(t.to(ref.device))
        return tree.unflatten(template, out), manifest
