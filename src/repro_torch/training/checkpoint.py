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
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------
    def save(self, step: int, state: Any, extras: Optional[dict] = None,
             async_: bool = False):
        flat = tree.leaves_with_paths(state)
        host = [(path, t.detach().to("cpu", copy=True)) for path, t in flat]
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
            "time": time.time(),
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
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
        shape, which must match the template's."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = tree.leaves_with_paths(template)
        if [m["path"] for m in manifest["leaves"]] != [p for p, _ in flat]:
            raise ValueError(f"{d}: the tree structure changed")
        out = []
        for i, ((path, ref), meta) in enumerate(zip(flat,
                                                    manifest["leaves"])):
            if meta["dtype"] != _dtype_name(ref) or \
                    meta["shape"] != list(ref.shape):
                raise ValueError(f"{d}: leaf {path} is {meta['dtype']} "
                                 f"{meta['shape']}, the template's "
                                 f"{_dtype_name(ref)} {list(ref.shape)}")
            a = np.load(os.path.join(d, f"arr_{i}.npy"))
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).reshape(
                    meta["shape"])).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a).to(_DTYPES[meta["dtype"]])
            out.append(t.to(ref.device))
        return tree.unflatten(template, out), manifest
