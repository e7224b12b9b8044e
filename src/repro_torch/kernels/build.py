"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/<name>-<hash>.so <source>

The build runs at first use, into ``src/repro_torch/build/`` (listed in
``.gitignore``).  A library's file name carries a hash of its source,
the local headers it includes (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
``build_all()`` starts one nvcc per source at once and waits for all.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "build"

# name -> source, relative to the package
SOURCES: Dict[str, str] = {
    "paged_decode": "kernels/flash_decode/csrc/paged_decode.cu",
    "paged_prefill": "kernels/fastattn/csrc/paged_prefill.cu",
    "fastattn_fwd": "kernels/fastattn/csrc/fastattn_fwd.cu",
    "flash_decode": "kernels/flash_decode/csrc/flash_decode.cu",
    "mlstm_chunkwise": "kernels/mlstm/csrc/mlstm_chunkwise.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(path: Path) -> List[Path]:
    """``path`` and every local header it includes (``#include "..."``,
    relative to the including file, recursively), each once."""
    files, todo = [], [path.resolve()]
    while todo:
        p = todo.pop()
        if p in files:
            continue
        files.append(p)
        for inc in _INCLUDE.findall(p.read_bytes()):
            h = (p.parent / inc.decode()).resolve()
            if h.exists():
                todo.append(h)
    return files


def lib_path(name: str) -> Path:
    """The library of source ``name``, named by a hash of the source, the
    headers it includes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in source_files(PKG_DIR / SOURCES[name]):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together.  Returns {name: {"seconds", "log",
    "cached"}}, a cached library's log read from the ``.log`` beside it;
    raises RuntimeError naming the source if nvcc fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, report = {}, {}
    for name in names:
        path = lib_path(name)
        if path.exists():
            log = path.with_suffix(".log")
            report[name] = {"seconds": 0.0, "cached": True, "log":
                            log.read_text() if log.exists() else ""}
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(PKG_DIR / SOURCES[name])]
        todo[name] = (path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (path, tmp, t0, proc) in todo.items():
        log, _ = proc.communicate()
        dt = time.perf_counter() - t0
        report[name] = {"seconds": dt, "log": log, "cached": False}
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):"
                          f"\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)      # atomic: a reader sees all or nothing
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def library(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library of source ``name`` (built at first use), with
    ``argtypes`` set on its C entry point of the same name and ``restype``
    int (the entry returns ``cudaGetLastError()``)."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
