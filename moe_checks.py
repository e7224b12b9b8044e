#!/usr/bin/env python3
"""Two measurements of the port's MoE block on one GPU, each tree or
variant in a child process of its own (fresh imports, the card to
itself).  Needs one CUDA card and nvcc; imports nothing of JAX.

    python3 moe_checks.py step TREE [TREE ...]

``chip_smoke.py`` phase 8 (f) from each TREE in the order given (a
checkout of this repo: its ``chip_smoke.py`` and ``src/``): qwen3-moe-
30b-a3b at full width and depth from seed 0, a B=8 decode step and an
8 x 512 prefill launch, each one line of JSON with the wall (median of
5), the device time of one profiled run, its launches and idle share.
Give two trees in a mirrored order (A B B A) to compare them on one host.

    python3 moe_checks.py ep [VARIANT ...]

``chip_smoke.py`` phase 8 (g) and (h) -- qwen3-moe's first 2 layers at
full width trained 3 steps on one device, then its first 2 at (data=2,
model=2) with the experts sharded over the model axis -- with the gates'
bounds lifted, one line of JSON a variant: the loss and grad norm
against (g)'s, the six leaves whose updates differ most from (g)'s
(``delta_gate``'s ratio), and which bounds the run would fail.
Variants: ``seedN`` (the init from TrainConfig seed N and the batches
from DataConfig seed 1234 + N; seed0 is the script as it stands),
``f32`` (seed 0 with the MoE combine summed in float32 on one device
and on the mesh, cast once after the cross-rank sum), ``ctrl`` (seed 0
with each rank's S / model rows dispatched on their own: the per-rank
capacity the block must not use).  A variant other than seed0 runs from
a copy of this checkout's ``src/`` and ``chip_smoke.py`` under
``.chipwork/`` with that change made.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# variant -> [(file, text, replacement)], each text found exactly as
# given (every occurrence replaced)
_F32 = [
    ("src/repro_torch/layers/moe.py", "    el, _, d = ye.shape\n",
     "    ye = ye.float()\n    el, _, d = ye.shape\n"),
    ("src/repro_torch/models/blocks.py",
     "        return moe_mod.apply_moe(params, h2, cfg)\n",
     "        return moe_mod.apply_moe(params, h2, cfg).to(h2.dtype)\n"),
    ("src/repro_torch/models/blocks.py",
     "cfg)[:, m * s:(m + 1) * s]\n",
     "cfg)[:, m * s:(m + 1) * s].to(h2.dtype)\n"),
    ("src/repro_torch/models/blocks.py",
     "    return C.scatter(part, 1, group)\n",
     "    return C.scatter(part, 1, group).to(h2.dtype)\n")]
_CTRL = [
    ("src/repro_torch/models/blocks.py",
     "    part = moe_mod.apply_moe(params, whole, cfg,\n"
     "                             experts=(m * el, (m + 1) * el))\n",
     "    part = moe_mod.apply_moe(params, whole.reshape(-1, s, "
     "whole.shape[-1]),\n"
     "                             cfg, experts=(m * el, (m + 1) * el)\n"
     "                             ).reshape(whole.shape)\n")]


def _seed(n: int) -> list:
    return [("chip_smoke.py", "TrainConfig(learning_rate=3e-4, ",
             f"TrainConfig(seed={n}, learning_rate=3e-4, "),
            ("chip_smoke.py", "DataConfig(vocab_size=cfg.vocab_size,",
             f"DataConfig(seed={1234 + n}, vocab_size=cfg.vocab_size,")]


def _patches(variant: str) -> list:
    if variant == "f32":
        return _F32
    if variant == "ctrl":
        return _CTRL
    if variant.startswith("seed") and variant[4:].isdigit():
        return _seed(int(variant[4:])) if int(variant[4:]) else []
    raise SystemExit(f"unknown variant {variant!r}")


def _variant_tree(variant: str) -> Path:
    """This checkout, or a copy of it with the variant's change made; the
    kernels built once, here, and copied."""
    patches = _patches(variant)
    if not patches:
        return ROOT
    tree = ROOT / ".chipwork" / f"moe-{variant}"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src", ignore=shutil.ignore_patterns(
        "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
    for rel, old, new in patches:
        path = tree / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{variant}: {rel} no longer holds {old!r}")
        path.write_text(text.replace(old, new))
    return tree


def _import(tree: str):
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import build
    if not build.__file__.startswith(tree):
        raise SystemExit(f"{tree}: imported {build.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    return cs, torch


def _step(tree: str) -> dict:
    cs, _ = _import(tree)
    model, params = cs.build_full(cs.MOE_ARCH)
    prompts, _ = cs.serve_traffic(model.cfg.vocab_size)
    res = cs.moe_step_profile(model, params, prompts)
    return {"tree": tree, **{k: {x: v[x] for x in (
        "wall_ms", "device_ms", "kernel_launches", "idle_share")}
        for k, v in res.items()}}


def _ep(tree: str, variant: str) -> dict:
    import gc
    import math
    cs, torch = _import(tree)
    from repro_torch.config import get_model_config
    bounds = {"loss": cs.DIST_LOSS_RTOL, "grad_norm": cs.DIST_GNORM_RTOL}
    moe_bound, rest_bound = cs.MOE_DELTA_RTOL, cs.DIST_DELTA_RTOL
    cs.DIST_LOSS_RTOL = cs.DIST_GNORM_RTOL = math.inf
    cs.DIST_DELTA_RTOL = cs.MOE_DELTA_RTOL = math.inf
    cfg = get_model_config(cs.MOE_ARCH)
    g = cs.moe_train(cfg)
    gc.collect()                  # (g)'s model and optimizer state
    torch.cuda.empty_cache()
    h = cs.moe_dist(g, cfg)
    rel = h["delta_rel"]
    off = {k: max(abs(a - b) / abs(b) for a, b in zip(h[k], h[f"ref_{k}"]))
           for k in bounds}
    moe = max(v for p, v in rel.items() if "/moe/" in p)
    rest = max(v for p, v in rel.items() if "/moe/" not in p)
    fails = [k for k, b in bounds.items() if not off[k] <= b]
    fails += (["moe leaves"] * (not moe <= moe_bound)
              + ["other leaves"] * (not rest <= rest_bound))
    return {"variant": variant, "loss_rel": off["loss"],
            "gnorm_rel": off["grad_norm"], "worst_moe": moe,
            "worst_other": rest,
            "top": sorted(rel.items(), key=lambda kv: -kv[1])[:6],
            "drop_share": g["drop_share"], "fails": fails}


def _child(args: list) -> None:
    """Run ``args`` as this script's child; print its result line."""
    res = subprocess.run([sys.executable, str(ROOT / "moe_checks.py")]
                         + args, capture_output=True, text=True)
    lines = [x for x in res.stdout.splitlines() if x.startswith("{")]
    if res.returncode != 0 or not lines:
        print(json.dumps({"args": args, "rc": res.returncode,
                          "error": res.stderr[-2000:]}), flush=True)
        return
    print(lines[-1], flush=True)


def main(argv: list) -> int:
    if not argv or argv[0] not in ("step", "ep", "_step", "_ep"):
        print(__doc__, file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "_step":
        print(json.dumps(_step(rest[0])), flush=True)
    elif cmd == "_ep":
        print(json.dumps(_ep(rest[0], rest[1])), flush=True)
    elif cmd == "step":
        for tree in rest:
            _child(["_step", str(Path(tree).resolve())])
    else:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import build
        build.build_all()
        for variant in rest or ["seed0"]:
            tree = _variant_tree(variant)
            if tree != ROOT:
                dst = tree / "src" / "repro_torch" / "build"
                shutil.copytree(build.BUILD_DIR, dst, dirs_exist_ok=True)
            _child(["_ep", str(tree), variant])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
