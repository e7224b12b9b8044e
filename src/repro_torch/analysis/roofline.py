"""Three-term roofline of one H100 from a per-device cost record.

Per (config x shape x device count):
    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

Also reports MODEL_FLOPS = 6ND / 2ND (``analysis/flops.py``) and its
ratio to the counted FLOPs, the dominant term, and a suggested lever.

The port's copy of the JAX package's ``analysis/roofline.py`` with the
H100's constants in place of a v5e's.  JAX reads its cost from compiled
XLA text (``roofline_from_hlo_text`` over ``analysis/hlo.py``); the port
has no XLA, so ``roofline_terms`` takes the cost record itself -- from
an analytic count or any other source -- and computes the same dict.
``kernel_adjusted_terms``, JAX's rewrite of the attention loops in that
text, is not ported (it reads XLA artifacts).  The command line renders
the port's dry-run records (``launch/dryrun.py``, whose ``roofline`` key
is ``roofline_terms`` of its counts) as JAX's ``main`` renders JAX's,
without JAX's ``--reparse`` of stored HLO:

    PYTHONPATH=src python -m repro_torch.analysis.roofline \
        [--dir results/dryrun_torch] [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.analysis.flops import attention_flops, model_flops
from repro_torch.config import ModelConfig, ShapeConfig

# --- hardware constants: one H100 SXM (NVIDIA's data sheet, dense) --------
PEAK_FLOPS = 989e12          # bf16 per card, tensor cores, no sparsity
HBM_BW = 3.35e12             # bytes/s per card, HBM3
LINK_BW = 450e9              # bytes/s per card each way, NVLink 4 (18 links)


@dataclass
class Cost:
    """Per-device cost of one step: FLOPs, HBM bytes, collective bytes
    (in all and by collective kind), and the largest collectives as
    (name, bytes) pairs."""
    flops: float
    bytes: float
    collective_bytes: float = 0.0
    by_collective: dict = field(default_factory=dict)
    top_collectives: list = field(default_factory=list)


def roofline_terms(cost, *, cfg: ModelConfig, shape: ShapeConfig,
                   n_devices: int) -> dict:
    """The roofline of ``cost`` (a ``Cost``, or any record with its
    attributes, per device) for ``cfg`` at ``shape`` on ``n_devices``.

    The dict of JAX's ``roofline_from_hlo_text``, computed the same way;
    its ``hlo_flops_per_dev`` and ``hlo_bytes_per_dev`` are
    ``flops_per_dev`` and ``bytes_per_dev`` here, every other key has
    JAX's name."""
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.bytes / HBM_BW
    collective_s = cost.collective_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cfg, shape)
    mf_per_dev = mf / n_devices
    flops = max(cost.flops, 1.0)
    af = attention_flops(cfg, shape) / n_devices

    bound_s = max(terms.values())
    # roofline fraction: useful model FLOPs per device per "roofline second"
    roofline_frac = (mf_per_dev / PEAK_FLOPS) / bound_s if bound_s else 0.0

    return {
        "flops_per_dev": cost.flops,
        "bytes_per_dev": cost.bytes,
        "collective_bytes_per_dev": cost.collective_bytes,
        "by_collective": cost.by_collective,
        "top_collectives": cost.top_collectives[:8],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_total": mf,
        "model_flops_per_dev": mf_per_dev,
        "attn_flops_per_dev": af,
        "useful_ratio": mf_per_dev / flops,
        "roofline_fraction": roofline_frac,
    }


def lever(rec: dict) -> str:
    """One sentence on what would move the dominant term down."""
    r = rec.get("roofline", rec)
    d = r.get("dominant")
    if d == "collective_s":
        top = r.get("by_collective", {})
        worst = max(top, key=top.get) if top else "all-gather"
        return (f"dominant collective is {worst} "
                f"({top.get(worst, 0)/1e6:.0f} MB/dev): reduce via weight-"
                "stationary sharding, chunked overlap (T3), or smaller "
                "model-axis factor")
    if d == "memory_s":
        return ("HBM-bound: increase arithmetic intensity -- fuse attention "
                "(larger level-1 tiles), widen per-card batch, or quantize "
                "KV/weights")
    return ("compute-bound: close the useful-FLOPs gap (remat recompute, "
            "causal-skip) and raise tensor-core (wgmma) utilization via "
            "64-row warpgroup tiles")


def load_records(dir_: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def render_table(recs, *, mesh: Optional[str] = None) -> str:
    rows = []
    hdr = (f"{'cell':52s} {'status':8s} {'comp(s)':>9s} {'mem(s)':>9s} "
           f"{'coll(s)':>9s} {'dom':>5s} {'useful':>7s} {'roofl%':>7s}")
    rows.append(hdr)
    rows.append("-" * len(hdr))
    for r in recs:
        if mesh and r.get("mesh") != mesh:
            continue
        cell = r["cell"]
        if r["status"] != "ok":
            rows.append(f"{cell:52s} {r['status']:8s} "
                        f"{r.get('reason', r.get('error', ''))[:60]}")
            continue
        rf = r.get("roofline")
        if not rf:
            rows.append(f"{cell:52s} ok        (no roofline: "
                        f"{r.get('roofline_error', '?')})")
            continue
        dom = {"compute_s": "comp", "memory_s": "mem",
               "collective_s": "coll"}[rf["dominant"]]
        rows.append(
            f"{cell:52s} {'ok':8s} {rf['compute_s']:9.4f} "
            f"{rf['memory_s']:9.4f} {rf['collective_s']:9.4f} {dom:>5s} "
            f"{rf['useful_ratio']:7.3f} {100*rf['roofline_fraction']:7.2f}")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results",
        "dryrun_torch"))
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(render_table(recs, mesh=args.mesh))
    for r in recs:
        if r.get("status") == "ok" and r.get("roofline") and (
                not args.mesh or r.get("mesh") == args.mesh):
            print(f"{r['cell']}: {lever(r)}")


if __name__ == "__main__":
    main()
