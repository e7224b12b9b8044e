#!/usr/bin/env python3
"""Time the bf16 attention-forward kernels on one GPU beside SDPA.

    python3 attn_bench.py [--parent DIR]

1. ``fastattn_fwd`` and ``fastattn_paged_prefill`` on the bfloat16 cases
   of ``chip_smoke.py``'s phase 2 (its ``FWD_CASES`` and
   ``PREFILL_CASES``), each held to its plain version and timed with
   SDPA.
2. ``fastattn_fwd`` against SDPA across CTA lengths: 2048 CTAs of 128
   query rows each, 4 to 32 stages of 128 keys, causal and not.  A
   straight line through (stages, ms) splits a fixed cost per CTA from
   the cost per stage.
3. With ``--parent DIR`` (another checkout of the repository, e.g. from
   ``git archive``): ``chip_smoke.py``'s phase 3 (paged serving of
   llama2-7b) of DIR and of this tree in turns, parent, this, this,
   parent, each in its own process with its own kernel build.

Needs one CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PHASE3 = ("import sys, json, torch; sys.path[:0] = ['src', '.']; "
          "torch.backends.cuda.matmul.allow_tf32 = False; "
          "import chip_smoke as cs; cs.phase_card_and_build(); "
          "m, p = cs.build_llama(); r = cs.phase_serving(m, p); "
          "print('RESULT', json.dumps({k: r[k] for k in ("
          "'wall_s', 'prefill_device_s', 'decode_device_s', "
          "'prefill_tok_s', 'decode_tok_s')}))")


def kernels(cs) -> None:
    for case, cases in ((cs.fwd_case, cs.FWD_CASES),
                        (cs.prefill_case, cs.PREFILL_CASES)):
        for name, kw in cases:
            if kw["dtype"] == "bfloat16":
                case(name, **kw)


def sweep(cs) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for b, s, causal in ((16, 512, False), (4, 2048, True), (4, 2048, False),
                         (2, 4096, False), (1, 8192, True)):
        q, k, v = (torch.randn((b, 32, s, 128), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        ms = cs.time_ms(lambda: fastattn_fwd(q, k, v, causal=causal))
        lib = cs.time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        flop = 4.0 * b * 32 * 128 * (s * (s + 1) / 2 if causal else s * s)
        stages = (s // 128 + 1) / 2 if causal else s // 128
        cs.log(f"[sweep] B={b} H=32 S={s} D=128 causal={causal}: "
               f"{b * 32 * s // 128} CTAs, {stages:.1f} stages of 128 keys "
               f"a CTA; kernel {ms:.4f} ms ({flop / ms / 1e9:.0f} TFLOP/s), "
               f"SDPA {lib:.4f} ms ({flop / lib / 1e9:.0f} TFLOP/s), "
               f"kernel / SDPA {ms / lib:.2f}x")


def phase3(parent: Path) -> None:
    for tree in (parent, ROOT, ROOT, parent):
        out = subprocess.run([sys.executable, "-c", PHASE3], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        res = [ln for ln in out.stdout.splitlines()
               if ln.startswith("RESULT")]
        if out.returncode != 0 or not res:
            raise RuntimeError(f"phase 3 of {tree} failed:\n"
                               f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
        print(f"[phase3] {tree}: {res[0][len('RESULT '):]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("attn_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_card_and_build()
    kernels(cs)
    sweep(cs)
    if args.parent is not None:
        phase3(args.parent.resolve())
    print(json.dumps({"ok": True,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
