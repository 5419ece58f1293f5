#!/usr/bin/env python3
"""Run the attention phase of ``chip_smoke.py`` alone on one CUDA card.

    python3 scripts/attention_phase_time.py [--context] [--seed N]

Builds the attention kernels, prints the smoke's ``sass`` check of them
and runs ``chip_smoke.attention`` over ``ATTENTION_CASES`` (every check
raises as in the smoke; its ``attention`` and ``attention_path`` lines
are printed).  With ``--context`` it runs instead the small head dims'
cases (bf16 D 16 and 32, f16 D 64) three times: cold, then after the
three long prefill cases (qwen3-32b, nemotron-4-340b and
recurrentgemma-9b at 32,768 tokens, the smoke's order), then again, and
prints the card's SM clock, power and temperature (``nvidia-smi``)
around each: the smoke times the small cases right after the prefill
calls.  Prints the card's name and power limit first.  Needs a CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card(tag: str) -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card {tag} {out}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--context", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_phase_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    names = tuple(n for n in _build.SOURCES if n.startswith("flash"))
    _build.build(names)
    for n in names:
        _build.load(n)
    smoke.say("sass", attention=smoke.attention_sass(_build))
    if not args.context:
        smoke.attention(torch, args.seed)
        return 0
    cases = smoke.ATTENTION_CASES
    small = tuple(c for c in cases if c[0] in (
        "smoke width (D 16)", "head dim 32") or (
        c[3] == 64 and c[6] == "float16" and not isinstance(c[4], tuple)))
    prefill = tuple(c for c in cases if c[0].endswith("prefill_32k"))
    for tag, run in (("cold", small), ("after_prefill", prefill + small),
                     ("again", small)):
        smoke.ATTENTION_CASES = run
        card(f"{tag}_before")
        t0 = time.perf_counter()
        smoke.attention(torch, args.seed)
        card(f"{tag}_after")
        print(f"phase {tag} {time.perf_counter() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
