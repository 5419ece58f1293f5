#!/usr/bin/env python3
"""Host microseconds a call of the port's ``ops.flash_attention``, at shapes
so small that the host's work per call, not the card's, sets the rate.

    PYTHONPATH=src python3 scripts/attention_host_us.py [--label this]

Imports ``repro_torch`` from wherever ``PYTHONPATH`` puts it, so the same
script measures another version of the port (an earlier commit unpacked
with ``git archive``: ``PYTHONPATH=<dir>/src``) on the same card; run the
two in turns (other, this, this, other).  For each case (bf16, BH 1, D
128: 64 queries over 64 keys, causal, which every version sends to the
wgmma kernel; 8 queries over 4,096 keys, not causal, which the split
kernel takes where there is one) it prints one JSON line: the median over
5 rounds of ``chip_smoke.host_us_per_call`` (``time.perf_counter`` around
1,000 calls and one synchronize, over the calls, after a warm-up).  Needs
a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import host_us_per_call  # noqa: E402

CASES = (("causal 64 x 64", 64, 64, True), ("Sq 8 over Sk 4,096", 8, 4096,
                                             False))
ROUNDS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="this")
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        raise SystemExit("attention_host_us: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, sq, sk, causal in CASES:
        q, k, v = (torch.randn(1, s, 128, generator=g, device=dev)
                   .to(torch.bfloat16) for s in (sq, sk, sk))
        rounds = [host_us_per_call(
            torch, lambda: ops.flash_attention(q, k, v, causal=causal))
            for _ in range(ROUNDS)]
        print(json.dumps({"label": args.label, "case": name,
                          "host_us_per_call": statistics.median(rounds),
                          "rounds": rounds,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
