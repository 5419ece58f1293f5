#!/usr/bin/env python3
"""Host microseconds a call of the port's ``ops.flash_attention``, at shapes
so small that the host's work per call, not the card's, sets the rate.

    PYTHONPATH=src python3 scripts/attention_host_us.py [--label this]

Imports ``repro_torch`` from wherever ``PYTHONPATH`` puts it, so the same
script measures another version of the port (an earlier commit unpacked
with ``git archive``: ``PYTHONPATH=<dir>/src``) on the same card; run the
two in turns (other, this, this, other).  For each case (bf16, BH 1: 64 queries over 64 keys, causal, at D 128
and D 32, which every version sends to the wgmma kernel; 8 queries over
4,096 keys, not causal, at D 128, which the split kernel takes where
there is one) it prints one JSON line: the median over 5 rounds of
``chip_smoke.host_us_per_call`` (``time.perf_counter`` around 1,000
calls and one synchronize, over the calls, after a warm-up), and the
same for SDPA's call as the smoke times it (its flash backend, under
``sdpa_kernel``) on the same tensors.  Needs a CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import host_us_per_call  # noqa: E402

# (label, Sq, Sk, causal, head dim)
CASES = (("causal 64 x 64", 64, 64, True, 128),
         ("causal 64 x 64, D 32", 64, 64, True, 32),
         ("Sq 8 over Sk 4,096", 8, 4096, False, 128))
ROUNDS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="this")
    args = ap.parse_args()

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        raise SystemExit("attention_host_us: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, sq, sk, causal, d in CASES:
        q, k, v = (torch.randn(1, s, d, generator=g, device=dev)
                   .to(torch.bfloat16) for s in (sq, sk, sk))

        def sdpa():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                return torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal)
        rounds = [host_us_per_call(
            torch, lambda: ops.flash_attention(q, k, v, causal=causal))
            for _ in range(ROUNDS)]
        sdpa_rounds = [host_us_per_call(torch, sdpa) for _ in range(ROUNDS)]
        print(json.dumps({"label": args.label, "case": name,
                          "host_us_per_call": statistics.median(rounds),
                          "rounds": rounds,
                          "sdpa_host_us_per_call":
                              statistics.median(sdpa_rounds),
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
