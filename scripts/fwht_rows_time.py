#!/usr/bin/env python3
"""Time the FWHT over rows of 2^19 to 2^23 on one CUDA card, and sweep the
fused kernel's lag and ring.

    python3 scripts/fwht_rows_time.py [--src DIR] [--label NAME] [--sweep]

At each shape of ``SHAPES`` (about 2.8e8 coordinates each), f32 and bf16,
the script calls ``ops.fwht``, holds its leading and its last rows bit for
bit to the plain version, counts the launches of a call, and prints one
JSON line with ``device_ms`` (CUDA events around R back-to-back calls, over
R: ``chip_smoke.device_ms``), the bound (one read and one write of the
data at 3.35 TB/s) and the share of it.  ``--src`` takes the port from
another tree's ``src`` (an earlier commit unpacked with ``git archive``,
say), so that two versions can be timed in turns on one card, each in its
own process.  ``--sweep`` also times, at each row length of the fused
kernel, every lag of ``LAGS`` (``kernels.fwht.FUSED_LAG``) and, in bf16,
rings of lag + each of ``RING_EXTRAS`` slots (``RING_EXTRA``), each held
bitwise too.  Prints the card's name and power limit first and ``{"ok":
true, ...}`` last; exits 1 if any output differs from the plain version.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (rows, d): about 2.8e8 coordinates each, as the smoke's FWHT checks
SHAPES = ((528, 1 << 19), (264, 1 << 20), (132, 1 << 21), (66, 1 << 22),
          (33, 1 << 23))
LAGS = (1, 2, 3, 4, 8)
RING_EXTRAS = (1, 2, 3, 4)


def time_one(torch, smoke, x, **tags) -> bool:
    """One JSON line for ``ops.fwht(x)``; True if it is bitwise the plain
    version on the leading and the last rows (2^24 coordinates each)."""
    from repro_torch.kernels import _build, ops, ref

    rows, d = x.shape
    before = _build.LAUNCHES["fwht"]
    y = ops.fwht(x)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["fwht"] - before
    k = max(1, min(rows, smoke.SLICE // d))
    it = torch.int32 if x.dtype == torch.float32 else torch.int16
    same = all(torch.equal(y[s].view(it), ref.fwht_ref(x[s]).view(it))
               for s in (slice(0, k), slice(rows - k, rows)))
    del y
    dms, reps = smoke.device_ms(torch, lambda: ops.fwht(x))
    b, _ = smoke.bound(x.numel() * 2 * x.element_size(), 0)
    print(json.dumps(dict(shape=[rows, d], dtype=str(x.dtype)[6:],
                          launches=launches, bitwise=same, device_ms=dms,
                          reps=reps, bound_ms=b, share_of_bound=b / dms,
                          **tags)), flush=True)
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory of the port to time")
    ap.add_argument("--label", default="this")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fwht_rows_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import fwht as F

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    fused = getattr(F, "FUSED_LAG", {})
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for rows, d in SHAPES:
        x32 = torch.randn((rows, d), generator=g, device="cuda")
        log2d = d.bit_length() - 1
        for x in (x32, x32.to(torch.bfloat16)):
            ok &= time_one(torch, smoke, x, label=args.label)
            if not (args.sweep and log2d in fused):
                continue
            lag0, extra0 = fused[log2d], F.RING_EXTRA
            extras = RING_EXTRAS if x.dtype == torch.bfloat16 else (extra0,)
            try:
                for lag in LAGS:
                    for extra in extras:
                        fused[log2d], F.RING_EXTRA = lag, extra
                        ok &= time_one(torch, smoke, x, label=args.label,
                                       lag=lag, ring_extra=extra)
            finally:
                fused[log2d], F.RING_EXTRA = lag0, extra0
        del x32, x
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok, "label": args.label,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
