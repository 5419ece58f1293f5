"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 dme_bench/run.py --workload whisper-small.client --seed 7 \
        --seconds 50 --trace 0

From the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number
compared with the reference beside its limit, also the last lines of
standard error.  It prints no result and exits 1 without a CUDA device, and
exits 2 if the run loaded JAX or the JAX package ``repro``.

``--control`` puts the role's control in the program's place (its
``correct`` must read false).
"""
import time

T_START = time.perf_counter()

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))

    import torch

    from dme_bench import harness as H

    manifest = H.load_manifest()
    cell, config, mix = H.resolve(manifest, a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    key = "per_layer" if a.trace else "end_to_end"
    metrics = [m for m in manifest[key] if H.applies(m, cell["name"])]
    result = H.run_cell(cell, config, mix, metrics, seed=a.seed,
                        seconds=a.seconds, trace=bool(a.trace),
                        device="cuda", t_start=T_START, control=a.control)
    bad = H.forbidden_modules(sys.modules)
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
