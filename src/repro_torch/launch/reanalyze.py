"""Re-derive ``traffic_bytes`` in dry-run records from their saved op logs
(``DRYRUN_SAVE_OPS``, ``<cell>.ops.json.gz``) without tracing again;
counterpart of ``repro.launch.reanalyze``.  Run after a change to
``launch/trace_analysis.analyze``.  The logs are gzip (the standard
library's), so nothing beyond torch is needed.

Usage:
  python -m repro_torch.launch.reanalyze [results_dir] [ops_dir]
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.launch.trace_analysis import analyze, load_log


def main(results: str = "results/dryrun_torch",
         ops_dir: str = "results/ops_torch") -> int:
    n = 0
    for jp in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(jp) as f:
            rec = json.load(f)
        if rec.get("skipped"):
            continue
        name = os.path.basename(jp)[:-5]
        op = os.path.join(ops_dir, name + ".ops.json.gz")
        if not os.path.exists(op):
            print(f"reanalyze: no op log for {name}", file=sys.stderr)
            continue
        rec["traffic_bytes"] = analyze(load_log(op)).traffic
        with open(jp, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    print(f"reanalyzed {n} cells")
    return n


if __name__ == "__main__":
    main(*sys.argv[1:])
