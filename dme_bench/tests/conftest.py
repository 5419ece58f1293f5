"""Fixtures of the benchmark's CPU tests: its cells cut to a few buckets."""
import sys
import time
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[2] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def tiny():
    """``run(cell, **kw)``: the cell at 3 buckets and 77 coordinates,
    on the CPU, through the harness; returns its result line."""
    from dme_bench import harness as H

    def run(name, *, seconds=0.2, trace=False, control=False, seed=5,
            d=3 * 4096 + 77):
        manifest = H.load_manifest()
        cell, config, mix = H.resolve(manifest, name)
        bucket = config["contract"]["bucket"]
        config = dict(config, d=d, padded=-(-d // bucket) * bucket)
        key = "per_layer" if trace else "end_to_end"
        metrics = [m for m in manifest[key] if H.applies(m, name)]
        return H.run_cell(cell, config, mix, metrics, seed=seed,
                          seconds=seconds, trace=trace, device="cpu",
                          t_start=time.perf_counter(), control=control)
    return run
