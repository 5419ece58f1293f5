"""No run loads JAX or the JAX package ``repro``, compared by whole
top-level names; the command refuses to run without a card, and in a
checkout that holds only the benchmark."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from dme_bench import harness as H

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.agg.client", "reproducible"], []),
    (["repro", "repro.agg"], ["repro", "repro.agg"]),
    (["jax.numpy", "jaxlib", "flax", "jaxtyping"],
     ["flax", "jax.numpy", "jaxlib"]),
])
def test_forbidden_names_are_whole_top_level_names(names, bad):
    assert H.forbidden_modules(names) == bad


SCRIPT = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from dme_bench import harness as H
m = H.load_manifest()
for name in [w["name"] for w in m["workloads"]]:
    cell, config, mix = H.resolve(m, name)
    b = config["contract"]["bucket"]
    config = dict(config, d=2 * b + 5, padded=3 * b)
    r = H.run_cell(cell, config, mix, m["end_to_end"], seed=3,
                   seconds=3.0, trace=False, device="cpu",
                   t_start=time.perf_counter())
    assert r["correct"], r
print(json.dumps([n for n in sys.modules if n.split(".")[0] in
                  ("repro_torch", "repro", "jax", "jaxlib", "flax")]))
"""


def test_a_run_loads_the_port_and_not_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT),
                                             src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.agg.client" in loaded
    assert H.forbidden_modules(loaded) == []


def run_command(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "dme_bench/run.py", "--workload",
         "whisper-small.client", "--seed", "1", "--seconds", "1"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    r = run_command(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "dme_bench", tmp_path / "dme_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_command(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
