"""One run of one cell: set-up, a warm round, the measured window, the
check against the reference, the metrics, the result line.

Everything specific to a configuration, a traffic mix or a metric is data
or a small file found by its name in ``BENCHMARK.json``:
``configs/<config>.json`` (the round contract and the width),
``mixes/<traffic>.json`` (the role that drives the program and its
parameters), ``roles/<role>.py`` (the one generator of that role) and
``metrics/<metric>.py`` (a ``read(run)`` that returns the metric's value,
or ``None`` where it finds nothing to read).

The window is a closed loop: rounds start back to back while less than
``seconds`` have passed since the first one started, and the last round
started runs to its end.  Spans are the benchmark's own, on the host's
clock, with the device synchronised on both sides of each call into a
layer; with ``trace`` they also enter a ``torch.profiler`` trace of the
window as ``dme:<span>`` ranges.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from dme_bench import inputs
from dme_bench import trace as TR

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names a run may not load: the reference package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> "list[str]":
    """The names whose top-level module (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def percentile(values, p: float) -> float:
    """The p-th percentile, interpolated linearly between the order
    statistics at rank ``p / 100 * (n - 1)`` (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = p / 100 * (len(v) - 1)
    i = int(x)
    return v[i] if i + 1 >= len(v) else v[i] + (v[i + 1] - v[i]) * (x - i)


class Spans:
    """(name, round, start s, end s) of each call into a layer."""

    def __init__(self, device: torch.device, traced: bool):
        self.device, self.traced, self.records = device, traced, []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, rnd=None):
        rf = (torch.profiler.record_function(TR.PREFIX + name)
              if self.traced else contextlib.nullcontext())
        with rf:
            self.sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                self.records.append((name, rnd, t0, time.perf_counter()))


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: dict
    config: dict
    mix: dict
    spans: list
    setup_s: float
    rounds: int
    window_s: float
    trace: "TR.Trace | None"

    def round_times(self) -> "list[float]":
        return [b - a for n, r, a, b in self.spans
                if n == "round" and r is not None and r >= 0]

    def per_round(self, name: str) -> "float | None":
        """Seconds a window round spent in spans named ``name``."""
        t = [b - a for n, r, a, b in self.spans
             if n == name and r is not None and r >= 0]
        return sum(t) / self.rounds if t else None

    def kernel_share(self, part: str, nbytes: float,
                     calls: int) -> "float | None":
        """Percent of the HBM bound of ``calls`` calls that move ``nbytes``
        each, over the device time of the window's kernels named with
        ``part``."""
        from dme_bench import roofline
        if self.trace is None:
            return None
        secs, launches = self.trace.kernel_s(part)
        if not launches:
            return None
        return 100.0 * roofline.bound_ms(nbytes * calls) / 1e3 / secs


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` of ``metrics/<metric>.py``."""
    safe = "".join(ch if ch.isalnum() else "_" for ch in metric)
    return load_file(BENCH / "metrics" / f"{metric}.py",
                     f"dme_bench_metric_{safe}").read


def role_class(role: str):
    return importlib.import_module(f"dme_bench.roles.{role}").Role


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: dict, name: str):
    """(cell, configuration, mix) of a cell of the manifest."""
    cell = next((w for w in manifest["workloads"] if w["name"] == name),
                None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, config, mix


def power_limit_w(device: torch.device) -> "float | None":
    """The power limit of the card that runs ``device``, as ``nvidia-smi``
    reads it, found by the card's UUID (nvidia-smi numbers the cards
    without regard to ``CUDA_VISIBLE_DEVICES``); None where it cannot."""
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return limit_of(out, uuid)


def limit_of(table: str, uuid: str) -> "float | None":
    """The power limit in ``nvidia-smi``'s ``uuid, power.limit`` lines of
    the card whose UUID is ``uuid`` (with or without the ``GPU-``
    prefix)."""
    want = uuid.lower().removeprefix("gpu-")
    for line in table.splitlines():
        card, _, limit = line.partition(",")
        if card.strip().lower().removeprefix("gpu-") == want:
            try:
                return float(limit)
            except ValueError:
                return None
    return None


def run_cell(cell: dict, config: dict, mix: dict, metrics: "list[dict]", *,
             seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False, log=sys.stderr) -> dict:
    """Run the cell once and return its result line (a dict).  With
    ``control`` the role's control stands in for the program."""
    device = torch.device(device)
    spans = Spans(device, trace)
    role = role_class(mix["role"])(config, mix, seed, device, spans)
    if control:
        role.control()
    t_prep = time.perf_counter()
    role.prepare()
    t_warm = time.perf_counter()
    with spans.span("round", -1):
        role.round(-1)
    print(f"set-up: {t_prep - t_start:.3f} s to the role, "
          f"{t_warm - t_prep:.3f} s preparing, "
          f"{time.perf_counter() - t_warm:.3f} s in the warm round",
          file=log)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    spans.sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    want = int(mix["check_rounds"])
    kept = []               # (priority, round, answer): the sample so far
    attempted = failed = 0
    with spans.span("window"):
        while time.perf_counter() - t0 < seconds:
            r = attempted
            attempted += 1
            try:
                with spans.span("round", r):
                    answer = role.round(r)
            except Exception:       # a round that makes no answer
                failed += 1
                traceback.print_exc(file=log)
                continue
            kept.append((inputs.priority(seed, r), r, answer))
            kept.sort(key=lambda t: t[0])
            del kept[want:]
            del answer
    window_s = spans.records[-1][3] - spans.records[-1][2]
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, checked = {}, len(kept)
    for _, r, answer in sorted(kept, key=lambda t: t[1]):
        for name, (value, limit) in role.check(r, answer).items():
            old = checks.get(name, (value, limit))[0]
            checks[name] = (max(value, old), limit)
    del kept
    checks["failed_rounds"] = (failed, 0)
    checks["rounds_short"] = (want - checked, 0)
    if prof is not None:
        tr = TR.collect(prof)
        del prof
        print(f"trace: {len(tr.device)} device events, {len(tr.host)} "
              f"spans", file=log)
    run = Run(cell, config, mix, spans.records, setup_s, attempted,
              window_s, tr)
    print("rounds: " + " ".join(f"{t:.4f}" for t in run.round_times()),
          file=log)
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w(device)
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": out,
              "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_by_span()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
