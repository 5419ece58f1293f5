"""Dry run of every (arch x shape x mesh) cell without a card; counterpart
of ``repro.launch.dryrun``.

Where the reference lowers and compiles each cell for 512 placeholder CPU
devices and reads the compiled program's memory and cost analyses, the
port traces one step of one rank: it joins a process-local fake group of
the layout's world as that rank (``launch/mesh.fake_world``; rank 0
unless ``--rank`` says otherwise), builds the cell with
``launch/steps.build_cell``, makes the rank's local arguments as ``meta``
tensors and runs the step once under the op recorder
(``launch/trace_analysis.Recorder``) and torch's memory tracker
(``torch.distributed._tools.mem_tracker.MemTracker``).  Nothing of a
cell's size is ever allocated, and no card or network is needed.
``meta`` tensors and not fake ones: ``FakeTensorMode`` converts and
caches every op's tensors in Python, and a production train cell
dispatches from a hundred thousand to a few million ops.

Per cell it writes JSON under ``--out`` (default ``results/dryrun_torch``)
with the reference's keys:
  * ``flops`` (dot FLOPs), ``traffic_bytes``, ``collectives`` (wire bytes
    by kind and counts), ``collective_exposed_fraction`` (the overlap
    audit of the forward layer loop), all from
    ``launch/trace_analysis``;
  * ``memory``: ``argument_bytes`` (the rank's arguments),
    ``output_bytes`` (the step's outputs that are not its arguments),
    ``peak_bytes`` (the memory tracker's peak, arguments included) and
    ``temp_bytes`` (peak less arguments);
  * ``params_B``, ``active_params_B``, ``seq_parallel``, ``mesh``;
  * ``trace_s`` where the reference has ``lower_s`` and ``compile_s``;
  * the port's own: ``kernel_launches`` (the calls of each kernel one step
    makes, from the kernels' shape-only implementations), ``host_syncs``
    (reads of device data on the host) and ``rank``.
With ``DRYRUN_SAVE_OPS=<dir>`` each cell's op log is saved there
(``<cell>.ops.json.gz``, the standard library's gzip), for
``launch/reanalyze.py``.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--shapes ...]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.fx.experimental import _config as fx_config

from repro_torch.configs import registry, shapes as SH
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.kernels import _build
from repro_torch.launch import steps as ST
from repro_torch.launch import trace_analysis as TA
from repro_torch.launch.mesh import fake_world, layout, make_production_mesh


def trace_step(step_fn, local_args) -> dict:
    """One step on ``meta`` arguments under the recorder and the memory
    tracker: {"log", "memory", "kernel_launches", "real_bytes_max"}."""
    args = TA.tensors(local_args)
    mt = MemTracker()
    mt.track_external(*args)
    # a boolean-mask index has a data-dependent size: take every element
    # (the MoE dispatch keeps every token, its most)
    with fx_config.patch(meta_nonzero_assume_all_nonzero=True), mt, \
            TA.Recorder() as rec:
        out = step_fn(*local_args)
    held = {t.untyped_storage()._cdata for t in args}
    outs = {t.untyped_storage()._cdata: t for t in TA.tensors(out)
            if t.untyped_storage()._cdata not in held}
    peak = mt.get_tracker_snapshot("peak")[torch.device("meta")]["Total"]
    arg_b = TA.nbytes(args)
    return {"log": rec.log, "real_bytes_max": rec.real_bytes_max,
            "kernel_launches": dict.fromkeys(_build.LAUNCHES, 0)
            | TA.kernel_calls(rec.log),
            "memory": {"argument_bytes": arg_b,
                       "output_bytes": TA.nbytes(outs.values()),
                       "temp_bytes": peak - arg_b, "peak_bytes": peak}}


def cell_name(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    name = f"{arch}__{shape}__{'2pod' if multi_pod else '1pod'}"
    return f"{name}__{tag}" if tag else name


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             grad_sync: str = "lq", qcfg=None, seq_parallel=None,
             microbatch: int = 0, tag: str = "", kv_quant: bool = False,
             rank: int = 0, mesh=None, smoke: bool = False,
             **train_kw) -> dict:
    """Trace one cell (see the module docstring).  ``mesh`` (a layout)
    replaces the production one; ``smoke`` takes the arch's smoke config
    and shapes; ``train_kw`` goes to ``steps.train_cell`` (``prefetch``,
    ``batch``, ``seq``, ``opt_cfg``)."""
    cfg0 = registry.config(arch)
    if not SH.applicable(cfg0.family, shape_name):
        return {"arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "skipped": True,
                "reason": "long_500k needs sub-quadratic attention "
                          "(DESIGN.md Arch-applicability)"}
    lay = layout(mesh) if mesh is not None else \
        make_production_mesh(multi_pod=multi_pod)
    with fake_world(math.prod(lay.shape), rank):
        t0 = time.perf_counter()
        if SH.SHAPES[shape_name].kind == "train":
            step_fn, args, cfg, ctx = ST.build_cell(
                arch, shape_name, lay, grad_sync=grad_sync, qcfg=qcfg,
                seq_parallel=seq_parallel, microbatch=microbatch,
                smoke=smoke, device="meta", **train_kw)
        else:
            step_fn, args, cfg, ctx = ST.build_cell(
                arch, shape_name, lay, kv_quant=kv_quant, smoke=smoke)
        tr = trace_step(step_fn, ST.local_structs(args, lay))
        trace_s = time.perf_counter() - t0
    log = tr["log"]
    costs = TA.analyze(log)
    overlap = TA.audit_overlap(log)
    if os.environ.get("DRYRUN_SAVE_OPS"):
        odir = os.environ["DRYRUN_SAVE_OPS"]
        os.makedirs(odir, exist_ok=True)
        TA.save_log(log, os.path.join(
            odir, cell_name(arch, shape_name, multi_pod, tag)
            + ".ops.json.gz"))
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "tag": tag, "grad_sync": grad_sync, "skipped": False,
        "trace_s": trace_s,
        "flops": costs.dot_flops,
        "traffic_bytes": costs.traffic,
        "collectives": costs.coll,
        "collective_exposed_fraction": overlap.exposed_fraction,
        "memory": tr["memory"],
        "params_B": cfg.param_count() / 1e9,
        "active_params_B": cfg.active_param_count() / 1e9,
        "seq_parallel": ctx.seq_parallel,
        "mesh": lay.axis_sizes,
        "rank": rank,
        "kernel_launches": tr["kernel_launches"],
        "host_syncs": sum(e["cls"] == "sync" for e in log),
        "ops": len(log),
        "real_bytes_max": tr["real_bytes_max"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--archs", default="")
    ap.add_argument("--grad-sync", default="lq")
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--bucket", type=int, default=4096)
    ap.add_argument("--rotate", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    qcfg = QSyncConfig(q=args.q, bucket=args.bucket, rotate=args.rotate)
    sp = False if args.no_seq_parallel else None

    archs = (args.archs.split(",") if args.archs
             else ([args.arch] if args.arch else list(registry.ARCHS)))
    shape_list = (args.shapes.split(",") if args.shapes
                  else ([args.shape] if args.shape else list(SH.SHAPES)))
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shape_list]

    os.makedirs(args.out, exist_ok=True)
    ok = fail = 0
    for arch, shape, mp in cells:
        name = cell_name(arch, shape, mp, args.tag)
        path = os.path.join(args.out, name + ".json")
        if os.path.exists(path):
            print(f"[dryrun] {name}: cached", flush=True)
            ok += 1
            continue
        print(f"[dryrun] {name}: tracing...", flush=True)
        try:
            rec = run_cell(arch, shape, mp, grad_sync=args.grad_sync,
                           qcfg=qcfg, seq_parallel=sp,
                           microbatch=args.microbatch, tag=args.tag,
                           kv_quant=args.kv_quant, rank=args.rank)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec.get("skipped"):
                print(f"[dryrun] {name}: SKIP ({rec['reason']})", flush=True)
            else:
                coll = {k: round(v / 2**20, 1)
                        for k, v in rec["collectives"].items()
                        if not k.endswith("_count")}
                print(f"[dryrun] {name}: OK flops={rec['flops']:.3e} "
                      f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
                      f"coll={coll}MiB trace={rec['trace_s']:.1f}s",
                      flush=True)
            ok += 1
        except Exception as e:            # one cell's failure ends no run
            fail += 1
            print(f"[dryrun] {name}: FAIL {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc()
            with open(path + ".fail", "w") as f:
                f.write(traceback.format_exc())
    print(f"[dryrun] done: {ok} ok, {fail} failed", flush=True)
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
