"""The dry run (``repro_torch.launch.dryrun``) and ``reanalyze``.

* FLOP parity: at smoke size on (2, 2) the port's dot FLOPs of the train,
  prefill and decode cells of internvl2-1b, glm4-9b, granite-moe-1b-a400m,
  whisper-small, mamba2-1.3b and recurrentgemma-9b against the reference's
  ``analyze(pre-optimization HLO).dot_flops``, lowered in a JAX subprocess
  with four emulated devices.  Every serving cell but mamba2's agrees
  exactly.  Where a cell differs, it differs by construction, and the
  difference is pinned exactly:

  - every train cell: the port's vocab-parallel cross entropy
    (``models/layers._CESum``) recomputes each block's logits in its
    backward instead of keeping them, one more ``x @ head.T`` product of
    ``2 * T * d_model * V_loc`` (T the rank's rows, V_loc its vocab rows);
  - mamba2's SSD: the reference's three-operand einsums are two dots each
    in its HLO, one of them a scaling by a third operand without a
    contraction (``y_diag``'s ``G * L``, ``states``' ``decay_states``,
    ``y_off``'s ``state_decay_out`` in the chunked scan; ``upd``'s ``dt``
    in the decode step); the port forms those scalings with elementwise
    products, so it counts fewer dot FLOPs: 1,048,576 in the train cell,
    131,072 in the prefill and, in the decode step, ``n_layers * 2 * B *
    H * P * (N + 1)`` = 8,704 (the ``upd`` einsum's outer product and its
    scaling).
* A production cell, internvl2-1b ``train_4k`` on 16 x 16, in this
  process: no tensor of the cell's size is ever real (the largest real
  tensor an op saw is a host scalar) and the process's peak resident
  memory stays below the peak the trace predicts; the record carries the
  reference's keys.
* The CLI: a cell traced and cached, a cell skipped, the exit code; with
  ``DRYRUN_SAVE_OPS`` the op log saved (gzip), and ``reanalyze``
  reproduces the record's ``traffic_bytes`` exactly from it.
* No module of the dry run imports ``jax``, ``repro`` or ``zstandard``.
* The kernels' shape-only implementations take every shape the kernels
  take, and the FWHT's records one call a launch.
"""
import json
import os
import resource
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import lattice as TL
from repro_torch.launch import dryrun as DR
from repro_torch.launch import reanalyze as RA

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("internvl2-1b", "glm4-9b", "granite-moe-1b-a400m", "whisper-small",
         "mamba2-1.3b", "recurrentgemma-9b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# the reference's dryrun record keys the port keeps (lower_s and compile_s
# are its trace_s; flops_raw, bytes_accessed_raw and traffic_bytes_pre
# read XLA's own cost analysis, which torch has no counterpart of)
REF_KEYS = {"arch", "shape", "multi_pod", "tag", "grad_sync", "skipped",
            "flops", "traffic_bytes", "collectives",
            "collective_exposed_fraction", "memory", "params_B",
            "active_params_B", "seq_parallel", "mesh"}
# port - reference dot FLOPs besides the cross entropy's recomputed
# logits (module docstring)
SSD = {("mamba2-1.3b", "train_4k"): -1_048_576,
       ("mamba2-1.3b", "prefill_32k"): -131_072,
       ("mamba2-1.3b", "decode_32k"): -8_704}

_JAX_SCRIPT = """
import json, sys
import repro  # noqa: F401
from repro.launch import steps as ST
from repro.launch.hlo_analysis import analyze
from repro.launch.mesh import make_mesh

archs, shapes = sys.argv[1].split(","), sys.argv[2].split(",")
out = sys.argv[3]
mesh = make_mesh((2, 2), ("data", "model"))
res = {}
for arch in archs:
    for shape in shapes:
        f, args, cfg, ctx = ST.build_cell(arch, shape, mesh, smoke=True)
        txt = f.lower(*args).compiler_ir(dialect="hlo").as_hlo_text()
        res[arch + "/" + shape] = analyze(txt).dot_flops
json.dump(res, open(out, "w"))
"""


@pytest.fixture(scope="module")
def flops(tmp_path_factory):
    """(reference, port) dot FLOPs and the port's records, per cell."""
    tmp = tmp_path_factory.mktemp("dryrun_flops")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    log = tmp / "jax.log"
    with open(log, "w") as f:
        p = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT,
                              ",".join(ARCHS), ",".join(SHAPES),
                              str(tmp / "ref.json")], env=env, stdout=f,
                             stderr=subprocess.STDOUT)
    try:
        port = {(a, s): DR.run_cell(a, s, mesh=(2, 2), smoke=True)
                for a in ARCHS for s in SHAPES}
        p.wait(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, log.read_text()[-20000:]
    ref = json.loads((tmp / "ref.json").read_text())
    return {k: (ref["/".join(k)], v) for k, v in port.items()}


def _ce_logits_flops(arch: str) -> float:
    """The logits product the port's cross entropy recomputes in its
    backward, on a rank of the smoke train cell at (2, 2): T rows of
    d_model against the rank's ceil(V / 2) vocab rows."""
    cfg = registry.smoke_config(arch)
    rows = 8 // 2 * (64 + (cfg.img_tokens if cfg.family == "vlm" else 0))
    return 2.0 * rows * cfg.d_model * -(-cfg.vocab // 2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_match_reference(flops, arch, shape):
    ref, rec = flops[arch, shape]
    port = rec["flops"]
    assert ref > 0
    want = SSD.get((arch, shape), 0)
    if shape == "train_4k":
        want += _ce_logits_flops(arch)
    assert port - ref == want
    if want == 0:
        assert abs(port - ref) <= 0.02 * ref


def test_production_cell_allocates_nothing_real():
    rec = DR.run_cell("internvl2-1b", "train_4k")
    assert REF_KEYS <= set(rec) and "trace_s" in rec
    assert rec["mesh"] == {"data": 16, "model": 16}
    mem = rec["memory"]
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert rec["real_bytes_max"] <= 64
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    assert rss < mem["peak_bytes"], (rss, mem["peak_bytes"])
    enc = rec["kernel_launches"]["lattice_encode"]
    assert enc > 0 and rec["kernel_launches"]["lattice_decode"] == enc
    assert rec["collectives"]["all-gather"] > 0
    assert rec["collectives"]["ppermute"] > 0
    assert rec["flops"] > 0 and rec["traffic_bytes"] > 0
    assert 0.0 < rec["collective_exposed_fraction"] <= 1.0


def test_cli_caches_skips_and_reanalyzes(tmp_path):
    out, ops = tmp_path / "out", tmp_path / "ops"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               DRYRUN_SAVE_OPS=str(ops))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "whisper-small", "--shapes",
           "decode_32k,long_500k", "--out", str(out)]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=600)
    assert first.returncode == 0, first.stdout + first.stderr
    assert first.stdout.count(": OK ") == 1
    assert first.stdout.count(": SKIP ") == 1
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=600)
    assert again.returncode == 0 and again.stdout.count(": cached") == 2

    path = out / "whisper-small__decode_32k__1pod.json"
    rec = json.loads(path.read_text())
    assert REF_KEYS <= set(rec) and not rec["skipped"]
    assert (ops / "whisper-small__decode_32k__1pod.ops.json.gz").exists()
    want = rec["traffic_bytes"]
    rec["traffic_bytes"] = 0.0
    path.write_text(json.dumps(rec))
    assert RA.main(str(out), str(ops)) == 1
    assert json.loads(path.read_text())["traffic_bytes"] == want


def test_dryrun_modules_import_no_jax_no_reference_no_zstandard():
    code = ("import sys, repro_torch.launch.steps, "
            "repro_torch.launch.trace_analysis, repro_torch.launch.dryrun, "
            "repro_torch.launch.reanalyze, repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'zstandard')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    for name in ("steps", "trace_analysis", "dryrun", "reanalyze", "mesh"):
        text = (ROOT / "src/repro_torch/launch" / f"{name}.py").read_text()
        for bad in ("import jax", "from jax", "import repro.", "from repro.",
                    "from repro import", "zstandard"):
            assert bad not in text, (name, bad)


@pytest.mark.parametrize("d,dtype,launches", [
    (4096, torch.float32, 1), (2, torch.bfloat16, 1),
    (1 << 16, torch.float32, 1), (1 << 18, torch.bfloat16, 1),
    (1 << 20, torch.bfloat16, 1), (1 << 23, torch.float32, 2)])
def test_fake_kernels_take_the_new_shapes(d, dtype, launches):
    """The shape-only implementations take every shape the kernels take:
    the FWHT at rows of any power of two records as many launches as the
    card makes (one up to 2^22, then 1 + one per further pass,
    ``fwht_passes``),
    each with the tensors it reads and writes (f32 between launches); the
    lattice fakes take 1-bit colors, q not a power of two and n < 32."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fwht import fwht_passes

    seen = []
    _build.reset_launch_counts()
    _build.FAKE_OBSERVERS.append(lambda k, i, o: seen.append((k, i, o)))
    try:
        x = torch.empty(3, d, dtype=dtype, device="meta")
        y = ops.fwht(x)
        assert y.shape == x.shape and y.dtype == dtype and y.is_meta
        assert _build.FAKE_LAUNCHES["fwht"] == launches
        assert launches == 1 + len(fwht_passes(d))
        assert [o[0].dtype for _, _, o in seen] == (
            [dtype] if launches == 1
            else [torch.float32] * (launches - 1) + [dtype])
        for q, n in ((2, 7), (3, 31), (12, 4097), (65535, 1)):
            xs = torch.empty(n, device="meta")
            w, k = ops.lattice_encode(xs, xs, 0.5, q=q, return_coords=True)
            assert w.shape == (TL.packed_len(n, TL.bits_for_q(q)),)
            assert k.shape == (n,)
            z = ops.lattice_decode(w, xs, xs, 0.5, q=q)
            assert z.shape == (n,) and z.dtype == torch.float32
            kb = ops.lattice_decode_batched(w.expand(4, -1), xs, xs, 0.5,
                                            q=q)
            assert kb.shape == (4, n) and kb.dtype == torch.int32
        assert _build.FAKE_LAUNCHES["lattice_encode"] == 4
        assert _build.FAKE_LAUNCHES["lattice_decode"] == 4
        assert _build.FAKE_LAUNCHES["lattice_decode_batched"] == 4
        assert sum(_build.LAUNCHES.values()) == 0
    finally:
        _build.FAKE_OBSERVERS.pop()
        _build.reset_launch_counts()
