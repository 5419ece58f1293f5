#!/usr/bin/env python3
"""Time the lattice encode and single-decode kernels against another
version of their sources, in turns, on one CUDA card.

    python3 scripts/lattice_kernels_ab.py --other DIR [--label parent]

``DIR`` holds ``lattice_encode.cu`` and ``lattice_decode.cu`` (and any
``*.cuh`` they include) of the version to compare with, for example an
earlier commit's ``src/repro_torch/kernels/csrc`` unpacked with ``git
show``.  Both C interfaces must be the ones ``kernels/lattice_encode.py``
and ``kernels/lattice_decode.py`` type.  The other version is built with
the same ``nvcc`` flags into ``build/kernels/<label>/``.

At each shape of the main paths (q = 16, per-bucket sides: the full-width
round, the training hop, the TP phase's DP hop, a butterfly of wk and of a
norm) the script calls both C launchers on the same tensors, holds their
outputs equal bit for bit, and times them in turns (other, this, this,
other):

* ``device_ms``: CUDA events around R back-to-back launches, over R
  (``chip_smoke.device_ms``);
* ``graph_ms``: the same R launches captured in a CUDA graph and replayed,
  over R: the device's time without the host's launch work
  (``chip_smoke.graph_ms``).

It then measures the wrappers' host cost per call at 1,024 coordinates
(``time.perf_counter`` over 1,000 calls, then one synchronize), as they
are and with the per-call costs they no longer pay put back, and the parts
of a call one at a time.  Prints one JSON line per result, then
``{"ok": true, ...}``.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

# (label, n, bucket) of the main paths' encodes and single decodes
SHAPES = (("full_width", 277_848_064, 4096),
          ("train_hop", smoke.TRAIN_HOP_N, 4096),
          ("dp_hop", smoke.TP_HOP_N, 4096),
          ("tp_butterfly_wk", 896 * 128, 4096),
          ("tp_butterfly_norm", 1024, 1024))
Q, BITS = 16, 4
HOST_CALLS = 1000


def build_other(src_dir: Path, label: str) -> "dict[str, ctypes.CDLL]":
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / label
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("lattice_encode", "lattice_decode"):
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src_dir / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        report, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{label} {name}.cu did not build:\n{report}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def typed(lib_enc, lib_dec):
    """The two C launchers of one version, typed as the wrappers type
    them."""
    from repro_torch.kernels import lattice_decode as LD
    from repro_torch.kernels import lattice_encode as LE

    enc = lib_enc.lattice_encode_launch
    dec = lib_dec.lattice_decode_launch
    for fn, like in ((enc, LE._launcher()), (dec, LD._single_launcher())):
        fn.argtypes, fn.restype = like.argtypes, like.restype
    return enc, dec


def time_shape(torch, label, n, bucket, this, other, other_label):
    from repro_torch.core import lattice as L

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n)
    nb = -(-n // bucket)
    x = torch.randn(n, generator=g, device=dev)
    u = torch.rand(n, generator=g, device=dev) - 0.5
    a = x + 0.02 * torch.randn(n, generator=g, device=dev)
    sides = (2 * 0.25 / 15) * (0.5 + torch.rand(nb, generator=g, device=dev))
    shift = bucket.bit_length() - 1
    nw = L.packed_len(n, BITS)
    full = label == "full_width"
    # the full-width round encodes with coords and an anchor; the hops
    # encode words alone, unanchored, as the collectives do
    anchored = full
    outs = {}
    for ver in ("other", "this"):
        outs[ver] = dict(
            words=torch.empty(nw, dtype=torch.int32, device=dev),
            coords=torch.empty(n, dtype=torch.int32, device=dev)
            if full else None,
            k=torch.empty(n, dtype=torch.int32, device=dev))

    def calls(ver):
        enc, dec = this if ver == "this" else other
        o = outs[ver]
        e_args = (x.data_ptr(), a.data_ptr() if anchored else None,
                  u.data_ptr(), sides.data_ptr(), shift,
                  o["words"].data_ptr(),
                  o["coords"].data_ptr() if full else None, n, Q, BITS)
        # decode the other version's words, so both decode the same bits
        d_args = (outs["other"]["words"].data_ptr(), a.data_ptr(),
                  u.data_ptr(), None, sides.data_ptr(), shift,
                  o["k"].data_ptr(), 1, 0, 0.0, 1.0, n, Q, BITS)

        # the stream is read at each call: a graph captures on its own
        def run_enc():
            smoke.check(enc(*e_args, torch.cuda.current_stream().cuda_stream)
                        == 0, f"{ver} encode launch failed")

        def run_dec():
            smoke.check(dec(*d_args, torch.cuda.current_stream().cuda_stream)
                        == 0, f"{ver} decode launch failed")
        return run_enc, run_dec

    fns = {ver: calls(ver) for ver in ("other", "this")}
    for ver in ("other", "this"):
        fns[ver][0]()
    torch.cuda.synchronize()
    for ver in ("other", "this"):
        fns[ver][1]()
    torch.cuda.synchronize()
    for key in ("words", "coords", "k"):
        if outs["this"][key] is not None:
            smoke.check(torch.equal(outs["this"][key], outs["other"][key]),
                        f"{label}: this {key} differs from {other_label}'s")
    b_enc, by_enc = smoke.bound(
        n * (4 + 4 + (4 if anchored else 0) + BITS / 8 + (4 if full else 0))
        + nb * 4, n * (5 if anchored else 4))
    b_dec, by_dec = smoke.bound(n * (BITS / 8 + 4 + 4 + 4) + nb * 4, n * 4)
    for kernel, idx, b, by in (("lattice_encode", 0, b_enc, by_enc),
                               ("lattice_decode", 1, b_dec, by_dec)):
        turns = []
        for ver in ("other", "this", "this", "other"):
            fn = fns[ver][idx]
            dms, reps = smoke.device_ms(torch, fn)
            gms = smoke.graph_ms(torch, fn, reps)
            turns.append(dict(version=ver, device_ms=dms, graph_ms=gms,
                              reps=reps))
        this_d = [t["device_ms"] for t in turns if t["version"] == "this"]
        oth_d = [t["device_ms"] for t in turns if t["version"] == "other"]
        this_g = [t["graph_ms"] for t in turns if t["version"] == "this"]
        oth_g = [t["graph_ms"] for t in turns if t["version"] == "other"]
        smoke.say("lattice_ab", kernel=kernel, shape=label, n=n,
                  bucket=bucket, anchored=anchored if idx == 0 else None,
                  coords=full if idx == 0 else True, bound_ms=b,
                  bound_by=by, other=other_label, turns=turns,
                  this_device_ms=statistics.mean(this_d),
                  other_device_ms=statistics.mean(oth_d),
                  this_share_of_bound=b / statistics.mean(this_d),
                  other_share_of_bound=b / statistics.mean(oth_d),
                  this_graph_ms=statistics.mean(this_g),
                  other_graph_ms=statistics.mean(oth_g))
    del x, u, a, sides, outs, fns
    torch.cuda.empty_cache()


def host_costs(torch) -> None:
    """The wrappers' host microseconds per call at 1,024 coordinates, as
    they are and with the three per-call costs they no longer pay put back
    (the launcher loaded and typed, ``bits_for_q`` through numpy, a
    ``torch.cuda.Stream`` built for its handle), and each part of a call
    alone."""
    from repro_torch.core import lattice as L
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import lattice_decode as LD
    from repro_torch.kernels import lattice_encode as LE

    n, bucket = 1024, 1024
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(n, generator=g, device="cuda")
    u = torch.rand(n, generator=g, device="cuda") - 0.5
    sides = torch.full((1,), 0.03, device="cuda")
    words = ops.lattice_encode(x, u, sides, q=Q, bucket=bucket)
    dev = x.device      # with its index, as the wrappers compare devices

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / HOST_CALLS * 1e6

    def enc():
        ops.lattice_encode(x, u, sides, q=Q, bucket=bucket)

    def dec():
        ops.lattice_decode(words, x, u, sides, q=Q, mode="coords",
                           bucket=bucket)

    def public_stream(d):
        return torch.cuda.current_stream(d).cuda_stream
    now = (LE._launcher, LD._single_launcher, _build.lattice_bits,
           _build.current_stream)
    before = (now[0].__wrapped__, now[1].__wrapped__, L.bits_for_q,
              public_stream)
    out = {}
    for label, fns in (("now", now), ("before", before), ("now_again", now)):
        (LE._launcher, LD._single_launcher, _build.lattice_bits,
         _build.current_stream) = fns
        out[f"encode_us_{label}"] = per_call(enc)
        out[f"decode_us_{label}"] = per_call(dec)
    fn = LE._launcher()
    w = torch.empty(L.packed_len(n, BITS), dtype=torch.int32, device=dev)
    args = (x.data_ptr(), None, u.data_ptr(), sides.data_ptr(), 10,
            w.data_ptr(), None, n, Q, BITS, _build.current_stream(dev))
    parts = {
        "ops_dispatch": lambda: ops._on_cpu(x),
        "check_lattice_shape": lambda: _build.check_lattice_shape(
            "encode", Q, BITS, n),
        "check_tensor": lambda: _build.check_tensor(x, "x", torch.float32,
                                                    dev, (n,)),
        "side_layout": lambda: _build.side_layout(sides, n, dev,
                                                  bucket=bucket),
        "torch_empty": lambda: torch.empty(L.packed_len(n, BITS),
                                           dtype=torch.int32, device=dev),
        "data_ptrs": lambda: (x.data_ptr(), u.data_ptr(), sides.data_ptr(),
                              w.data_ptr()),
        "ctypes_launch": lambda: fn(*args),
        "bits_for_q_numpy": lambda: L.bits_for_q(Q),
        "lattice_bits_cached": lambda: _build.lattice_bits(Q),
        "stream_public": lambda: public_stream(dev),
        "stream_raw": lambda: _build.current_stream(dev),
        "launcher_load_and_type": before[0],
    }
    out["parts_us"] = {k: per_call(v) for k, v in parts.items()}
    smoke.say("lattice_host_us", n=n, calls=HOST_CALLS, **out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="directory of the other version's sources")
    ap.add_argument("--label", default="parent")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("lattice_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    smoke.say("card", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda)
    _build.build(("lattice_encode", "lattice_decode"))
    other_libs = build_other(args.other.resolve(), args.label)
    this = typed(_build.load("lattice_encode"), _build.load("lattice_decode"))
    other = typed(other_libs["lattice_encode"], other_libs["lattice_decode"])
    for label, n, bucket in SHAPES:
        time_shape(torch, label, n, bucket, this, other, args.label)
    host_costs(torch)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
