#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's aggregation round on one CUDA card.

    python3 chip_smoke.py [--seed N]   # d = 277,845,504, 16 clients

The port (``src/repro_torch``) is the only thing imported: no JAX and
nothing of the JAX package.  The script

1. prints the card's name and power limit, and builds every CUDA kernel
   from the sources in the checkout (one ``nvcc`` per source, all at once);
2. holds each kernel of the round's path against its plain torch version
   at the path's shapes — the comparison on a leading slice of 2^24
   coordinates (the plain versions' temporaries are too large for the
   whole shape), the timing at the full shape — and prints its time,
   bound, plain time and library-call time;
3. runs round A: an unrotated, unanchored round of 16 clients over a
   277,845,504-dimensional vector (the gradient of whisper-small, the
   smallest model the repo configures), q = 16, bucket = 4096, y0 = 0.25;
   the server's anchor is ``base ~ N(0,1)`` and client i sends
   ``base + 0.02 N(0,1)``, all made on the card from ``--seed``; frames
   cross as bytes; checks that every client is accepted at attempt 0 in
   exactly one batched decode launch and that the mean is within 0.51 s of
   the exact mean in every coordinate; times each phase, and the drain's
   parts (upload, decode, epilogue);
4. runs round B: the same clients, rotated (§6) and anchored at round A's
   mean; checks ||mean - exact||_2 <= 0.51 s sqrt(N);
5. runs a small round (d = 2^18, 8 clients) once on the card and once on
   the CPU (plain versions) and requires bitwise equal means, and a
   chunked, windowed streaming round on the card that must equal the
   sealed drain bit for bit;
6. times the round's costs outside the kernels at full width (the threefry
   draws, the anchor digest, one CRC-32 pass over a frame);
7. prints the ``kernels`` line, then the ``ok`` line last.

Every count of kernel launches is set to 0 just before rounds A and B and
read just after them; a kernel of the path that was not launched there
fails the run.  Any failed check raises before the last line is printed.
Without a CUDA device, or without the port beside it, the script exits
with a nonzero code and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
SLICE = 1 << 24                  # coordinates compared against the plain version
FULL_D = 277_845_504             # whisper-small's parameter count
CLIENTS = 16                     # clients per full-width round
KERNEL_SOURCES = {
    "lattice_encode": ("src/repro_torch/kernels/csrc/lattice_encode.cu",
                       "src/repro/kernels/lattice_encode.py:70"),
    "lattice_decode_batched": ("src/repro_torch/kernels/csrc/lattice_decode.cu",
                               "src/repro/kernels/lattice_decode.py:180"),
    "fwht": ("src/repro_torch/kernels/csrc/fwht.cu",
             "src/repro/kernels/fwht.py:95"),
}


class SmokeError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def say(tag: str, **fields) -> None:
    print(f"{tag} {json.dumps(fields)}", flush=True)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> "tuple[float, str]":
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> float:
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_checks(torch, n_pad: int, bucket: int, senders: int, seed: int):
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    q, bits = 16, 4
    nb = n_pad // bucket
    side = 2 * 0.25 / 15
    out = {}

    # --- encode: first attempt (words + coords), per-bucket sides drawn at
    # random around the round's side, so that a kernel reading another
    # bucket's side disagrees; once without an anchor (round A) and once
    # with one (round B)
    x = torch.randn(n_pad, generator=g, device=dev)
    u = torch.rand(n_pad, generator=g, device=dev) - 0.5
    sides = side * (0.5 + torch.rand(nb, generator=g, device=dev))
    a = x + 0.02 * torch.randn(n_pad, generator=g, device=dev)
    L_ = min(SLICE, n_pad)
    err = 0.0
    for anc in (None, a):
        words, k = ops.lattice_encode(x, u, sides, q=q, return_coords=True,
                                      anchor=anc, bucket=bucket)
        torch.cuda.synchronize()
        ww, wk = ref.lattice_encode_ref(
            x[:L_], u[:L_], sides[:L_ // bucket], q=q, bits=bits,
            return_coords=True, anchor=None if anc is None else anc[:L_],
            bucket=bucket)
        check(torch.equal(words[:L_ // 8], ww) and torch.equal(k[:L_], wk),
              "lattice_encode disagrees with its plain version (anchor="
              f"{anc is not None})")
        err = max(err, max_abs_err(torch, words[:L_ // 8], ww),
                  max_abs_err(torch, k[:L_], wk))
        del words, k, ww, wk
    ms = cuda_ms(torch, lambda: ops.lattice_encode(
        x, u, sides, q=q, return_coords=True, bucket=bucket))
    ms_anchored = cuda_ms(torch, lambda: ops.lattice_encode(
        x, u, sides, q=q, return_coords=True, anchor=a, bucket=bucket))
    del a

    def plain_encode():
        for c0 in range(0, n_pad, SLICE):
            c1 = min(n_pad, c0 + SLICE)
            ref.lattice_encode_ref(x[c0:c1], u[c0:c1],
                                   sides[c0 // bucket:c1 // bucket], q=q,
                                   bits=bits, return_coords=True,
                                   bucket=bucket)
    plain = cuda_ms(torch, plain_encode, reps=1)
    b, by = bound(n_pad * (4 + 4 + bits / 8 + 4) + nb * 4, n_pad * 4)
    b_anc, _ = bound(n_pad * (4 + 4 + 4 + bits / 8 + 4) + nb * 4, n_pad * 5)
    out["lattice_encode"] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                 bound_by=by, library_ms=None,
                                 max_abs_err=err,
                                 shape=f"N={n_pad}, q={q}, coords",
                                 anchored_ms=ms_anchored,
                                 anchored_bound_ms=b_anc)

    # --- batched decode: coords mode, per-sender per-bucket sides, each
    # sender's drawn on its own around the round's side
    words = torch.randint(-(1 << 31), (1 << 31) - 1, (senders, n_pad // 8),
                          generator=g, device=dev, dtype=torch.int32)
    s_s = side * (0.5 + torch.rand((senders, nb), generator=g, device=dev))
    kd = ops.lattice_decode_batched(words, x, u, s_s, q=q, mode="coords",
                                    bucket=bucket)
    torch.cuda.synchronize()
    want = ref.lattice_decode_batched_ref(
        words[:, :L_ // 8], x[:L_], u[:L_], s_s[:, :L_ // bucket], q=q,
        bits=bits, n=L_, mode="coords", bucket=bucket)
    check(torch.equal(kd[:, :L_], want),
          "lattice_decode_batched disagrees with its plain version")
    err = max_abs_err(torch, kd[:, :L_], want)
    del kd, want
    ms = cuda_ms(torch, lambda: ops.lattice_decode_batched(
        words, x, u, s_s, q=q, mode="coords", bucket=bucket))
    step = max(bucket, (SLICE // senders) // bucket * bucket)

    def plain_decode():
        for c0 in range(0, n_pad, step):
            c1 = min(n_pad, c0 + step)
            ref.lattice_decode_batched_ref(
                words[:, c0 // 8:c1 // 8], x[c0:c1], u[c0:c1],
                s_s[:, c0 // bucket:c1 // bucket], q=q, bits=bits,
                n=c1 - c0, mode="coords", bucket=bucket)
    plain = cuda_ms(torch, plain_decode, reps=1)
    b, by = bound(senders * n_pad * (bits / 8 + 4) + n_pad * 8
                  + senders * nb * 4, senders * n_pad * 4)
    out["lattice_decode_batched"] = dict(
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        max_abs_err=err, shape=f"S={senders}, N={n_pad}, q={q}, coords")
    del words, s_s, u
    torch.cuda.empty_cache()

    # --- fwht over (nb, bucket) rows, f32
    xb = x.reshape(nb, bucket)
    y = ops.fwht(xb)
    torch.cuda.synchronize()
    rows = max(1, L_ // bucket)
    want = ref.fwht_ref(xb[:rows])
    check(torch.allclose(y[:rows], want, rtol=1e-5, atol=1e-4),
          "fwht disagrees with its plain version")
    err = max_abs_err(torch, y[:rows], want)
    del y, want
    ms = cuda_ms(torch, lambda: ops.fwht(xb))

    def plain_fwht():
        for r0 in range(0, nb, rows):
            ref.fwht_ref(xb[r0:r0 + rows])
    plain = cuda_ms(torch, plain_fwht, reps=1)
    # the yardstick: one dense product with the scaled Hadamard matrix
    # (full f32, TF32 off), timed here and used nowhere in the port
    torch.backends.cuda.matmul.allow_tf32 = False
    h = ref.fwht_ref(torch.eye(bucket, device=dev))
    lib = cuda_ms(torch, lambda: torch.matmul(xb, h), reps=3)
    logd = bucket.bit_length() - 1
    b, by = bound(n_pad * 8, n_pad * (logd + 1))
    out["fwht"] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                       library_ms=lib, max_abs_err=err,
                       shape=f"({nb}, {bucket}) f32")
    del x, xb, h
    torch.cuda.empty_cache()
    for name, r in out.items():
        say("kernel_check", name=name, **r)
    return out


# ---------------------------------------------------------------------------
# Phases 3-4: the round at full width
# ---------------------------------------------------------------------------

def client_vector(torch, base, seed: int, i: int):
    g = torch.Generator(device=base.device).manual_seed(seed * 1000 + 1 + i)
    return base + 0.02 * torch.randn(base.shape[0], generator=g,
                                     device=base.device)


@contextlib.contextmanager
def drain_timers(torch, acc):
    """While open, time (host clock, synchronized on both sides) every call
    of the server's drain math into ``acc["drain_math"]`` and every batched
    decode into ``acc["decode"]``; both functions are restored on exit."""
    from repro_torch.agg import server as server_mod
    from repro_torch.kernels import ops

    def timed(fn, key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return r
        return call

    math, decode = server_mod._drain_math, ops.lattice_decode_batched
    server_mod._drain_math = timed(math, "drain_math")
    ops.lattice_decode_batched = timed(decode, "decode")
    try:
        yield
    finally:
        server_mod._drain_math, ops.lattice_decode_batched = math, decode


def run_round(torch, spec, base, anchor, n_clients: int, seed: int):
    """Encode every client one at a time, frame to bytes, receive, drain,
    finalize; returns (mean, stats, exact mean (f64), per-phase seconds,
    decode launches in the drain, responses)."""
    from repro_torch.agg.client import AggClient
    from repro_torch.agg.server import AggServer
    from repro_torch.kernels import _build

    t = dict(encode=0.0, frame=0.0, receive=0.0, drain=0.0, finalize=0.0)
    t0 = time.perf_counter()
    server = AggServer(spec, base if anchor is None else anchor)
    torch.cuda.synchronize()
    t["server_setup"] = time.perf_counter() - t0
    exact = torch.zeros(spec.d, dtype=torch.float64, device=base.device)
    for i in range(n_clients):
        x = client_vector(torch, base, seed, i)
        exact += x.to(torch.float64)
        t0 = time.perf_counter()
        c = AggClient(spec, i, x, anchor=anchor)
        c.encode()                      # ends in a device-to-host copy
        t1 = time.perf_counter()
        frames = c.frames()
        t2 = time.perf_counter()
        del c, x
        for f in frames:
            r = server.receive(f)
        t3 = time.perf_counter()
        t["encode"] += t1 - t0
        t["frame"] += t2 - t1
        t["receive"] += t3 - t2
        del frames, r
    exact /= n_clients
    before = _build.LAUNCHES["lattice_decode_batched"]
    split = dict(drain_math=0.0, decode=0.0)
    t0 = time.perf_counter()
    with drain_timers(torch, split):
        responses = server.drain()
    torch.cuda.synchronize()
    t["drain"] = time.perf_counter() - t0
    # the drain's parts: stacking the payloads and uploading them (with the
    # little host work after the math), the decode launch, the epilogue
    t["drain_upload_and_host"] = t["drain"] - split["drain_math"]
    t["drain_decode"] = split["decode"]
    t["drain_epilogue"] = split["drain_math"] - split["decode"]
    launches = _build.LAUNCHES["lattice_decode_batched"] - before
    t0 = time.perf_counter()
    mean, stats = server.finalize()
    torch.cuda.synchronize()
    t["finalize"] = time.perf_counter() - t0
    return mean, stats, exact, t, launches, responses


def check_responses(responses, n_clients: int, tag: str) -> None:
    from repro_torch.agg.transport import frame as wire
    rs = [wire.decode_response(b) for b in responses]
    acks = sorted(r.client_id for r in rs if r.status == wire.STATUS_ACK)
    check(acks == list(range(n_clients)),
          f"{tag}: not every client was ACKed at attempt 0: {acks}")


def rounds_ab(torch, d: int, n_clients: int, seed: int):
    from repro_torch.agg import rounds
    from repro_torch.agg.transport import frame as wire
    from repro_torch.dist.collectives import QSyncConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn(d, generator=g, device=dev)
    cfg = QSyncConfig(q=16, bucket=4096)
    spec_a = wire.RoundSpec(round_id=1, d=d, cfg=cfg, y0=0.25, seed=seed)
    s = 2 * spec_a.y0 / (cfg.q - 1)

    _build.reset_launch_counts()
    ops.reset_dispatch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mean_a, stats_a, exact, t_a, dec_a, resp_a = run_round(
        torch, spec_a, base, None, n_clients, seed)
    wall_a = time.perf_counter() - t0
    check_responses(resp_a, n_clients, "round A")
    check(dec_a == 1, f"round A drain made {dec_a} batched decode launches")
    check(stats_a.accepted == n_clients and stats_a.decode_failures == 0,
          f"round A accepted {stats_a.accepted} of {n_clients}")
    check(tuple(mean_a.shape) == (d,) and bool(torch.isfinite(mean_a).all()),
          "round A mean is not a finite (d,) vector")
    err_a = float((mean_a.to(torch.float64) - exact).abs().max())
    check(err_a <= 0.51 * s,
          f"round A: max |mean - exact| = {err_a} > 0.51 s = {0.51 * s}")
    enc_a = dict(_build.LAUNCHES)
    say("round_A", d=d, padded=spec_a.padded, clients=n_clients,
        accepted=stats_a.accepted, attempt0=True, decode_launches=dec_a,
        encode_launches=enc_a["lattice_encode"],
        fwht_launches=enc_a["fwht"], max_abs_err=err_a,
        bound=0.51 * s, seconds=t_a, wall_s=wall_a,
        payload_bytes=wire.payload_bytes(spec_a),
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    del exact

    anchor = mean_a
    spec_b = dataclasses.replace(
        spec_a, round_id=2, cfg=dataclasses.replace(cfg, rotate=True),
        anchor_digest=rounds.anchor_digest(anchor))
    t0 = time.perf_counter()
    mean_b, stats_b, exact, t_b, dec_b, resp_b = run_round(
        torch, spec_b, base, anchor, n_clients, seed)
    wall_b = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)     # read just after the main path
    check_responses(resp_b, n_clients, "round B")
    check(dec_b == 1, f"round B drain made {dec_b} batched decode launches")
    check(tuple(mean_b.shape) == (d,) and bool(torch.isfinite(mean_b).all()),
          "round B mean is not a finite (d,) vector")
    l2 = float(torch.linalg.vector_norm(mean_b.to(torch.float64) - exact))
    lim = 0.51 * s * spec_b.padded ** 0.5
    check(l2 <= lim, f"round B: ||mean - exact||_2 = {l2} > {lim}")
    say("round_B", d=d, clients=n_clients, accepted=stats_b.accepted,
        decode_launches=dec_b,
        encode_launches=counts["lattice_encode"] - enc_a["lattice_encode"],
        fwht_launches=counts["fwht"] - enc_a["fwht"], l2_err=l2, bound=lim,
        seconds=t_b, wall_s=wall_b)
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return counts


# ---------------------------------------------------------------------------
# Phase 5: card vs CPU, and the streaming drain
# ---------------------------------------------------------------------------

def small_rounds(torch, seed: int) -> None:
    import numpy as np

    from repro_torch.agg.client import AggClient
    from repro_torch.agg.server import AggServer
    from repro_torch.agg.transport import frame as wire
    from repro_torch.dist.collectives import QSyncConfig

    d, n = 1 << 18, 8
    rng = np.random.RandomState(seed)
    base = rng.randn(d).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(n, d).astype(np.float32)
    spec = wire.RoundSpec(round_id=5, d=d, cfg=QSyncConfig(q=16, bucket=4096),
                          y0=0.25, seed=seed)
    means = {}
    for dev in ("cuda", "cpu"):
        server = AggServer(spec, base, device=dev)
        for i in range(n):
            server.receive(AggClient(spec, i, xs[i], device=dev).payload())
        means[dev] = server.finalize()[0].cpu().numpy()
    check(np.array_equal(means["cuda"].view(np.uint32),
                         means["cpu"].view(np.uint32)),
          "small round: the card's mean differs from the CPU's")

    spec_w = dataclasses.replace(spec, round_id=6, mtu=4096, window=4)
    sealed = AggServer(spec_w, base, streaming=False)
    clients = [AggClient(spec_w, i, xs[i]) for i in range(n)]
    for c in clients:
        for f in c.frames():
            sealed.receive(f)
    want = sealed.finalize()[0].cpu().numpy()
    stream = AggServer(spec_w, base)
    outbox = [(c, f) for c in clients for f in c.send_frames()]
    for _ in range(1000):
        nxt = []
        for c, f in outbox:
            for rb in stream.ingest_frame(f):
                nxt.extend((c, g) for g in c.handle_response(rb))
        for m in stream.tick():
            r = wire.decode_response(m)
            nxt.extend((c, g) for c in clients if c.client_id == r.client_id
                       for g in c.handle_response(m))
        outbox = nxt
        if all(c.acked for c in clients):
            break
    check(all(c.acked for c in clients), "streaming round did not finish")
    stream.seal()
    pub = stream.published()
    check(len(pub) == 1 and pub[0].accepted == frozenset(range(n)),
          "streaming round did not publish every client")
    got = pub[0].mean.cpu().numpy()
    check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
          "streaming round differs from the sealed drain")
    say("small_rounds", d=d, clients=n, card_equals_cpu=True,
        chunks_per_client=len(clients[0].frames()),
        streaming_equals_sealed=True)


def host_costs(torch, d: int, seed: int) -> None:
    """Time the round's non-kernel costs at full width, one at a time:
    the two threefry draws a party makes (dither, checksum weights), the
    anchor digest, and one CRC-32 pass over a payload-sized frame."""
    import zlib

    from repro_torch.agg import rounds
    from repro_torch.agg.transport import frame as wire
    from repro_torch.dist.collectives import QSyncConfig

    spec = wire.RoundSpec(round_id=1, d=d, cfg=QSyncConfig(q=16, bucket=4096),
                          y0=0.25, seed=seed)
    out = {}
    for name, fn in (("dither_draw", lambda: rounds.dither(spec, "cuda")),
                     ("weights_draw",
                      lambda: rounds.checksum_weights(spec, "cuda"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    v = torch.zeros(d, device="cuda")
    t0 = time.perf_counter()
    rounds.anchor_digest(v)
    out["anchor_digest"] = time.perf_counter() - t0
    frame = bytes(wire.payload_bytes(spec))
    t0 = time.perf_counter()
    zlib.crc32(frame)
    out["crc32_frame"] = time.perf_counter() - t0
    say("host_costs", seconds=out, frame_bytes=len(frame))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port is missing ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    from repro_torch.agg.transport import frame as wire
    from repro_torch.dist.collectives import QSyncConfig
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = {}
    for name, report in _build.PTXAS_REPORT.items():
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", report)]
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                             report)]
        ptxas[name] = dict(max_registers=max(regs, default=None),
                           spill_store_bytes=sum(spills))
    say("build", seconds=time.perf_counter() - t0, built=built, ptxas=ptxas)

    spec = wire.RoundSpec(round_id=1, d=FULL_D,
                          cfg=QSyncConfig(q=16, bucket=4096))
    checks = kernel_checks(torch, spec.padded, spec.cfg.bucket, CLIENTS,
                           args.seed)
    counts = rounds_ab(torch, FULL_D, CLIENTS, args.seed)
    small_rounds(torch, args.seed)
    host_costs(torch, FULL_D, args.seed)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = checks[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    say("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
