#!/usr/bin/env python3
"""Time the bf16/f16 attention kernel at head dims 16, 32 and 64 against
another build of it, in turns on one CUDA card.

    python3 scripts/attention_small_ab.py [--other DIR] [--label NAME]
        [--rounds N] [--cases d32,d64]

Builds ``csrc/flash_attention_wgmma.cu`` of this tree as it stands
(``this``) and the same source of another tree (``--other``: a directory
holding its ``flash_attention_wgmma.cu`` and ``.cuh``, say an earlier
commit's ``csrc`` unpacked with ``git archive``, or a copy of this one
with another layout), each by its own ``nvcc`` and both at once, with
the flags of ``kernels/_build.py``.  Prints each build's registers,
spills and ptxas warnings of the small instances.  Then, at each case of
``CASES`` (the smoke's bf16 D 16 and D 32 and f16 D 64 causal shapes, S
4,096), calls every build's C launcher on the same inputs, holds its
output against the plain version on 2 of BH at the smoke's limits
(``chip_smoke.ATTENTION_TOL``) and two calls to the same bits, and takes
``device_ms`` (CUDA events around R back-to-back calls,
``chip_smoke.device_ms``) of every build in turns, the order reversed
every other round, and SDPA's beside them (its flash backend, as the
smoke times it, and its cuDNN one where it takes the shape).  One JSON
line a case and build, then a summary a case (median of the rounds); the
card's name and power limit first and ``{"ok": ...}`` last; exits 1 if
any output misses its limit or changes between calls.  Needs a CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "attention_ab"

# name -> (head dim, dtype, BH, S): causal, as the smoke's cases
CASES = {"d16": (16, "bfloat16", 32, 4096),
         "d32": (32, "bfloat16", 64, 4096),
         "d64": (64, "float16", 128, 4096),
         "d64_bf16": (64, "bfloat16", 128, 4096)}


def build_all(specs: "dict[str, Path]") -> dict:
    """Compile each source into OUT/<name>.so, all at once; returns
    {name: ptxas report} of those that built (the others' compiler output
    is printed)."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in specs.items():
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    reports = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            # the compiler's steps, to name the one that failed
            steps = subprocess.run(p.args + ["-v"], capture_output=True,
                                   text=True)
            print(f"build_failed {name} (exit {p.returncode})\n{out}\n"
                  f"{(steps.stdout + steps.stderr)[-3000:]}", flush=True)
        else:
            reports[name] = out
    return reports


def small_instances(report: str) -> dict:
    """Registers, spill stores and stack of every instance at head dims
    16-64 in a ptxas ``-v`` report, and its performance warnings."""
    out = {}
    for fn, body in re.findall(
            r"Compiling entry function '(\S+)'.*?\n(.*?)(?=ptxas info\s+: "
            r"Compiling entry|\Z)", report, re.S):
        dm = re.search(r"I(?:13__nv_bfloat16|6__half)Li(\d+)E", fn)
        if not dm or int(dm.group(1)) > 64:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        stack = re.search(r"(\d+) bytes stack frame", body)
        warn = re.findall(r"(Potential Performance Loss.*|.*setmaxnreg.*)",
                          body)
        out[fn] = dict(regs=int(regs.group(1)) if regs else None,
                       spill_stores=int(spill.group(1)) if spill else None,
                       stack=int(stack.group(1)) if stack else None,
                       warnings=warn)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--label", default="parent")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--sass", type=Path, default=None,
                    help="write the SASS of this build's bf16 D 32 "
                    "instance here")
    args = ap.parse_args()
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        print("attention_small_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    specs = {"this": csrc / "flash_attention_wgmma.cu"}
    if args.other is not None:
        specs[args.label] = args.other / "flash_attention_wgmma.cu"
    reports = build_all(specs)
    if "this" not in reports:
        return 1
    libs = {}
    for name in reports:
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        info = dict(build=name, instances=small_instances(reports[name]))
        res = getattr(libs[name], "flash_attention_wgmma_residency", None)
        if res is not None:
            res.argtypes = [ctypes.c_int, ctypes.c_int] + \
                [ctypes.POINTER(ctypes.c_int)] * 3
            occ = {}
            for f16 in (0, 1):
                for d in (16, 32, 64):
                    b, c, r = (ctypes.c_int(0) for _ in range(3))
                    err = res(f16, d, ctypes.byref(b), ctypes.byref(c),
                              ctypes.byref(r))
                    occ[f"{'f16' if f16 else 'bf16'}_d{d}"] = (
                        dict(blocks_per_sm=b.value, consumers=c.value,
                             regs=r.value) if err == 0 else f"error {err}")
            info["residency"] = occ
        info["ptxas_warnings"] = sorted(set(re.findall(
            r".*(?:Performance Loss|[Ww]arning).*", reports[name])))
        print("build " + json.dumps(info), flush=True)

    ok = True
    dev = torch.device("cuda")
    for case in args.cases.split(","):
        d, dt, bh, s = CASES[case]
        dtype = getattr(torch, dt)
        q, k, v = smoke.attention_inputs(torch, bh, bh, d, s, s, 1, dtype,
                                         seed=0)
        out = torch.empty_like(q)
        scale = FA._scale_log2(d)
        want = ref.flash_attention_ref(q[:2], k[:2], v[:2],
                                       causal=True).float()
        rtol, atol = smoke.ATTENTION_TOL[dt]
        limit = atol + rtol * want.abs()
        calls = {}
        for name, lib in libs.items():
            fn = getattr(lib, "flash_attention_wgmma_f16_launch"
                         if dtype == torch.float16
                         else "flash_attention_wgmma_launch")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn, name=name):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), bh, s, s, d, 1, scale,
                         torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            calls[name] = call
            call()
            torch.cuda.synchronize()
            first = out.clone()
            call()
            torch.cuda.synchronize()
            same = torch.equal(first.view(torch.int16), out.view(torch.int16))
            share = float(((first[:2].float() - want).abs() / limit).max())
            good = same and share <= 1.0
            ok &= good
            print("check " + json.dumps(dict(
                case=case, build=name, share_of_limit=share,
                same_bits=same, ok=good)), flush=True)
        del want, limit

        # SDPA's flash backend, as the smoke times it, and (information)
        # its cuDNN one
        def sdpa(backend):
            def run():
                with sdpa_kernel([backend]):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q[None], k[None], v[None], is_causal=True)
            return run
        libraries = {"sdpa": sdpa(SDPBackend.FLASH_ATTENTION),
                     "sdpa_cudnn": sdpa(SDPBackend.CUDNN_ATTENTION)}
        try:
            libraries["sdpa_cudnn"]()
        except RuntimeError:
            del libraries["sdpa_cudnn"]
        times = {name: [] for name in (*calls, *libraries)}
        order = list(calls)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(smoke.device_ms(torch, calls[name])[0])
            for name, fn in libraries.items():
                times[name].append(smoke.device_ms(torch, fn)[0])
        scores = bh * smoke.attention_pairs(s, s, True)
        summary = {name: dict(device_ms=statistics.median(t), runs=t,
                              scores_per_s=scores / statistics.median(t)
                              * 1e3) for name, t in times.items()}
        print("case " + json.dumps(dict(case=case, d=d, dtype=dt, bh=bh,
                                        s=s, **summary)), flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
    if args.sass:
        # the SASS of this build's bf16 instance at head dim 32
        sass = subprocess.run(
            [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
             str(OUT / "this.so")], capture_output=True, text=True,
            check=True).stdout
        parts = re.split(r"Function : (\S+)", sass)
        for fn, body in zip(parts[1::2], parts[2::2]):
            if "small_kernelI13__nv_bfloat16Li32E" in fn:
                args.sass.write_text(body)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
