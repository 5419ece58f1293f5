"""Build the port's CUDA kernels on first use, load them with ctypes, and
check the arguments their wrappers pass.

Each source in ``csrc/`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``, without fast math and without mul-add
contraction (``-fmad=false``): the kernels copy the reference's IEEE
division and separately rounded products and sums.  The libraries go to
``build/kernels/`` at the root of the checkout, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a stale
build is never loaded.  :func:`build`
starts one ``nvcc`` per missing source, all at once.

``LAUNCHES`` holds one plain integer per kernel: its wrapper adds one where
it launches the kernel, and nowhere else.  ``FAKE_LAUNCHES`` counts apart
the calls a kernel's shape-only implementation answered for a ``meta``
tensor (a traced step of the dry run, ``launch/dryrun.py``), which
:func:`record_fake` also reports to the ``FAKE_OBSERVERS``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core import lattice as L

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# the lattice kernels for q a power of two and for q not one are two
# libraries each, so that their many instances build in parallel
SOURCES = ("lattice_decode", "lattice_decode_any", "lattice_encode",
           "lattice_encode_any", "fwht", "flash_attention",
           "flash_attention_wgmma", "flash_attention_wgmma_wide",
           "flash_attention_wide", "flash_attention_split")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES = {"lattice_encode": 0, "lattice_decode": 0,
            "lattice_decode_batched": 0, "fwht": 0, "flash_attention": 0}
FAKE_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# callables (kernel, inputs, outputs) told of every shape-only call
FAKE_OBSERVERS: list = []

_libs: "dict[str, ctypes.CDLL]" = {}
_lock = threading.Lock()
# ptxas's register / shared-memory report of each library built here
PTXAS_REPORT: "dict[str, str]" = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        FAKE_LAUNCHES[k] = 0


def record_fake(kernel: str, inputs, outputs) -> None:
    """Count one shape-only call of ``kernel`` and tell the observers its
    input and output tensors (``None`` entries are left out)."""
    FAKE_LAUNCHES[kernel] += 1
    ins = [t for t in inputs if isinstance(t, torch.Tensor)]
    outs = [t for t in outputs if isinstance(t, torch.Tensor)]
    for obs in FAKE_OBSERVERS:
        obs(kernel, ins, outs)


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    # the shared headers are part of every source's hash
    src = b"".join(p.read_bytes() for p in
                   (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names=SOURCES) -> "list[str]":
    """Compile every named source whose library is missing, all at once.

    Returns the names built.  Raises with the compiler's output when any
    build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    for n in todo:
        final = library_path(n)
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        procs[n] = (tmp, subprocess.Popen(
            [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        PTXAS_REPORT[n] = out
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (exit {p.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(err: int, kernel: str) -> None:
    """Raise when a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{err}")


# the largest color space: bits_for_q raises past 16 bits per color
MAX_Q = 1 << 16


@functools.cache
def lattice_bits(q: int) -> int:
    """``core.lattice.bits_for_q``, computed once per q: it goes through
    numpy, microseconds a call that every launch would pay.  Raises for q
    outside [1, MAX_Q], as the reference's ``bits_for_q`` does."""
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"q must be in [1, {MAX_Q}] (at most 16 bits per "
                         f"color), got {q}")
    return L.bits_for_q(q)


def pow2(q: int) -> bool:
    """Whether q takes the lattice kernels' power-of-two library (else
    their ``_any`` one)."""
    return q & (q - 1) == 0


def lattice_library(name: str, q_pow2: bool) -> str:
    """The library (and ``csrc`` source) that the lattice kernels' source
    ``name`` (``lattice_encode`` or ``lattice_decode``) builds for q a power
    of two (``q_pow2``, :func:`pow2`), or for q not one: its ``_any`` one."""
    return name if q_pow2 else name + "_any"


def current_stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device`` (a device with
    an index, as a CUDA tensor's is): ``torch.cuda.current_stream(device)
    .cuda_stream`` without building a ``Stream`` object, which took 3.3 us
    of a 23 us launch at 1,024 coordinates on an H100's host
    (``scripts/lattice_kernels_ab.py``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_lattice_shape(kernel: str, q: int, bits: int, n: int) -> None:
    """Raise unless (q, n) is a shape the lattice kernels take: every shape
    the reference computes, q in [1, MAX_Q] (``bits``, its
    :func:`lattice_bits`, 1 to 16) and n >= 1 coordinates."""
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"the {kernel} kernel needs q in [1, {MAX_Q}], got "
                         f"q={q}")
    if n < 1:
        raise ValueError(f"the {kernel} kernel needs n >= 1 coordinates, "
                         f"got {n}")


def check_tensor(t, name: str, dtype: torch.dtype, device: torch.device,
                 shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape``, when given): the kernels take raw pointers."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def side_layout(s, n: int, device: torch.device, *, bucket=None,
                senders=None) -> "tuple[torch.Tensor, int, int]":
    """How a kernel reads the lattice sides: ``s[i * row + (c >> shift)]``
    for sender ``i`` and coordinate ``c``.  Returns ``(sides, row, shift)``.

    Accepted: a scalar (Python number or 0-d tensor); per-coordinate (n,);
    per-bucket (nb,) with ``bucket``; and, when ``senders`` is given,
    per-sender (senders, n) or per-sender per-bucket (senders, nb) with
    ``bucket``."""
    if not isinstance(s, torch.Tensor) or s.dim() == 0:
        t = torch.as_tensor(s, dtype=torch.float32).reshape(1).to(device)
        return t, 0, 63
    if bucket is not None:
        bucket = int(bucket)
        if bucket < 1 or bucket & (bucket - 1):
            raise ValueError(f"bucket must be a power of two, got {bucket}")
        width, shift = -(-n // bucket), bucket.bit_length() - 1
    else:
        width, shift = n, 0
    if s.dim() == 1:
        check_tensor(s, "s", torch.float32, device, (width,))
        return s, 0, shift
    if s.dim() == 2 and senders is not None:
        check_tensor(s, "s", torch.float32, device, (senders, width))
        return s, width, shift
    raise ValueError(f"sides of shape {tuple(s.shape)} do not fit {n} "
                     f"coordinates (bucket={bucket}, senders={senders})")
