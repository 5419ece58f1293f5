"""Bit-exact threefry2x32 draws: the port's counterpart of ``jax.random``.

The aggregation protocol's shared randomness is part of the wire contract:
the dither ``u``, the §5 checksum weights and the §6 Hadamard diagonal are
all drawn from ``jax.random`` keys in the reference, and a port client's
frames match a reference client's only if these streams match bit for bit.
This module reproduces exactly the calls the protocol makes, in JAX's
*partitionable* threefry mode (``jax_threefry_partitionable=True``):

* ``PRNGKey(seed)`` -> the raw key pair ``(0, seed & 0xFFFFFFFF)``;
* ``fold_in(key, data)`` -> ``threefry(key, (0, data))``;
* ``split(key, num)`` -> ``threefry(key, (0, i))`` for ``i < num``;
* ``bits(key, shape)`` -> element ``i`` (row-major) is ``y0 ^ y1`` of
  ``threefry(key, (i >> 32, i & 0xFFFFFFFF))``;
* ``uniform`` and ``rademacher`` from those bits as ``jax.random`` builds
  them (mantissa fill, then shift and scale);
* ``randint``, ``permutation`` and ``normal`` as ``jax.random`` builds
  them from ``split`` and ``bits`` (``normal`` only to ``allclose``: torch's
  ``erfinv`` is not XLA's);
* ``bernoulli`` (``uniform < p``), ``gumbel`` (``-log(-log(uniform(tiny,
  1)))``) and ``categorical`` (the argmax of ``gumbel + logits``) as
  ``jax.random`` builds them; the two logs are torch's, which may differ
  from XLA's in the last bit, so an argmax can flip where two categories
  tie to within an ulp.

Element ``i`` of a draw depends on ``i`` alone, so a caller that needs only
part of a draw names it: ``span=(start, stop)`` returns elements
``start .. stop - 1`` of the flattened row-major draw of ``shape`` (as a
flat tensor), and ``rows=(r0, r1)`` returns rows ``r0 .. r1 - 1`` of the
leading axis; either is bitwise the same slice of the whole draw.

A key is a pair of Python ints.  Bulk draws run on the device the caller
names — the CUDA device unless it names another (``device="cpu"``); with
no card and no device they raise, as the port's entry points do — in
plain torch int64 masked to 32 bits (torch has no unsigned 32-bit
arithmetic), in chunks so that no int64 temporary exceeds a few hundred MB
whatever the draw size.  uint32 results are returned as int32 bit views.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from repro_torch import resolve_device

Key = tuple  # (k1, k2), each in [0, 2^32)
_M32 = 0xFFFFFFFF
# elements per chunk of a bulk draw: eight int64 temporaries of this size
# stay well under a GB
_CHUNK = 1 << 24
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def _threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round Threefry-2x32 hash of count pairs (x0, x1) under key.

    x0, x1: int64 tensors holding values in [0, 2^32).  Returns (y0, y1)
    in the same form."""
    k1, k2 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def _hash_pair(key: Key, hi: int, lo: int) -> Key:
    """threefry of one count pair, on the host in Python integers (the
    hash's operators are the same on ints as on int64 tensors): no tensor
    op runs, so a traced step records none for its key derivations."""
    y0, y1 = _threefry2x32(key, int(hi) & _M32, int(lo) & _M32)
    return int(y0), int(y1)


def PRNGKey(seed: int) -> Key:
    """The raw key of an integer seed, as ``jax.random.PRNGKey`` builds it
    with 64-bit types off: the seed's low 32 bits, behind a zero word."""
    return (0, int(seed) & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: a new key from ``key`` and a uint32 datum."""
    return _hash_pair(key, 0, int(data) & _M32)


def split(key: Key, num: int = 2) -> "tuple[Key, ...]":
    """``jax.random.split`` in partitionable mode: ``num`` new keys."""
    y0, y1 = _threefry2x32(key, torch.zeros(num, dtype=torch.int64),
                           torch.arange(num, dtype=torch.int64))
    return tuple((int(a), int(b)) for a, b in zip(y0.tolist(), y1.tolist()))


def _shape(shape: Shape) -> "tuple[int, ...]":
    return (int(shape),) if isinstance(shape, int) else tuple(map(int, shape))


def _span(shape: "tuple[int, ...]", span=None, rows=None
          ) -> "tuple[int, int, tuple[int, ...]]":
    """(start, stop, output shape) of the part of a draw a caller asked
    for: all of it, a flat element ``span``, or a ``rows`` range of the
    leading axis."""
    n = math.prod(shape)
    if n >= (1 << 32):
        raise ValueError(f"draw of {n} elements exceeds 2^32")
    if span is not None and rows is not None:
        raise ValueError("pass span or rows, not both")
    if rows is not None:
        r0, r1 = (int(v) for v in rows)
        if not 0 <= r0 <= r1 <= shape[0]:
            raise ValueError(f"rows {rows} outside 0..{shape[0]}")
        row = math.prod(shape[1:])
        return r0 * row, r1 * row, (r1 - r0,) + tuple(shape[1:])
    if span is not None:
        c0, c1 = (int(v) for v in span)
        if not 0 <= c0 <= c1 <= n:
            raise ValueError(f"span {span} outside 0..{n}")
        return c0, c1, (c1 - c0,)
    return 0, n, shape


def _draw(key: Key, shape: Shape, device, dtype, fn, span=None,
          rows=None) -> torch.Tensor:
    """Run ``fn`` over the int64 uint32 bits of a row-major draw, chunk by
    chunk, into an output of ``dtype``; only the part named by ``span`` or
    ``rows`` (see the module docstring) is drawn.  On the ``meta`` device
    (a dry run's traced step, ``launch/dryrun.py``) there are no bits to
    draw: the draw is one fill of its output, as a compiler fuses it."""
    start, stop, out_shape = _span(_shape(shape), span, rows)
    if torch.device(device).type == "meta":
        return torch.zeros(out_shape, dtype=dtype, device=device)
    out = torch.empty(stop - start, dtype=dtype, device=device)
    for c0 in range(start, stop, _CHUNK):
        c1 = min(stop, c0 + _CHUNK)
        lo = torch.arange(c0, c1, dtype=torch.int64, device=device)
        y0, y1 = _threefry2x32(key, torch.zeros_like(lo), lo)
        out[c0 - start:c1 - start] = fn(y0 ^ y1)
    return out.reshape(out_shape)


def as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit view."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def bits(key: Key, shape: Shape, *, device=None, span=None,
         rows=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int32 bit view."""
    return _draw(key, shape, resolve_device(device), torch.int32,
                 as_int32_bits, span, rows)


def _unit_floats(v: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): 23 random mantissa bits under the
    exponent of 1.0, minus 1 (exact)."""
    fb = ((v >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key: Key, shape: Shape, minval: float = 0.0, maxval: float = 1.0,
            *, device=None, span=None, rows=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    device = resolve_device(device)
    lo = torch.tensor(minval, dtype=torch.float32)
    width = torch.tensor(maxval, dtype=torch.float32) - lo
    lo_d, span_d = lo.to(device), width.to(device)

    def fn(v):
        return torch.maximum(_unit_floats(v) * span_d + lo_d, lo_d)
    return _draw(key, shape, device, torch.float32, fn, span, rows)


def rademacher(key: Key, shape: Shape, *, device=None) -> torch.Tensor:
    """``jax.random.rademacher(key, shape, float32)``: +1 where the
    bernoulli(0.5) draw ``uniform < 0.5`` holds, else -1."""
    def fn(v):
        return torch.where(_unit_floats(v) < 0.5, 1.0, -1.0)
    return _draw(key, shape, resolve_device(device), torch.float32, fn)


def randint(key: Key, shape: Shape, minval: int, maxval: int, *,
            device=None, span=None, rows=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32).

    jax's algorithm: two 32-bit draws from ``split(key)``, combined as
    ``(hi % span) * ((2^16 % span)^2 % span) + lo % span`` in wrapping
    uint32 arithmetic, then ``% span``.  A span of 0 or less gives
    ``minval``."""
    device = resolve_device(device)
    minval, maxval = int(minval), int(maxval)
    width = maxval - minval if maxval > minval else 1
    k1, k2 = split(key)
    hi = bits(k1, shape, device=device, span=span,
              rows=rows).to(torch.int64) & _M32
    lo = bits(k2, shape, device=device, span=span,
              rows=rows).to(torch.int64) & _M32
    mult = (((1 << 16) % width) ** 2 & _M32) % width
    off = (((hi % width) * mult) & _M32) + lo % width
    return ((off & _M32) % width + minval).to(torch.int32)


def permutation(key: Key, n: int, *, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int32) sorted by
    fresh 32-bit keys in ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each
    round's key split off the last.  The sort is stable, as jax's is, so
    tied keys keep their order."""
    device = resolve_device(device)
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    x = torch.arange(n, dtype=torch.int32, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = bits(sub, (n,), device=device).to(torch.int64) & _M32
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def normal(key: Key, shape: Shape, *, device=None, span=None,
           rows=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``:
    ``sqrt(2) * erfinv(uniform(key, shape, nextafter(-1, 0), 1))``.  The
    uniform draw is bitwise; torch's ``erfinv`` differs from XLA's
    ``erf_inv`` in the last bits."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device, span=span, rows=rows)
    # jax multiplies by sqrt(2) rounded to f32; torch would keep a Python
    # float's double value in the product
    return torch.erfinv(u) * float(torch.tensor(math.sqrt(2),
                                                dtype=torch.float32))


def bernoulli(key: Key, p: float, shape: Shape, *, device=None, span=None,
              rows=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in f32."""
    p32 = torch.tensor(p, dtype=torch.float32)
    return uniform(key, shape, device=device, span=span,
                   rows=rows) < p32.to(resolve_device(device))


def gumbel(key: Key, shape: Shape, *, device=None, span=None,
           rows=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``:
    ``-log(-log(uniform(key, shape, tiny, 1)))``."""
    tiny = float(torch.finfo(torch.float32).tiny)
    u = uniform(key, shape, tiny, 1.0, device=device, span=span, rows=rows)
    return -torch.log(-torch.log(u))


def categorical(key: Key, logits: torch.Tensor, shape: Shape, *,
                device=None, rows=None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` for 1-D
    ``logits`` (V,): the argmax over V of ``gumbel(key, shape + (V,)) +
    logits`` (int32, first index on ties).

    The (shape, V) gumbel draw is made in chunks of whole V-rows, so its
    memory stays near ``_CHUNK`` elements whatever the shape; ``rows``
    draws only rows ``r0 .. r1 - 1`` of ``shape``'s leading axis."""
    device = resolve_device(device)
    shape = _shape(shape)
    V = int(logits.shape[-1])
    full = shape + (V,)
    start, stop, _ = _span(full, None, rows)
    out_shape = shape if rows is None else (rows[1] - rows[0],) + shape[1:]
    lg = logits.to(device=device, dtype=torch.float32)
    per = max(1, _CHUNK // V)                 # V-rows per chunk
    n_rows = (stop - start) // V
    out = torch.empty(n_rows, dtype=torch.int32, device=device)
    for r0 in range(0, n_rows, per):
        r1 = min(n_rows, r0 + per)
        g = gumbel(key, full, device=device,
                   span=(start + r0 * V, start + r1 * V)).reshape(r1 - r0, V)
        out[r0:r1] = torch.argmax(g + lg, dim=-1).to(torch.int32)
    return out.reshape(out_shape)
