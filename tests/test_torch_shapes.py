"""The shapes the reference's ``ops`` sends to its plain versions, which
the port's kernels take: the port's ops against the reference's on the
same numpy inputs (CPU).

* the lattice encode, single decode and batched decode at 1-bit colors
  (q = 1, 2), at q not a power of two (3, 5, 12, 1000, 65535) and at
  n < 32 or past whole runs, bitwise; a payload whose 2-bit fields all
  hold 3 at q = 3 (the decode masks the field, not q - 1);
* the FWHT at rows of 1, 2, 32,768 and 65,536, f32 and bf16, bitwise;
* attention at head dims past 256 against the reference's Pallas kernel
  in interpret mode, at the reference test's tolerances.

On the CPU the port runs its plain versions; ``tests/test_torch_cuda.py``
holds the CUDA kernels against the same plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro_torch.core import lattice as TL
from repro_torch.kernels import ops as TK

QS = (1, 2, 3, 5, 12, 1000, 65535)
NS = (1, 7, 31, 33, 4097)
BUCKET = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(n, q, seed):
    """x, dither, anchor, per-bucket sides of BUCKET coordinates and the
    same sides per coordinate (the reference takes no per-bucket form),
    with sides about 2 / (q - 1) of the spread, so that colors wrap."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 2).astype(np.float32)
    u = (rng.rand(n) - 0.5).astype(np.float32)
    a = (x + 0.3 * rng.randn(n)).astype(np.float32)
    nb = -(-n // BUCKET)
    sides = ((0.5 + rng.rand(nb)) * 4.0 / max(q - 1, 1)).astype(np.float32)
    return x, u, a, sides, np.repeat(sides, BUCKET)[:n]


def _words(shape_lead, n, q, seed):
    bits = TL.bits_for_q(q)
    return np.random.RandomState(seed).randint(
        0, 1 << 32, shape_lead + (TL.packed_len(n, bits),),
        dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("q", QS)
def test_lattice_encode_bitwise(q, n):
    """Words and coords, anchored and not, against the reference."""
    x, u, a, sides, per = _inputs(n, q, q + n)
    for anchor in (None, a):
        jw, jk = JK.lattice_encode(jnp.asarray(x), jnp.asarray(u),
                                   jnp.asarray(per), q=q, return_coords=True,
                                   anchor=None if anchor is None
                                   else jnp.asarray(anchor))
        tw, tk = TK.lattice_encode(_t(x), _t(u), _t(sides), q=q,
                                   return_coords=True, bucket=BUCKET,
                                   anchor=None if anchor is None
                                   else _t(anchor))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                      np.asarray(jw))


# every mode of the single decode; avg_cnt 1 and 3, whose 1 / (avg_cnt + 1)
# is exact in f32 (see test_lattice_decode_single_avg_cnt_rounding)
MODES = (("coords", False, None), ("coords", True, None),
         ("point", False, None), ("point", True, None), ("point", True, 3),
         ("point", False, 1))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("q", QS)
def test_lattice_decode_single_bitwise(q, n):
    """Coords and points, with ``ref`` and the running-average epilogue,
    against the reference's plain version (which the reference's ops runs
    at these shapes, op by op, so points are bitwise too)."""
    _, u, a, sides, per = _inputs(n, q, q + n + 1)
    words = _words((), n, q, q + n + 2)
    r = (0.5 * a).astype(np.float32)
    for mode, with_ref, avg in MODES:
        want = np.asarray(JK.lattice_decode(
            jnp.asarray(words), jnp.asarray(a), jnp.asarray(u),
            jnp.asarray(per), q=q, avg_cnt=avg, mode=mode,
            ref=jnp.asarray(r) if with_ref else None))
        got = TK.lattice_decode(_t(words.view(np.int32)), _t(a), _t(u),
                                _t(sides), q=q, avg_cnt=avg, mode=mode,
                                ref=_t(r) if with_ref else None,
                                bucket=BUCKET).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32),
                                      err_msg=f"{mode} ref={with_ref} "
                                      f"avg={avg}")


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("q", QS)
def test_lattice_decode_batched_bitwise(q, n):
    """Coords, and points with ``ref``, of 3 senders with per-sender sides,
    against the reference."""
    S = 3
    _, u, a, sides, per = _inputs(n, q, q + n + 3)
    scale = (1 + 0.1 * np.arange(S, dtype=np.float32))[:, None]
    sides_s = (sides[None] * scale).astype(np.float32)
    per_s = (per[None] * scale).astype(np.float32)
    words = _words((S,), n, q, q + n + 4)
    r = (0.25 * a).astype(np.float32)
    for mode, with_ref in (("coords", False), ("point", True)):
        want = np.asarray(JK.lattice_decode_batched(
            jnp.asarray(words), jnp.asarray(a), jnp.asarray(u),
            jnp.asarray(per_s), q=q, mode=mode,
            ref=jnp.asarray(r) if with_ref else None))
        got = TK.lattice_decode_batched(
            _t(words.view(np.int32)), _t(a), _t(u), _t(sides_s), q=q,
            mode=mode, ref=_t(r) if with_ref else None,
            bucket=BUCKET).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=mode)


@pytest.mark.parametrize("batched", [False, True])
def test_field_holding_three_at_q3(batched):
    """At q = 3 a 2-bit field can hold 3, which no encode writes (a
    corrupted payload can).  The reference unpacks by the field's width
    and folds 3 by the centered mod, so a payload of 3s decodes as one of
    0s; a mask by q - 1 = 2 would read 2."""
    n, q = 4097, 3
    _, u, a, _, per = _inputs(n, q, 3)
    threes = np.full((2, TL.packed_len(n, 2)), 0xFFFFFFFF, np.uint32)

    def decode(w, ops, conv):
        if batched:
            return np.asarray(ops.lattice_decode_batched(
                conv(w), conv(a), conv(u), conv(per), q=q))
        return np.asarray(ops.lattice_decode(conv(w[0]), conv(a), conv(u),
                                             conv(per), q=q, mode="coords"))
    want = decode(threes, JK, jnp.asarray)
    got = decode(threes.view(np.int32), TK, _t)
    np.testing.assert_array_equal(got, want)
    zeros = decode(np.zeros_like(threes).view(np.int32), TK, _t)
    np.testing.assert_array_equal(got, zeros)


def test_lattice_decode_single_avg_cnt_rounding():
    """The running-average epilogue multiplies by f32(1 / (avg_cnt + 1)),
    as the reference's Pallas kernel does; the reference's plain version,
    which its ops runs at the shapes here, divides.  The two agree bitwise
    where 1 / (avg_cnt + 1) is exact (avg_cnt 1, 3, 7) and within one f32
    step elsewhere."""
    n, q = 4097, 12
    _, u, a, sides, per = _inputs(n, q, 5)
    words = _words((), n, q, 6)
    for avg, exact in ((1, True), (2, False), (3, True), (6, False),
                       (7, True)):
        want = np.asarray(JK.lattice_decode(
            jnp.asarray(words), jnp.asarray(a), jnp.asarray(u),
            jnp.asarray(per), q=q, avg_cnt=avg))
        got = TK.lattice_decode(_t(words.view(np.int32)), _t(a), _t(u),
                                _t(sides), q=q, avg_cnt=avg,
                                bucket=BUCKET).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,rows", [(1, 5), (2, 5), (32768, 3), (65536, 2)])
def test_fwht_bitwise(d, rows, dtype):
    """Rows the reference's kernel does not take (d < 4, d > 16,384), which
    its ops sends to ``fwht_jnp``: the port's plain transform runs the same
    stages in the same order, so the bits agree."""
    x = np.random.RandomState(d + rows).randn(rows, d).astype(np.float32)
    want = JK.fwht(jnp.asarray(x).astype(dtype))
    got = TK.fwht(_t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [320, 512])
def test_flash_attention_past_head_dim_256(d, causal, dtype):
    """Head dims past 256 (the port's wide kernels on the card) against the
    reference's Pallas kernel in interpret mode, at 256 x 256, at the
    reference test's tolerances: 2e-4 for f32, 3e-2 for bf16 (rounded to
    the output type separately on each side)."""
    rng = np.random.RandomState(d)
    q, k, v = (rng.randn(2, 256, d).astype(np.float32) for _ in range(3))
    tol = 2e-4 if dtype == "float32" else 3e-2
    want = JK.flash_attention(*(jnp.asarray(a).astype(dtype)
                                for a in (q, k, v)), causal=causal)
    got = TK.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                               for a in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
