"""repro_torch.core vs repro.core on the same numpy inputs (CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agg import rounds as JR
from repro.agg.transport import frame as Jw
from repro.core import bucketing as JB
from repro.core import error_detect as JED
from repro.core import lattice as JL
from repro.core import rotation as JRot
from repro.dist.collectives import QSyncConfig as JQ
from repro_torch import convert
from repro_torch import random as TR
from repro_torch.agg import rounds as TRd
from repro_torch.core import bucketing as TB
from repro_torch.core import error_detect as TED
from repro_torch.core import lattice as TL
from repro_torch.core import rotation as TRot


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("q", [2, 4, 16, 256, 65536])
def test_encode_colors_pack_unpack_bitwise(q):
    rng = np.random.RandomState(q)
    n = 1001
    x = (rng.randn(n) * 3).astype(np.float32)
    u = (rng.rand(n) - 0.5).astype(np.float32)
    s = np.float32(0.37)
    k = np.asarray(JL.encode_coords(jnp.asarray(x), s, jnp.asarray(u)))
    kt = TL.encode_coords(_t(x), s, _t(u))
    np.testing.assert_array_equal(kt.numpy(), k)
    c = np.asarray(JL.color_of(jnp.asarray(k), q))
    ct = TL.color_of(kt, q)
    np.testing.assert_array_equal(ct.numpy().astype(np.uint32), c)
    bits = JL.bits_for_q(q)
    assert TL.bits_for_q(q) == bits
    w = np.asarray(JL.pack_colors(jnp.asarray(c), bits))
    wt = TL.pack_colors(ct, bits)
    np.testing.assert_array_equal(wt.numpy().view(np.uint32), w)
    assert wt.shape[0] == TL.packed_len(n, bits) == JL.packed_len(n, bits)
    np.testing.assert_array_equal(TL.unpack_colors(wt, n, bits).numpy(),
                                  np.asarray(JL.unpack_colors(
                                      jnp.asarray(w), n, bits)))
    a = (x + 0.1 * rng.randn(n)).astype(np.float32)
    dk = JL.decode_coords(jnp.asarray(c), jnp.asarray(a), s, jnp.asarray(u),
                          q=q)
    np.testing.assert_array_equal(
        TL.decode_coords(ct, _t(a), s, _t(u), q=q).numpy(), np.asarray(dk))
    d = rng.randint(-1000, 1000, n).astype(np.int32)
    np.testing.assert_array_equal(TL.centered_mod(_t(d), q).numpy(),
                                  np.asarray(JL.centered_mod(jnp.asarray(d),
                                                             q)))


@pytest.mark.parametrize("d", [1, 777, 4096])
def test_checksum_weights_and_coord_checksum_bitwise(d):
    key = jax.random.fold_in(jax.random.PRNGKey(9), 4)
    kt = TR.fold_in(TR.PRNGKey(9), 4)
    w = np.asarray(JED.checksum_weights(key, d))
    wt = TED.checksum_weights(kt, d, device="cpu")
    np.testing.assert_array_equal(wt.numpy().view(np.uint32), w)
    rng = np.random.RandomState(d)
    k = rng.randint(-(1 << 31), (1 << 31) - 1, (3, d)).astype(np.int32)
    want = np.asarray(JED.coord_checksum(jnp.asarray(k), jnp.asarray(w),
                                         axis=-1))
    np.testing.assert_array_equal(TED.coord_checksum(_t(k), wt, axis=-1)
                                  .numpy().astype(np.uint32), want)
    one = int(JED.coord_checksum(jnp.asarray(k[1]), jnp.asarray(w)))
    assert int(TED.coord_checksum(_t(k[1]), wt)) == one


def test_coord_checksum_chunked_matches_one_shot(monkeypatch):
    rng = np.random.RandomState(1)
    k = _t(rng.randint(-5000, 5000, (4, 3000)).astype(np.int32))
    w = TED.checksum_weights(TR.PRNGKey(2), 3000, device="cpu")
    whole = TED.coord_checksum(k, w, axis=-1)
    monkeypatch.setattr(TED, "_CHUNK_ELEMS", 100)
    np.testing.assert_array_equal(TED.coord_checksum(k, w, axis=-1).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("d,bucket", [(1000, 128), (4096, 512), (300, 256)])
def test_bucketize_unrotated_bitwise(d, bucket):
    x = np.random.RandomState(d).randn(d).astype(np.float32)
    want = np.asarray(JB.bucketize(jnp.asarray(x), bucket))
    got = TB.bucketize(_t(x), bucket)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TB.unbucketize(got, d).numpy(), x)


def test_bucketize_rotated():
    """The port's rotation against the reference's plain (jnp) rotation:
    both run the butterfly in the same stage order, so they agree bit for
    bit.  Against the reference's Pallas FWHT (matmul sums) the port is
    only allclose: see test_torch_kernels.py::test_fwht_allclose."""
    d, bucket = 1000, 128
    x = np.random.RandomState(d).randn(d).astype(np.float32)
    diag = JRot.rotation_keypair(jax.random.PRNGKey(20210507), bucket)
    diag_t = TRot.rotation_keypair(TR.PRNGKey(20210507), bucket,
                                   device="cpu")
    np.testing.assert_array_equal(diag_t.numpy(), np.asarray(diag))
    want = np.asarray(JB.bucketize(jnp.asarray(x), bucket, diag=diag,
                                   use_kernel=False))
    got = TB.bucketize(_t(x), bucket, diag=diag_t)
    np.testing.assert_array_equal(got.numpy(), want)
    back = TB.unbucketize(got, d, diag=diag_t)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JB.unbucketize(jnp.asarray(want), d,
                                                diag=diag, use_kernel=False)))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rotate,anchored", [(False, False), (True, True)])
def test_round_randomness_and_ref_coords_bitwise(rotate, anchored):
    d = 1500
    anchor = np.random.RandomState(3).randn(d).astype(np.float32)
    js = Jw.RoundSpec(round_id=5, d=d, cfg=JQ(q=16, bucket=256,
                                               rotate=rotate),
                      y0=0.5, seed=77,
                      anchor_digest=JR.anchor_digest(anchor) if anchored
                      else 0)
    ts = convert.round_spec(dataclasses.asdict(js))
    assert ts == dataclasses.replace(ts) and ts.padded == js.padded
    np.testing.assert_array_equal(TRd.dither(ts, "cpu").numpy(),
                                  np.asarray(JR.dither(js)))
    np.testing.assert_array_equal(
        TRd.checksum_weights(ts, "cpu").numpy().view(np.uint32),
        np.asarray(JR.checksum_weights(js)))
    np.testing.assert_array_equal(TRd.rotation_diag(ts, "cpu").numpy(),
                                  np.asarray(JR.rotation_diag(js)))
    np.testing.assert_array_equal(TRd.sides(ts, "cpu").numpy(),
                                  np.asarray(JR.sides(js)))
    ta = convert.tensor(anchor, device="cpu")
    assert TRd.anchor_digest(ta) == JR.anchor_digest(anchor)
    assert TRd.fold_seed(77, 5) == JR.fold_seed(77, 5)
    if not rotate:
        np.testing.assert_array_equal(
            TRd.decode_ref_coords(ts, ta, "cpu").numpy(),
            np.asarray(JR.decode_ref_coords(js, anchor)))


def test_qstate_update_y_bitwise():
    from repro.core import qstate as JQS
    from repro_torch.core import qstate as TQS

    rng = np.random.RandomState(11)
    nb = 64
    y = (0.1 + rng.rand(3, nb)).astype(np.float32)
    dist_b = (y * rng.choice([0.0, 1e-9, 0.05, 0.3, 0.9, 3.0], (3, nb))
              ).astype(np.float32)
    fails_b = rng.choice([0.0, 0.0, 1.0, 2.0], (3, nb)).astype(np.float32)
    for kw in ({}, dict(decay=0.9, escalate=3.0, margin=2.0, floor=1e-3)):
        want = np.asarray(JQS.update_y(jnp.asarray(y), jnp.asarray(fails_b),
                                       jnp.asarray(dist_b), **kw))
        got = TQS.update_y(_t(y), _t(fails_b), _t(dist_b), **kw)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    st = TQS.uniform(nb, 0.25)
    assert st.anchor is None
    np.testing.assert_array_equal(st.y.numpy(),
                                  np.asarray(JQS.uniform(nb, 0.25).y))
    assert TQS.as_qstate(st) is st
    promoted = TQS.as_qstate(_t(y[0]), anchor=_t(y[1]))
    np.testing.assert_array_equal(promoted.y.numpy(), y[0])
    qs = convert.qstate_from_numpy(y[0], y[1], device="cpu")
    assert qs.y.dtype == torch.float32 and qs.anchor.device.type == "cpu"
    np.testing.assert_array_equal(qs.anchor.numpy(), y[1])


def _round_f32(x):
    """The f32 nearest the exact rational ``x``, ties to even."""
    from fractions import Fraction
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.uint32)) & 1))


@pytest.mark.parametrize("case", ["ties", "far_apart"])
def test_fma_f32_rounds_once(case):
    """fma_f32 equals the exactly rounded a*b + c, and fma_f32_abs_amax
    its rows' largest magnitude.  "ties": the exact sum lies just short of
    an f32 tie, which a sum rounded to nearest in f64 would land on (and
    then round the wrong way); "far_apart": |c| is tens of times |a*b|, so
    the f64 sum is inexact."""
    from fractions import Fraction
    rng = np.random.RandomState(5)
    n = 256
    if case == "ties":
        # c has an odd last bit; a*b = ulp(c)/2 * (1 - 2^-2k) exactly
        c = (rng.randint(1 << 23, 1 << 24, n) | 1).astype(np.float32)
        c = (c * np.float32(2.0) ** rng.randint(-40, 0, n)).astype(np.float32)
        c *= rng.choice([-1, 1], n).astype(np.float32)
        k = rng.randint(15, 21, n)
        a = (1 + np.float32(2.0) ** -k).astype(np.float32)
        b = (np.spacing(np.abs(c)) / 2 * (1 - np.float32(2.0) ** -k)
             * np.sign(c)).astype(np.float32)
    else:
        a = (0.02 * rng.randn(n)).astype(np.float32)
        b = (0.5 + rng.rand(n)).astype(np.float32)
        c = rng.randn(n).astype(np.float32)
    got = TL.fma_f32(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    rows = TL.fma_f32_abs_amax(*(_t(v.reshape(16, 16)) for v in (a, b, c)))
    np.testing.assert_array_equal(
        rows.numpy(), np.abs(want).reshape(16, 16).max(axis=1))
    if case == "ties":
        twice = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (twice != want).all()
