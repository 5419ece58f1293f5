"""repro_torch.kernels.ops vs repro.kernels.ops on the same numpy inputs.

On the CPU the port's ops run their plain torch versions; the reference's
ops run their Pallas kernels in interpret mode.  The CUDA kernels are held
against the plain versions on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro_torch.core import lattice as TL
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TK


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _enc_inputs(n, bucket, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 2).astype(np.float32)
    u = (rng.rand(n) - 0.5).astype(np.float32)
    a = (x + 0.3 * rng.randn(n)).astype(np.float32)
    nb = -(-n // bucket)
    sides = (0.05 + 0.2 * rng.rand(nb)).astype(np.float32)
    return x, u, a, sides


def _side_forms(kind, sides, n, bucket):
    """(reference s, port s, port bucket) for one way of passing sides."""
    if kind == "scalar":
        return np.float32(sides[0]), float(sides[0]), None
    per = np.repeat(sides, bucket)[:n]
    if kind == "coord":
        return jnp.asarray(per), _t(per), None
    return jnp.asarray(per), _t(sides), bucket        # per-bucket


# n past whole runs of 4 words, where the CUDA kernels take their guarded
# tail (a run is 32, 64, 16 or 8 coordinates at 4, 2, 8 or 16 bits)
TAIL_N = (33, 4095, 4097)


def _cases(base, tails):
    """Parametrize cases: ``base`` at n = 1000 under their own ids, then
    ``tails`` at every n of TAIL_N, with ``-n<N>`` in their ids."""
    cases = [pytest.param(*c, 1000, id="-".join(map(str, c))) for c in base]
    return cases + [pytest.param(*c, n, id="-".join(map(str, (*c, f"n{n}"))))
                    for n in TAIL_N for c in tails]


@pytest.mark.parametrize("q", [4, 16, 256])
@pytest.mark.parametrize("kind,anchored,n", _cases(
    [("scalar", False), ("coord", True), ("bucket", True), ("bucket", False)],
    [("bucket", True), ("scalar", False)]))
def test_lattice_encode_bitwise(q, kind, anchored, n):
    bucket = 128
    x, u, a, sides = _enc_inputs(n, bucket, q)
    js, ts, tb = _side_forms(kind, sides, n, bucket)
    jw, jk = JK.lattice_encode(jnp.asarray(x), jnp.asarray(u), js, q=q,
                               return_coords=True,
                               anchor=jnp.asarray(a) if anchored else None)
    tw, tk = TK.lattice_encode(_t(x), _t(u), ts, q=q, return_coords=True,
                               anchor=_t(a) if anchored else None, bucket=tb)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    tw_only = TK.lattice_encode(_t(x), _t(u), ts, q=q, bucket=tb,
                                anchor=_t(a) if anchored else None)
    np.testing.assert_array_equal(tw_only.numpy(), tw.numpy())


def _dec_inputs(S, n, bucket, q, seed):
    rng = np.random.RandomState(seed)
    x, u, a, sides = _enc_inputs(n, bucket, seed)
    nb = sides.shape[0]
    sides_s = np.tile(sides, (S, 1)) * (1 + 0.1 * rng.rand(S, 1))
    sides_s = sides_s.astype(np.float32)
    bits = TL.bits_for_q(q)
    words = rng.randint(0, 1 << 32, (S, TL.packed_len(n, bits)),
                        dtype=np.uint64).astype(np.uint32)
    return words, a, u, sides_s, nb


@pytest.mark.parametrize("q", [4, 16, 256])
@pytest.mark.parametrize("mode", ["coords", "point"])
def test_lattice_decode_batched(q, mode):
    S, n, bucket = 5, 1000, 128
    words, a, u, sides_s, _ = _dec_inputs(S, n, bucket, q, q + 1)
    per_coord = np.repeat(sides_s, bucket, axis=1)[:, :n]
    ref = (0.5 * a).astype(np.float32)
    want = np.asarray(JK.lattice_decode_batched(
        jnp.asarray(words), jnp.asarray(a), jnp.asarray(u),
        jnp.asarray(per_coord), q=q, mode=mode,
        ref=jnp.asarray(ref) if mode == "point" else None))
    TK.reset_dispatch_counts()
    got = TK.lattice_decode_batched(
        _t(words.view(np.int32)), _t(a), _t(u), _t(sides_s), q=q, mode=mode,
        ref=_t(ref) if mode == "point" else None, bucket=bucket)
    assert TK.DISPATCH_COUNTS["lattice_decode_batched"] == 1
    assert TK.DISPATCH_COUNTS["lattice_decode"] == 0
    if mode == "coords":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_residuals_and_pack_coords_bitwise():
    q, n = 16, 1000
    rng = np.random.RandomState(4)
    words = rng.randint(0, 1 << 32, (3, TL.packed_len(n, 4)),
                        dtype=np.uint64).astype(np.uint32)
    k0 = rng.randint(-100, 100, n).astype(np.int32)
    want = np.asarray(JK.lattice_residuals(jnp.asarray(words),
                                           jnp.asarray(k0), q=q))
    got = TK.lattice_residuals(_t(words.view(np.int32)), _t(k0), q=q)
    np.testing.assert_array_equal(got.numpy(), want)
    part = TK.lattice_residuals_range(_t(words[0, 10:20].view(np.int32)),
                                      _t(k0), q=q, word_start=10)
    np.testing.assert_array_equal(part.numpy(), want[0, 80:160])
    k = rng.randint(-500, 500, (2, n)).astype(np.int32)
    np.testing.assert_array_equal(
        TK.lattice_pack_coords(_t(k), q=q).numpy().view(np.uint32),
        np.asarray(JK.lattice_pack_coords(jnp.asarray(k), q=q)))


@pytest.mark.parametrize("d,rows", [(4, 3), (512, 8), (4096, 2)])
def test_fwht_allclose(d, rows):
    x = np.random.RandomState(d + rows).randn(rows, d).astype(np.float32)
    want = np.asarray(JK.fwht(jnp.asarray(x)))
    got = TK.fwht(_t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_fwht_bf16():
    x = np.random.RandomState(0).randn(4, 1024).astype(np.float32)
    want = np.asarray(JK.fwht(jnp.asarray(x).astype(jnp.bfloat16)),
                      np.float32)
    got = TK.fwht(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_side_layout_rejects_mismatched_shapes():
    dev = torch.device("cpu")
    with pytest.raises(ValueError):
        _build.side_layout(torch.ones(7), 1000, dev, bucket=128)
    with pytest.raises(ValueError):
        _build.side_layout(torch.ones(3, 8), 1000, dev, bucket=128)
    s, row, shift = _build.side_layout(torch.ones(3, 8), 1000, dev,
                                       bucket=128, senders=3)
    assert (row, shift) == (8, 7)
    assert _build.side_layout(0.5, 1000, dev)[1:] == (0, 63)


def test_kernel_wrappers_reject_what_no_kernel_takes():
    """The CUDA wrappers refuse bad arguments before any launch (these
    checks run the same with or without a card): only what the reference
    refuses too (q outside [1, 65536], no coordinates, an FWHT row that is
    not a power of two) and what no kernel takes (a dtype, a shape that
    does not fit)."""
    from repro_torch.kernels.fwht import fwht_cuda
    from repro_torch.kernels.lattice_decode import lattice_decode_batched_cuda
    from repro_torch.kernels.lattice_encode import lattice_encode_cuda

    x = torch.zeros(64)
    for q in (65537, 0):
        with pytest.raises(ValueError, match="q must be in"):
            lattice_encode_cuda(x, x, 0.5, q=q)
        with pytest.raises(ValueError, match="q must be in"):
            lattice_decode_batched_cuda(torch.zeros((2, 8),
                                                    dtype=torch.int32),
                                        x, x, 0.5, q=q)
    with pytest.raises(ValueError, match="cannot hold"):
        lattice_decode_batched_cuda(torch.zeros((2, 7), dtype=torch.int32),
                                    x, x, 0.5, q=16)
    with pytest.raises(ValueError, match="cannot hold"):     # 1-bit colors
        lattice_decode_batched_cuda(torch.zeros((2, 1), dtype=torch.int32),
                                    x, x, 0.5, q=2)
    with pytest.raises(ValueError, match="mode"):
        lattice_decode_batched_cuda(torch.zeros((2, 8), dtype=torch.int32),
                                    x, x, 0.5, q=16, mode="points")
    with pytest.raises(ValueError, match="n >= 1"):
        lattice_encode_cuda(x[:0], x[:0], 0.5, q=12)
    with pytest.raises(ValueError, match="n >= 1"):
        lattice_decode_batched_cuda(torch.zeros((2, 4), dtype=torch.int32),
                                    x[:0], x[:0], 0.5, q=3)
    for d in (12, 3, 32767):
        with pytest.raises(ValueError, match="power of two"):
            fwht_cuda(torch.zeros((2, d)))
    with pytest.raises(ValueError, match="f32 or bf16"):
        fwht_cuda(torch.zeros((2, 16), dtype=torch.float64))
    with pytest.raises(ValueError, match="f32 or bf16"):
        fwht_cuda(torch.zeros((2, 65536), dtype=torch.float64))


@pytest.mark.parametrize("q", [4, 16, 256])
@pytest.mark.parametrize("kind,n", _cases(
    [("scalar",), ("coord",), ("bucket",)], [("bucket",), ("coord",)]))
def test_lattice_decode_single(q, kind, n):
    """The single-payload decode against the reference's (its Pallas
    kernel in interpret mode): coords bitwise; points, with ``ref`` and the
    running-average epilogue, within 2 ulp of the largest term summed,
    because the reference's compiled kernel may fuse ``(k+u)*s + ref`` and
    ``z + anchor*avg_cnt`` into fused multiply-adds where the port rounds
    each step (the CUDA kernel rounds as the plain version does).  The n
    past whole runs (``TAIL_N``) are those at which the CUDA kernel takes
    its guarded tail."""
    bucket = 128
    x, u, a, sides = _enc_inputs(n, bucket, q + 3)
    js, ts, tb = _side_forms(kind, sides, n, bucket)
    bits = TL.bits_for_q(q)
    words = np.random.RandomState(q).randint(
        0, 1 << 32, TL.packed_len(n, bits), dtype=np.uint64).astype(np.uint32)
    ref = (0.5 * x).astype(np.float32)
    tw = _t(words.view(np.int32))
    for mode, r, avg in (("coords", None, None), ("coords", ref, None),
                         ("point", None, None), ("point", ref, None),
                         ("point", ref, 3), ("point", None, 1)):
        want = np.asarray(JK.lattice_decode(
            jnp.asarray(words), jnp.asarray(a), jnp.asarray(u), js, q=q,
            avg_cnt=avg, mode=mode,
            ref=None if r is None else jnp.asarray(r)))
        TK.reset_dispatch_counts()
        got = TK.lattice_decode(tw, _t(a), _t(u), ts, q=q, avg_cnt=avg,
                                mode=mode, ref=None if r is None else _t(r),
                                bucket=tb).numpy()
        assert TK.DISPATCH_COUNTS["lattice_decode"] == 1
        assert TK.DISPATCH_COUNTS["lattice_decode_batched"] == 0
        if mode == "coords":
            np.testing.assert_array_equal(got, want)
        else:
            # 2 ulp of the largest intermediate, (k+u)*s or its sum with
            # ref or anchor*avg_cnt, scaled by the epilogue's 1/(avg_cnt+1)
            k = TK.lattice_decode(tw, _t(a), _t(u), ts, q=q, mode="coords",
                                  ref=None if r is None else _t(r),
                                  bucket=tb).numpy()
            z = (k + u.astype(np.float64)) * np.broadcast_to(
                np.asarray(js, np.float64), (n,))
            zr = z + (0.0 if r is None else r)
            big = np.maximum.reduce([np.abs(z), np.abs(zr),
                                     np.abs(a) * (avg or 0)])
            tol = 2 * np.spacing(big.astype(np.float32)) / ((avg or 0) + 1)
            assert np.all(np.abs(got - want) <= tol), (mode, avg)


def test_lattice_decode_single_rejects_what_no_kernel_takes():
    from repro_torch.kernels.lattice_decode import lattice_decode_cuda
    from repro_torch.kernels import ref as TRef

    x = torch.zeros(64)
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="q must be in"):
        lattice_decode_cuda(w, x, x, 0.5, q=65537)
    with pytest.raises(ValueError, match="n >= 1"):
        lattice_decode_cuda(w, x[:0], x[:0], 0.5, q=16)
    with pytest.raises(ValueError, match="cannot hold"):
        lattice_decode_cuda(w[:7], x, x, 0.5, q=16)
    with pytest.raises(ValueError, match="cannot hold"):     # q = 12: 4 bits
        lattice_decode_cuda(w[:7], x, x, 0.5, q=12)
    with pytest.raises(ValueError, match="one payload"):
        lattice_decode_cuda(torch.zeros((2, 8), dtype=torch.int32), x, x,
                            0.5, q=16)
    with pytest.raises(ValueError, match="mode"):
        lattice_decode_cuda(w, x, x, 0.5, q=16, mode="points")
    for fn in (lattice_decode_cuda, TK.lattice_decode):
        with pytest.raises(ValueError, match="avg_cnt"):
            fn(w, x, x, 0.5, q=16, mode="coords", avg_cnt=2)
    with pytest.raises(ValueError, match="avg_cnt"):
        TRef.lattice_decode_ref(w, x, x, 0.5, q=16, bits=4, n=64,
                                mode="coords", avg_cnt=2)
