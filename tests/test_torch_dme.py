"""The port's paper algorithms vs the JAX package's, on the same inputs.

Compressors, Algorithms 3/4/5, the butterfly, variance reduction, the §5
detecting encoder, the sublinear scheme and the samplers they draw from.
Inputs are numpy arrays made from a seed and handed to both packages; keys
are the same integer seeds on both sides (``repro_torch.random`` is
bit-exact with ``jax.random``).  Everything is bitwise except where a float
reduction or torch's ``erfinv`` enters; each such test states its
tolerance and why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as JC
from repro.core import dme as JD
from repro.core import error_detect as JE
from repro.core import lattice as JL
from repro.core import rotation as JR
from repro.core import sublinear as JS
from repro_torch import random as TR
from repro_torch.core import compressors as TC
from repro_torch.core import dme as TD
from repro_torch.core import error_detect as TE
from repro_torch.core import lattice as TL
from repro_torch.core import rotation as TRo
from repro_torch.core import sublinear as TS

D = 512


def _bits(a) -> np.ndarray:
    """Raw bits of a float32 array (jax or torch), for bitwise compares."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32).view(np.uint32)


def _vec(seed, d=D, scale=1.0):
    return (np.random.RandomState(seed).randn(d) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 20210507])
def test_randint_and_permutation_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), TR.PRNGKey(seed)
    for n in (1, 2, 5, 8, 1000, 1700):       # 1700 takes two shuffle rounds
        assert int(jax.random.randint(jk, (), 0, n)) == \
            int(TR.randint(tk, (), 0, n, device="cpu"))
        np.testing.assert_array_equal(
            TR.permutation(tk, n, device="cpu").numpy(),
            np.asarray(jax.random.permutation(jk, n)))
    for lo, hi in ((0, 100000), (-5, 2 ** 31 - 1), (3, 3)):
        np.testing.assert_array_equal(
            TR.randint(tk, (3, 100), lo, hi, device="cpu").numpy(),
            np.asarray(jax.random.randint(jk, (3, 100), lo, hi)))


def test_normal_allclose():
    """The uniform draw under it is bitwise; torch's erfinv differs from
    XLA's in the last bits (up to about 6e-6 relative), so rtol = 1e-5,
    atol = 1e-6."""
    for seed in (0, 3):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            (64, 4)))
        got = TR.normal(TR.PRNGKey(seed), (64, 4), device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# lattice one-call API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stochastic", "dither", "nearest"])
def test_lattice_encode_decode_bitwise(mode):
    x, a = _vec(1, scale=3.0), _vec(1, scale=3.0) + _vec(2, scale=0.2)
    spec_j, spec_t = JL.LatticeSpec(16), TL.LatticeSpec(16)
    key = 5 if mode == "stochastic" else None
    u = (np.random.RandomState(3).rand(D) - 0.5).astype(np.float32) \
        if mode == "dither" else None
    jc, js = JL.lattice_encode(jnp.asarray(x), 1.0, spec_j,
                               key=None if key is None else
                               jax.random.PRNGKey(key),
                               u=None if u is None else jnp.asarray(u))
    tc, ts = TL.lattice_encode(torch.from_numpy(x), 1.0, spec_t,
                               key=None if key is None else TR.PRNGKey(key),
                               u=None if u is None else torch.from_numpy(u))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert _bits(ts) == _bits(js)
    jz = JL.lattice_decode(jc, jnp.asarray(a), 1.0, spec_j,
                           u=None if u is None else jnp.asarray(u))
    tz = TL.lattice_decode(tc, torch.from_numpy(a), 1.0, spec_t,
                           u=None if u is None else torch.from_numpy(u))
    np.testing.assert_array_equal(_bits(tz), _bits(jz))
    for far in (0.0, 40.0):
        b = a + far
        assert bool(TL.decode_failure(tz, torch.from_numpy(b), 1.0)) == \
            bool(JL.decode_failure(jz, jnp.asarray(b), 1.0))


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------

# compressors whose output passes through a float reduction (or, for
# powersgd, torch's erfinv and a QR): (rtol, atol) and why
_TOL = {
    "qsgd_l2": (1e-5, 1e-6),     # the l2 norm: a float sum in another order
    "efsign": (1e-5, 1e-6),      # mean(|x|): likewise
    "powersgd": (1e-4, 1e-5),    # normal draws to ~6e-6, then QR
}


@pytest.mark.parametrize("name", JC.ALL_COMPRESSORS)
def test_compressor_roundtrip_and_wire_bytes(name):
    """Every compressor's decoded vector against the reference's, with a
    key (stochastic rounding) and an anchor near x, plus its wire bytes;
    the lattice family's packed words bitwise too."""
    x = _vec(1)
    a = x + _vec(2, scale=0.1)
    jdiag = JR.rotation_keypair(jax.random.PRNGKey(0), D)
    tdiag = TRo.rotation_keypair(TR.PRNGKey(0), D, device="cpu")
    jc, tc = JC.make_compressor(name), TC.make_compressor(name)
    jctx = JC.CompressorCtx(y=1.0, diag=jdiag)
    tctx = TC.CompressorCtx(y=1.0, diag=tdiag)
    want = jc.roundtrip(jnp.asarray(x), jctx, jax.random.PRNGKey(2),
                        anchor=jnp.asarray(a))
    got = tc.roundtrip(torch.from_numpy(x), tctx, TR.PRNGKey(2),
                       anchor=torch.from_numpy(a))
    assert tuple(got.shape) == (D,) and got.dtype == torch.float32
    if name in _TOL:
        rtol, atol = _TOL[name]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert tc.wire_bytes(D) == jc.wire_bytes(D)
    assert tc.wire_bytes(1000) == jc.wire_bytes(1000)
    if name in ("lq", "rlq"):
        jw = jc.encode(jnp.asarray(x), jctx, jax.random.PRNGKey(3))
        tw = tc.encode(torch.from_numpy(x), tctx, TR.PRNGKey(3))
        np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                      np.asarray(jw))


def test_ef_roundtrip_carries_the_same_residual():
    """Three error-feedback steps of EFSign; its scale is mean(|x|), a
    float sum in another order, so rtol = 1e-5, atol = 1e-6."""
    x = _vec(4, scale=0.1)
    jerr, terr = jnp.zeros(D), torch.zeros(D)
    jctx, tctx = JC.CompressorCtx(), TC.CompressorCtx()
    for _ in range(3):
        jxh, jerr = JC.ef_roundtrip(JC.EFSign(), jnp.asarray(x), jerr, jctx)
        txh, terr = TC.ef_roundtrip(TC.EFSign(), torch.from_numpy(x), terr,
                                    tctx)
        np.testing.assert_allclose(txh.numpy(), np.asarray(jxh),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(terr.numpy(), np.asarray(jerr),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# DME: Algorithms 3 and 4, the butterfly, variance reduction
# ---------------------------------------------------------------------------

def _dme_inputs(n=8, d=D):
    """bench_dme's regime: a large-norm mean, spread 0.05."""
    rng = np.random.RandomState(0)
    mu = rng.randn(d) * 100
    xs = (mu + 0.05 * rng.randn(n, d)).astype(np.float32)
    y = float(2 * np.abs(xs - xs.mean(0)).max())
    return xs, y


_DME = {
    "star": (lambda M, C, xs, y, key: M.mean_estimation_star(
        xs, y, C.LatticeQ(q=16), key, C.CompressorCtx(y=y))),
    "star_leader3_q4": (lambda M, C, xs, y, key: M.mean_estimation_star(
        xs, y, C.LatticeQ(q=4), key, C.CompressorCtx(y=y), leader=3)),
    "tree": (lambda M, C, xs, y, key: M.mean_estimation_tree(
        xs, y, m=8, key=key)),
    "tree_m4": (lambda M, C, xs, y, key: M.mean_estimation_tree(
        xs, y, m=4, key=key)),
    "butterfly": (lambda M, C, xs, y, key: M.butterfly_mean(
        xs, y, C.LatticeQ(q=16), key, C.CompressorCtx(y=y))),
    "vr_star": (lambda M, C, xs, y, key: M.variance_reduction(
        xs, 0.05, C.LatticeQ(q=64), key, alpha=4.0)),
    "vr_tree": (lambda M, C, xs, y, key: M.variance_reduction(
        xs, 0.05, C.LatticeQ(q=64), key, alpha=4.0, topology="tree")),
}


@pytest.mark.parametrize("case", list(_DME))
def test_dme_bitwise(case):
    """Outputs, bits per machine and decode_ok.  The mean over machines is
    a sum in row order and one division in the port, the order in which
    XLA's CPU reduce adds the rows here, so the outputs are bitwise too."""
    xs, y = _dme_inputs()
    fn = _DME[case]
    want = fn(JD, JC, jnp.asarray(xs), y, jax.random.PRNGKey(2))
    got = fn(TD, TC, torch.from_numpy(xs), y, TR.PRNGKey(2))
    assert tuple(got.est.shape) == xs.shape
    np.testing.assert_array_equal(_bits(got.est), _bits(want.est))
    # int64 in the port: the reference's int32 wraps past 2^31 bits
    assert got.bits_per_machine.dtype == torch.int64
    np.testing.assert_array_equal(got.bits_per_machine.numpy(),
                                  np.asarray(want.bits_per_machine))
    assert bool(got.decode_ok) == bool(want.decode_ok)


def test_butterfly_rejects_non_power_of_two():
    xs, y = _dme_inputs(n=6)
    with pytest.raises(ValueError, match="power-of-two"):
        TD.butterfly_mean(torch.from_numpy(xs), y, TC.LatticeQ(), TR.PRNGKey(0))


# ---------------------------------------------------------------------------
# §5 error detection and Algorithm 5
# ---------------------------------------------------------------------------

def test_detecting_encoder_bitwise():
    d, q, y = 128, 8, 1.0
    x = _vec(5, d, scale=5.0)
    jw = JE.checksum_weights(jax.random.PRNGKey(0), d)
    tw = TE.checksum_weights(TR.PRNGKey(0), d, device="cpu")
    jenc, tenc = JE.DetectingEncoder(q=q), TE.DetectingEncoder(q=q)
    jp = jenc.encode(jnp.asarray(x), y, jw, key=jax.random.PRNGKey(1))
    tp = tenc.encode(torch.from_numpy(x), y, tw, key=TR.PRNGKey(1))
    np.testing.assert_array_equal(tp["words"].numpy().view(np.uint32),
                                  np.asarray(jp["words"]))
    assert int(tp["check"]) == int(jp["check"])
    for shift in (0.1, 50.0):                 # near: ok; far: flagged
        jz, jok = jenc.decode(jp, jnp.asarray(x + shift * y), y, jw)
        tz, tok = tenc.decode(tp, torch.from_numpy(x + shift * y), y, tw)
        np.testing.assert_array_equal(_bits(tz), _bits(jz))
        assert bool(tok) == bool(jok) == (shift < 1)
    assert tenc.wire_bits(d) == jenc.wire_bits(d)


@pytest.mark.parametrize("under", [1, 10, 100])
def test_robust_agreement_same_escalation(under):
    """Alg. 5 with y0 the true bound divided by ``under``: the port
    escalates through the same q's, so iters, bits, ok and z are equal."""
    d = 64
    xu = _vec(6, d, scale=10.0)
    xv = (xu + _vec(7, d, scale=0.5)).astype(np.float32)
    y0 = float(2 * np.abs(xu - xv).max()) / under
    want = JE.robust_agreement(jnp.asarray(xu), jnp.asarray(xv), y0, 16,
                               jax.random.PRNGKey(6))
    got = TE.robust_agreement(torch.from_numpy(xu), torch.from_numpy(xv), y0,
                              16, TR.PRNGKey(6))
    assert (got["iters"], got["bits"], got["ok"]) == \
        (want["iters"], want["bits"], want["ok"])
    assert got["ok"] and (got["iters"] > 1) == (under > 1)
    np.testing.assert_array_equal(_bits(got["z"]), _bits(want["z"]))


# ---------------------------------------------------------------------------
# §7 sublinear (numpy on the host in both packages)
# ---------------------------------------------------------------------------

def test_sublinear_same_draws_same_results():
    jsub = JS.SublinearLattice(s=0.5, q=1.5, d=4)
    tsub = TS.SublinearLattice(s=0.5, q=1.5, d=4)
    assert (tsub.eps, tsub.n_colors, tsub.bits()) == \
        (jsub.eps, jsub.n_colors, jsub.bits())
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(5):
        x = jr.normal(size=4) * 5
        np.testing.assert_array_equal(tr.normal(size=4) * 5, x)
        jp, tp = jsub.encode(x, jr), tsub.encode(x, tr)
        assert (tp["color"], tp["iter"], tp["seed"]) == \
            (jp["color"], jp["iter"], jp["seed"])
        np.testing.assert_array_equal(tsub.decode(tp, x + 0.01),
                                      jsub.decode(jp, x + 0.01))
    for bits in (0.5, 1.0, 2.0):
        assert TS.simulated_variance(256, 1.0, bits) == \
            JS.simulated_variance(256, 1.0, bits)
    assert TS.vqsgd_cross_polytope_variance(256, 1.0, 8) == \
        JS.vqsgd_cross_polytope_variance(256, 1.0, 8)
