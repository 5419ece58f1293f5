"""repro_torch's flash attention vs repro's, on the same numpy inputs.

On the CPU the port's ``ops.flash_attention`` runs its plain version
(``kernels.ref.flash_attention_ref``); the reference's runs its Pallas
kernel in interpret mode, as ``tests/test_flash_attention.py`` runs it.
The CUDA kernel is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro.kernels import ref as JRef
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TRef


def _qkv(bh, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32))


# the reference test's shapes; causal only where Sq == Sk (positions count
# from 0 for both)
@pytest.mark.parametrize("sq,sk,causal", [(256, 256, True), (256, 256, False),
                                          (512, 512, True), (512, 512, False),
                                          (256, 1024, False)])
def test_flash_attention_matches_reference_f32(sq, sk, causal):
    """Online softmax (the reference's kernel) against the port's plain
    softmax: both f32 inside, sums in another order, so rtol = atol =
    2e-4, the reference test's tolerance."""
    q, k, v = _qkv(3, sq, sk, 64)
    want = JK.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    got = TK.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_matches_reference_bf16():
    """bf16 in and out (the same bf16 values on both sides: numpy f32
    rounded to nearest even), f32 inside; the outputs round to bf16
    separately, so rtol = atol = 3e-2 as in the reference test."""
    q, k, v = _qkv(2, 512, 512, 128, seed=1)
    want = JK.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (q, k, v)))
    got = TK.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                               for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("dtype,causal", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True)])
def test_flash_attention_matches_reference_d192(dtype, causal):
    """Head dim 192 (nemotron-4-340b's), which both CUDA kernels now take:
    256 x 256 against the reference's Pallas kernel, at the reference
    test's tolerances, 2e-4 for f32 and 3e-2 for bf16 (rounded to bf16
    separately on each side)."""
    q, k, v = _qkv(2, 256, 256, 192, seed=3)
    tol = 2e-4 if dtype == "float32" else 3e-2
    want = JK.flash_attention(*(jnp.asarray(a).astype(dtype)
                                for a in (q, k, v)), causal=causal)
    got = TK.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                               for a in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("sq,sk,causal", [(256, 256, True), (300, 300, True),
                                          (64, 200, False)])
def test_plain_versions_agree(sq, sk, causal):
    """The two plain softmax versions: the same formula, with f32 matmul
    and softmax sums in each library's own order, so rtol = atol = 1e-5.
    (300, 300) is a shape the reference's ``ops`` routes to its plain
    version, as the port's does on the CPU."""
    q, k, v = _qkv(2, sq, sk, 64, seed=2)
    want = JRef.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = TRef.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        TK.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal).numpy(),
        got.numpy())


# the head dims the kernels run padded (16: every smoke config's; 48: none
# built), the widest built one (recurrentgemma-9b's), and f16 at each and
# at 64
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d,causal", [(16, True), (16, False), (48, True),
                                      (64, True), (256, True), (256, False)])
def test_flash_attention_matches_reference_head_dims(d, causal, dtype):
    """Head dims 16, 48, 64 and 256 against the reference's Pallas kernel
    (it takes any D and any float type, f32 inside) at 256 x 256, at the
    reference test's tolerances: 2e-4 for f32, 3e-2 for bf16 and f16
    (rounded to the output type separately on each side)."""
    q, k, v = _qkv(2, 256, 256, d, seed=d)
    tol = 2e-4 if dtype == "float32" else 3e-2
    want = JK.flash_attention(*(jnp.asarray(a).astype(dtype)
                                for a in (q, k, v)), causal=causal)
    got = TK.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                               for a in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10 mantissa bits with ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: half the weight of the 13 dropped bits
    added to the magnitude's bits, then those bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 kernel takes it on the tensor cores: each operand
    split into hi = tf32(x) and lo = tf32(x - hi), and a_lo.b_hi +
    a_hi.b_lo + a_hi.b_hi summed in f32 (a product of two TF32 values is
    exact in f32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("d", [64, 256])
def test_three_tf32_products_hold_the_f32_tolerance(d):
    """The f32 kernel's numerics below head dim 512, emulated in torch: the
    scores and P.V as three TF32 products each (``_mm_3xtf32``), the
    softmax in f32 with base-2 exponentials of scores scaled by the
    wrapper's scale_log2 after the product, out = acc / max(l, 1e-30).
    Causal, Sq = Sk = 4,096 (long rows, where the products' errors add
    up), against the reference's Pallas kernel in interpret mode at the
    reference test's f32 tolerance, rtol = atol = 2e-4.  One TF32 pass (hi
    alone) misses it."""
    import math
    q, k, v = _qkv(2, 4096, 4096, d, seed=4096 + d)
    want = np.asarray(JK.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True))
    scale_log2 = float(np.float32(float(np.float32(1.0 / np.sqrt(d)))
                                  * math.log2(math.e)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    causal = torch.ones(4096, 4096, dtype=torch.bool).tril()

    def attention(mm):
        s = mm(qt, kt.transpose(-1, -2))
        s = torch.where(causal, s, -math.inf)
        m = s.amax(-1, keepdim=True) * scale_log2
        p = torch.exp2(s * scale_log2 - m)
        acc = mm(p, vt)
        return acc / p.sum(-1, keepdim=True).clamp_min(1e-30)

    np.testing.assert_allclose(attention(_mm_3xtf32).numpy(), want,
                               rtol=2e-4, atol=2e-4)
    one = attention(lambda a, b: _tf32(a) @ _tf32(b)).numpy()
    assert not np.allclose(one, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal", [(300, 300, True), (8, 256, False),
                                          (8, 256, True)])
def test_flash_attention_matches_reference_ragged(sq, sk, causal, dtype):
    """Shapes the reference's ``ops`` sends to its plain version (Sq not a
    multiple of min(256, Sq); Sq < 16), which the port's kernel takes on
    the card: the port against the reference at the reference test's
    tolerances, D 128."""
    q, k, v = _qkv(2, sq, sk, 128, seed=sq)
    tol = 2e-4 if dtype == "float32" else 3e-2
    want = JK.flash_attention(*(jnp.asarray(a).astype(dtype)
                                for a in (q, k, v)), causal=causal)
    got = TK.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                               for a in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# the widths each type runs at up to 1024: f32 (the TF32 kernel) from 64,
# bf16 and f16 (the wgmma kernels) from 16
_BUILT = {torch.float32: (64, 128, 192, 256, 384, 512, 1024),
          torch.bfloat16: (16, 32, 64, 128, 192, 256, 384, 512, 1024)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 16, 20, 40, 48, 100, 200, 300, 600])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dim_is_the_same_function(d, causal, dtype):
    """The wrapper's padding (f32 below 256 to 64 .. 256, bf16 to 16 .. 256;
    300 to 384, 600 to 1024): the plain version on the padded q, k, v at
    the unpadded D's scale, sliced back to D columns, equals the plain
    version on the unpadded ones (both in f32, on the same values): the
    zero columns add exact zeros to every q.k, and the products' sums are
    blocked otherwise at another width, so rtol = atol = 1e-6, a few f32
    steps of outputs below 1."""
    from repro_torch.kernels.flash_attention import (pad_head_dim,
                                                     padded_head_dim)
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(2, 96, 80, d, seed=d))
    qp, kp, vp = pad_head_dim(q, k, v)
    dp = padded_head_dim(d, dtype)
    assert dp == next(w for w in _BUILT[dtype] if w >= d)
    assert qp.shape == (2, 96, dp) and vp.shape == (2, 80, dp)
    assert qp.dtype == dtype
    assert not qp[..., d:].any() and not kp[..., d:].any()
    assert not vp[..., d:].any()
    scale = 1.0 / np.sqrt(d)
    got = TRef.flash_attention_ref(qp.float(), kp.float(), vp.float(),
                                   causal=causal, scale=scale)
    assert not got[..., d:].any()
    np.testing.assert_allclose(
        got[..., :d].numpy(),
        TRef.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal, scale=scale).numpy(),
        rtol=1e-6, atol=1e-6)
    # a built head dim is left as it is
    for built in (_BUILT[dtype][0], 128, 512):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in _qkv(2, 8, 8, built, seed=1))
        assert all(a is b for a, b in zip(pad_head_dim(q, k, v), (q, k, v)))


@pytest.mark.parametrize("d", list(range(1, 65)) + [65, 100, 128, 129, 192,
                                                     200, 255, 256])
def test_padded_head_dim_and_kernel_up_to_256(d):
    """Up to 256, bf16 and f16 run at the next of 16, 32, 64, 128, 192 and
    256 on the wgmma kernel (16 and 32 are built, no padding to 64); f32
    runs at the next of 64, 128, 192 and 256, three TF32 products on the
    tensor cores: up to 64 on the wgmma kernel (``flash_attention``),
    above it on the mma.sync one (``flash_attention_wide``).  No f32 call
    is left on the CUDA cores."""
    from repro_torch.kernels.flash_attention import kernel_of, padded_head_dim
    half = next(w for w in (16, 32, 64, 128, 192, 256) if w >= d)
    assert padded_head_dim(d, torch.bfloat16) == half
    assert padded_head_dim(d, torch.float16) == half
    assert padded_head_dim(d, torch.float32) == max(64, half)
    assert kernel_of(torch.float32, d) == (
        ("flash_attention", "flash_attention_launch") if d <= 64
        else ("flash_attention_wide", "flash_attention_wide_launch"))
    assert kernel_of(torch.bfloat16, d) == ("flash_attention_wgmma",
                                            "flash_attention_wgmma_launch")
    assert kernel_of(torch.float16, d) == (
        "flash_attention_wgmma", "flash_attention_wgmma_f16_launch")


@pytest.mark.parametrize("d,want", [(257, 384), (300, 384), (384, 384),
                                    (385, 512), (512, 512), (513, 1024),
                                    (640, 1024), (1000, 1024), (1025, 1536)])
def test_padded_head_dim_and_kernel_past_256(d, want):
    """Past 256 a head dim runs at 384 or 512 (the wide kernels' built
    widths), past 512 at the next multiple of 512 (groups of 512 output
    columns); bf16 and f16 take the wide wgmma kernel up to 512, f32 the
    wide f32 kernel, and past 512 every type takes the wide f32
    kernel's launcher of its type."""
    from repro_torch.kernels.flash_attention import kernel_of, padded_head_dim
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert padded_head_dim(d, dtype) == want
    wide = d <= 512
    assert kernel_of(torch.float32, d) == ("flash_attention_wide",
                                           "flash_attention_wide_launch")
    assert kernel_of(torch.bfloat16, d) == (
        ("flash_attention_wgmma_wide", "flash_attention_wgmma_wide_launch")
        if wide else ("flash_attention_wide",
                      "flash_attention_wide_bf16_launch"))
    assert kernel_of(torch.float16, d) == (
        ("flash_attention_wgmma_wide",
         "flash_attention_wgmma_wide_f16_launch")
        if wide else ("flash_attention_wide",
                      "flash_attention_wide_f16_launch"))
    # up to 256 the wgmma kernel in bf16 and f16; f32 at 256 the mma.sync
    # TF32 kernel, at 64 the wgmma TF32 one
    assert kernel_of(torch.float32, 256) == ("flash_attention_wide",
                                             "flash_attention_wide_launch")
    assert kernel_of(torch.float32, 64) == ("flash_attention",
                                            "flash_attention_launch")
    assert kernel_of(torch.bfloat16, 200) == ("flash_attention_wgmma",
                                              "flash_attention_wgmma_launch")


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    """The CUDA wrapper refuses bad arguments before any launch (these
    checks run the same with or without a card): a dtype other than f32,
    bf16 and f16 (at a head dim past 256 too), an empty shape, mismatched
    shapes or dtypes, a misaligned start.  A head dim past 256 is taken
    (by the wide kernel)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    def qkv(sq, sk, d, dtype=torch.float32):
        return (torch.zeros(2, sq, d, dtype=dtype),
                torch.zeros(2, sk, d, dtype=dtype),
                torch.zeros(2, sk, d, dtype=dtype))

    # 320 and 192 pass the dtype check and stop at the shape check
    for d in (320, 192):
        q, k, v = qkv(256, 256, d)
        with pytest.raises(ValueError, match="shape"):
            flash_attention_cuda(q, k, v[:, :128].contiguous(), causal=False,
                                 bq=256, bk=256)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        flash_attention_cuda(*qkv(256, 256, 320, torch.float64), causal=True,
                             bq=256, bk=256)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        flash_attention_cuda(*qkv(256, 256, 64, torch.float64), causal=True,
                             bq=256, bk=256)
    with pytest.raises(ValueError, match="empty"):
        flash_attention_cuda(*qkv(0, 256, 64), causal=True, bq=256, bk=256)
    q, k, v = qkv(256, 256, 64)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_cuda(q, k, v[:, :128].contiguous(), causal=False,
                             bq=256, bk=256)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q, k.to(torch.bfloat16), v, causal=False,
                             bq=256, bk=256)
    shifted = torch.zeros(2 * 256 * 64 + 1)[1:].view(2, 256, 64)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, shifted, v, causal=False, bq=256, bk=256)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 48),
                                     (torch.float16, 320),
                                     (torch.bfloat16, 512)])
def test_wgmma_residency_takes_only_built_instances(dtype, d):
    """``wgmma_residency`` reads the bf16/f16 wgmma kernel's instances
    alone (bf16 and f16 at 16, 32, 64, 128, 192 and 256): any other type
    or head dim raises before the library is loaded, with or without a
    card."""
    from repro_torch.kernels.flash_attention import wgmma_residency

    with pytest.raises(ValueError, match="built for bf16 and f16"):
        wgmma_residency(dtype, d, 0)
