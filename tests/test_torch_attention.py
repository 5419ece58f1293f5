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


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    """The CUDA wrapper refuses bad arguments before any launch (these
    checks run the same with or without a card)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    def qkv(sq, sk, d, dtype=torch.float32):
        return (torch.zeros(2, sq, d, dtype=dtype),
                torch.zeros(2, sk, d, dtype=dtype),
                torch.zeros(2, sk, d, dtype=dtype))

    with pytest.raises(ValueError, match="D in"):
        flash_attention_cuda(*qkv(256, 256, 48), causal=True, bq=256, bk=256)
    # 192 passes the head-dim check and stops at the next one
    q, k, v = qkv(256, 256, 192)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_cuda(q, k, v[:, :128].contiguous(), causal=False,
                             bq=256, bk=256)
    with pytest.raises(ValueError, match="f32 or bf16"):
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
