"""The FWHT's launch plan past 16,384 coordinates, on the CPU.

Rows of 2^15 to 2^18 take one launch of ``csrc/fwht.cu``'s cluster
kernel: each block of a cluster runs index bits 0-13 of its chunk of
16,384 coordinates, then the blocks exchange columns and run the high bits
across chunks, f32 between, one scale at the end.  Longer rows take the
tile kernel over their low 14 bits, unscaled, then one launch per group of
the rest (``kernels.fwht.fwht_passes``).  Here a torch model of exactly that
decomposition is held bitwise to the plain version (``fwht_ref``), which
is held to the reference's ``ops.fwht``; the kernel itself is held
bitwise to the plain version on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fwht as F
from repro_torch.kernels import ref


def _stages(v, lo, hi):
    """The butterflies over index bits lo .. hi - 1 of the last axis,
    lowest first, (a, b) -> (a + b, a - b) with a the lower index; f32."""
    lead, d = v.shape[:-1], v.shape[-1]
    for b in range(lo, hi):
        h = 1 << b
        v = v.reshape(lead + (d // (2 * h), 2, h))
        v = torch.stack([v[..., 0, :] + v[..., 1, :],
                         v[..., 0, :] - v[..., 1, :]], dim=-2)
    return v.reshape(lead + (d,))


def _chunks_then_cluster(v, log2d):
    """The cluster kernel over index bits 0 .. log2d - 1 of rows of v (f32,
    unscaled): each chunk of 2^14 its bits 0-13 on its own, in the
    kernel's three register passes (0-4, 5-9, 10-13), then the bits past
    13 across chunks, bit 14 first."""
    rows = v.shape[0]
    c = v.reshape(rows, -1, F.TILE_D)
    for lo, hi in ((0, 5), (5, 10), (10, F.TILE_LOG2)):
        c = _stages(c, lo, hi)
    x = c.reshape(rows, -1, 1 << log2d)
    chunks = x.reshape(rows, -1, 1 << (log2d - F.TILE_LOG2), F.TILE_D)
    chunks = _stages(chunks.transpose(-1, -2),
                     0, log2d - F.TILE_LOG2).transpose(-1, -2)
    return chunks.reshape(v.shape)


def plan_model(x):
    """The card's launches for rows of ``x`` past 16,384, in torch: the
    cluster kernel over all the bits where there is no further pass, else
    the tile kernel over the bits below the first pass's, then each of
    ``fwht_passes`` over its bits, f32 between, one scale, then the input
    type."""
    d = x.shape[-1]
    log2d = d.bit_length() - 1
    passes = F.fwht_passes(d)
    first = passes[0][0] if passes else log2d
    v = x.to(torch.float32).reshape(-1, 1 << first)
    v = _chunks_then_cluster(v, first).reshape(x.shape)
    for b0, k in passes:
        v = _stages(v, b0, b0 + k)
    scale = float(np.float32(1.0 / np.sqrt(d)))
    return (v * scale).to(x.dtype)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("d,launches,first", [
    (1 << 4, 1, None), (1 << 14, 1, None), (1 << 15, 1, None),
    (1 << 16, 1, None), (1 << 17, 1, None), (1 << 18, 1, None),
    (1 << 19, 2, 14), (1 << 20, 2, 14), (1 << 22, 2, 14), (1 << 23, 3, 14),
    (1 << 26, 3, 14), (1 << 27, 3, 14), (1 << 30, 3, 14), (1 << 31, 4, 14)])
def test_launch_plan(d, launches, first):
    """Up to 2^18 one launch; past it a first launch over the low 14 bits
    (the tile kernel) and one launch per group of at most 8 of the rest,
    groups as even as can be, covering every bit once and in order."""
    passes = F.fwht_passes(d)
    assert 1 + len(passes) == launches
    assert (passes[0][0] if passes else None) == first
    bits = list(range(passes[0][0] if passes else F.CLUSTER_LOG2))
    for b0, k in passes:
        assert 1 <= k <= F.HIGH_BITS and b0 == len(bits)
        bits += range(b0, b0 + k)
    assert bits[:d.bit_length() - 1] == list(range(d.bit_length() - 1))
    if passes:
        assert len(bits) == d.bit_length() - 1
        assert max(k for _, k in passes) - min(k for _, k in passes) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1 << 15, 1 << 16, 1 << 17, 1 << 18])
def test_fake_takes_one_launch_up_to_2_18(d, dtype):
    """The shape-only implementation records one launch for rows of up to
    2^18, reading x and writing the output of its type: no f32 scratch for
    bf16."""
    seen = []
    _build.reset_launch_counts()
    _build.FAKE_OBSERVERS.append(lambda k, i, o: seen.append((k, i, o)))
    try:
        y = ops.fwht(torch.empty(2, d, dtype=dtype, device="meta"))
        assert y.dtype == dtype and tuple(y.shape) == (2, d)
        assert _build.FAKE_LAUNCHES["fwht"] == 1
        assert [(i[0].dtype, o[0].dtype) for _, i, o in seen] == [(dtype,
                                                                   dtype)]
    finally:
        _build.FAKE_OBSERVERS.pop()
        _build.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,rows", [(1 << 15, 3), (1 << 17, 2), (1 << 19, 1),
                                    (1 << 20, 1), (1 << 23, 1)])
def test_decomposition_is_bitwise_the_plain_version(d, rows, dtype):
    """The model of the card's decomposition (chunks of 2^14 in three
    register passes, the high bits across chunks; past 2^18 the tile
    kernel's 14 bits, then the further passes; f32 between, one scale)
    gives the plain version's bits, f32 and bf16 (rounded once at the
    end)."""
    x = torch.from_numpy(np.random.RandomState(d + rows).randn(rows, d)
                         .astype(np.float32)).to(dtype)
    assert torch.equal(_bits(plan_model(x)), _bits(ref.fwht_ref(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1 << 15, 1 << 17])
def test_plain_version_matches_reference(d, dtype):
    """The plain version against the reference's ``ops.fwht`` (its plain
    ``fwht_jnp`` past 16,384) at rows the cluster kernel takes: the same
    stages in the same order, so the same bits."""
    x = np.random.RandomState(d).randn(2, d).astype(np.float32)
    want = JK.fwht(jnp.asarray(x).astype(dtype))
    got = ops.fwht(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
