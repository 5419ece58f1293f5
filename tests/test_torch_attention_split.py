"""Attention with few queries over many keys: the split kernel's
arithmetic and routing, against the reference, on the CPU.

``csrc/flash_attention_split.cu`` splits the keys of each (batch*head) row
over the grid (``kernels.flash_attention.split_plan``), keeps each split's
online-softmax state (m, l, acc) in f32 and merges the splits in split
order.  Here a plain torch model of that split-and-merge runs on numpy
inputs beside the reference's ``ops.flash_attention`` (which sends Sq < 16
to its plain version), and the wrapper's routing (``kernel_of``) and plan
are held to what they state.  The kernel itself is held against the plain
version on the card in ``tests/test_torch_cuda.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro_torch.kernels import flash_attention as FA

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# the split kernel's limits as its library states them (most splits, keys
# of one tile for each warp), held on the card in tests/test_torch_cuda.py
LIMITS = {torch.float32: (64, 32), torch.bfloat16: (64, 64),
          torch.float16: (64, 64)}


def _qkv(bh, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32))


def split_model(q, k, v, kps):
    """The split kernel's arithmetic in torch, f32: scores scaled by
    f32(1/sqrt(D)) log2(e), exponentials base 2; each split of ``kps``
    keys (the last what is left) keeps its max m, sum l and accumulator;
    the splits merged in order with factors exp2(m_s - m); out = acc /
    max(l, 1e-30)."""
    d = q.shape[-1]
    scale = FA._scale_log2(d)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    parts = []
    for k0 in range(0, k.shape[1], kps):
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + kps]) * scale
        m = s.amax(-1)
        p = torch.exp2(s - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bqk,bkd->bqd", p,
                                                 vf[:, k0:k0 + kps])))
    mt = torch.stack([m for m, _, _ in parts]).amax(0)
    lt = torch.zeros_like(mt)
    acc = torch.zeros_like(qf)
    for m, l, a in parts:
        f = torch.exp2(m - mt)
        lt = lt + l * f
        acc = acc + a * f[..., None]
    return (acc / lt.clamp_min(1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,kps", [
    (1, 37, 8),          # one query; Sk not a multiple of the split
    (8, 37, 1),          # splits of one key
    (16, 512, 192),      # the largest Sq (the reference's kernel); a
                         # ragged last split
    (3, 1, 64),          # one key, one split
    (8, 4096, 704),      # the smoke's 8 queries over 4,096 keys
])
def test_split_model_matches_reference(sq, sk, kps, dtype):
    """Splitting the keys and merging the splits' (m, l, acc) in order
    computes the reference's attention (its plain path for Sq < 16, its
    Pallas kernel in interpret mode at 16 where the shape allows), within
    the reference test's tolerances: 2e-4 f32, 3e-2 bf16."""
    q, k, v = _qkv(2, sq, sk, 64, seed=sq + sk + kps)
    want = JK.flash_attention(*(jnp.asarray(a).astype(dtype)
                                for a in (q, k, v)), causal=False)
    got = split_model(*(torch.from_numpy(a).to(getattr(torch, dtype))
                        for a in (q, k, v)), kps)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sk,blocks", [
    (64, 4096, 396), (64, 32768, 396), (128, 4096, 660), (3, 1, 396),
    (3, 511, 396), (3, 32768, 264), (1, 1_000_000, 132), (70_000, 16, 528),
    (5, 257, 100)])
def test_split_plan_covers_the_keys(bh, sk, blocks, dtype):
    """With the kernel's limits of each type, the plan's splits cover Sk
    with none empty, each a multiple of the key alignment (but the last),
    at most the most splits, no more than make the blocks aimed at nor
    than one for each SPLIT_MIN_KEYS keys; the model with that plan still
    computes the reference's attention."""
    max_splits, align = LIMITS[dtype]
    splits, kps = FA.split_plan(bh, sk, blocks, max_splits, align)
    assert 1 <= splits <= max_splits and kps % align == 0
    assert (splits - 1) * kps < sk <= splits * kps
    assert splits == 1 or splits <= blocks // bh
    assert splits <= -(-sk // FA.SPLIT_MIN_KEYS)
    if sk <= 4096 and bh <= 64:
        q, k, v = _qkv(1, 4, sk, 32, seed=sk)
        want = JK.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False)
        got = split_model(*(torch.from_numpy(a) for a in (q, k, v)), kps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_split_plan_of_the_smoke_cases():
    """On 132 SMs: qwen3-32b's heads (BH 64, bf16, one block an SM), 8
    queries over 4,096 keys and one over 32,768: 2 splits, 128 blocks;
    granite-moe's (BH 128), 16 queries over 4,096: f16 one split, f32 (two
    blocks an SM) 2."""
    def plan(bh, sk, dtype):
        return FA.split_plan(bh, sk, FA.SPLIT_BLOCKS_PER_SM[dtype] * 132,
                             *LIMITS[dtype])
    assert plan(64, 4096, torch.bfloat16) == (2, 2048)
    assert plan(64, 32768, torch.bfloat16) == (2, 16384)
    assert plan(128, 4096, torch.float16) == (1, 4096)
    assert plan(128, 4096, torch.float32) == (2, 2048)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_of_routes_few_queries_to_the_split_kernel(dtype):
    """The split kernel takes exactly the calls with Sq <= 16, not causal,
    head dim <= 256; every other call goes where it went before (by head
    dim alone, as ``kernel_of(dtype, d)`` with no Sq says)."""
    for d in (1, 16, 48, 64, 100, 128, 200, 256, 257, 320, 512, 600):
        for sq in (1, 8, 15, 16, 17, 64, 4096):
            for causal in (True, False):
                got = FA.kernel_of(dtype, d, sq, causal)
                if sq <= FA.SPLIT_MAX_SQ and not causal and d <= 256:
                    assert got == FA._SPLIT[dtype], (d, sq, causal)
                    assert got[0] == "flash_attention_split"
                else:
                    assert got == FA.kernel_of(dtype, d), (d, sq, causal)
                    assert got[0] != "flash_attention_split"


def test_scale_matches_the_wrapper_formula():
    """The cached scale is f32(f32(1/sqrt(D)) log2(e)), as every kernel
    takes it."""
    for d in (16, 48, 64, 100, 128, 256, 320):
        want = np.float32(np.float32(1.0 / np.sqrt(d)) * math.log2(math.e))
        assert FA._scale_log2(d) == float(want)


def test_split_workspace_grows_and_is_kept():
    """A stream's scratch and counters are made once, kept while they are
    large enough, and replaced by larger ones (counters zeroed) when a call
    needs more."""
    dev, key = torch.device("cpu"), (None, 12345)
    try:
        a, c = FA._split_workspace(dev, 12345, 100, 4)
        assert a.dtype == torch.float32 and a.numel() >= 100
        assert c.dtype == torch.int32 and c.numel() >= 4
        assert not c.any()
        b, d = FA._split_workspace(dev, 12345, 50, 2)
        assert b is a and d is c
        e, f = FA._split_workspace(dev, 12345, 200, 8)
        assert e.numel() >= 200 and f.numel() >= 8 and not f.any()
        assert FA._WORKSPACE[key] == (e, f)
    finally:
        FA._WORKSPACE.pop(key, None)
