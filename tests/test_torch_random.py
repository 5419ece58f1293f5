"""repro_torch.random vs jax.random: the protocol's draws, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import random as TR

SEEDS = [0, 3, 20210507, 2 ** 31 - 1]
SHAPES = [(1,), (33,), (1000,), (5, 7), (3, 256)]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    k = jax.random.PRNGKey(seed)
    kt = TR.PRNGKey(seed)
    assert tuple(np.asarray(k).tolist()) == kt
    for data in (0, 1, 7, 2 ** 31, 2 ** 32 - 1):
        assert tuple(np.asarray(jax.random.fold_in(k, data)).tolist()) == \
            TR.fold_in(kt, data)
    for num in (1, 2, 5):
        want = [tuple(r) for r in np.asarray(jax.random.split(k, num)).tolist()]
        assert list(TR.split(kt, num)) == want


@pytest.mark.parametrize("seed,shape", list(zip(SEEDS + SEEDS[:1], SHAPES)))
def test_bits_uniform_rademacher(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    kt = TR.fold_in(TR.PRNGKey(seed), 11)
    bits = np.asarray(jax.random.bits(k, shape, jnp.uint32))
    np.testing.assert_array_equal(
        TR.bits(kt, shape, device="cpu").numpy().view(np.uint32), bits)
    u = np.asarray(jax.random.uniform(k, shape, jnp.float32, -0.5, 0.5))
    np.testing.assert_array_equal(
        TR.uniform(kt, shape, -0.5, 0.5, device="cpu").numpy()
        .view(np.uint32),
        u.view(np.uint32))
    u01 = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    np.testing.assert_array_equal(
        TR.uniform(kt, shape, device="cpu").numpy().view(np.uint32),
        u01.view(np.uint32))
    r = np.asarray(jax.random.rademacher(k, shape, jnp.float32))
    np.testing.assert_array_equal(
        TR.rademacher(kt, shape, device="cpu").numpy(), r)


def test_chunked_draw_matches_one_shot(monkeypatch):
    """A draw split into many chunks is the same stream as one chunk."""
    kt = TR.fold_in(TR.PRNGKey(5), 2)
    whole = TR.bits(kt, (3000,), device="cpu").numpy()
    monkeypatch.setattr(TR, "_CHUNK", 128)
    np.testing.assert_array_equal(
        TR.bits(kt, (3000,), device="cpu").numpy(), whole)


@pytest.mark.parametrize("seed", [2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5, -1])
def test_wide_and_negative_seeds_match_jax(seed):
    assert TR.PRNGKey(seed) == \
        tuple(np.asarray(jax.random.PRNGKey(seed)).tolist())
