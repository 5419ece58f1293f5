"""repro_torch.random vs jax.random: the protocol's draws, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _tensor(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed,shape", [(0, (50, 40)), (9, (7,)),
                                        (2 ** 31 - 1, (3, 5, 11))])
def test_bernoulli_bitwise(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    kt = TR.fold_in(TR.PRNGKey(seed), 2)
    for p in (0.1, 0.5, 0.97):
        np.testing.assert_array_equal(
            TR.bernoulli(kt, p, shape, device="cpu").numpy(),
            np.asarray(jax.random.bernoulli(k, p, shape)))


def test_gumbel_to_an_ulp():
    """The uniform draw under it is bitwise; torch's log rounds differently
    from XLA's in the last bit, so most draws are bitwise and the rest a
    few f32 ulps off."""
    k = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    kt = TR.fold_in(TR.PRNGKey(3), 5)
    want = np.asarray(jax.random.gumbel(k, (70, 300)))
    got = TR.gumbel(kt, (70, 300), device="cpu").numpy()
    assert np.mean(got == want) > 0.6
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("vocab", [257, 4096])
def test_categorical_flips_counted(vocab):
    """The argmax over ``gumbel + logits``: bitwise except where a Gumbel
    draw an ulp off flips the argmax between two near-tied categories.
    None flip in these draws (2,000 samples each)."""
    r = np.arange(1, vocab + 1, dtype=np.float64)
    logits = np.log((1 / r) / (1 / r).sum()).astype(np.float32)
    k = jax.random.fold_in(jax.random.PRNGKey(11), vocab)
    kt = TR.fold_in(TR.PRNGKey(11), vocab)
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logits),
                                             shape=(20, 100)))
    got = TR.categorical(kt, _tensor(logits), (20, 100),
                         device="cpu").numpy()
    assert got.dtype == np.int32
    assert np.mean(got != want) == 0.0


def test_span_and_rows_are_slices_of_the_whole_draw(monkeypatch):
    """A partial draw equals the same slice of the whole draw, chunked or
    not (a rank draws only its own rows)."""
    kt = TR.fold_in(TR.PRNGKey(4), 1)
    shape = (6, 35)
    fns = {
        "bits": lambda **kw: TR.bits(kt, shape, device="cpu", **kw),
        "uniform": lambda **kw: TR.uniform(kt, shape, -1.0, 2.0,
                                           device="cpu", **kw),
        "normal": lambda **kw: TR.normal(kt, shape, device="cpu", **kw),
        "randint": lambda **kw: TR.randint(kt, shape, 3, 17, device="cpu",
                                           **kw),
        "bernoulli": lambda **kw: TR.bernoulli(kt, 0.3, shape, device="cpu",
                                               **kw),
        "gumbel": lambda **kw: TR.gumbel(kt, shape, device="cpu", **kw),
    }
    monkeypatch.setattr(TR, "_CHUNK", 16)
    for name, fn in fns.items():
        whole = fn()
        assert np.array_equal(fn(rows=(2, 5)).numpy(),
                              whole[2:5].numpy()), name
        assert np.array_equal(fn(span=(13, 101)).numpy(),
                              whole.reshape(-1)[13:101].numpy()), name
    logits = _tensor(np.linspace(-1, 0, 50).astype(np.float32))
    whole = TR.categorical(kt, logits, (6, 7), device="cpu")
    assert np.array_equal(
        TR.categorical(kt, logits, (6, 7), device="cpu", rows=(1, 4)).numpy(),
        whole[1:4].numpy())
    with pytest.raises(ValueError, match="not both"):
        TR.bits(kt, shape, device="cpu", span=(0, 1), rows=(0, 1))
    with pytest.raises(ValueError, match="outside"):
        TR.bits(kt, shape, device="cpu", rows=(5, 7))
