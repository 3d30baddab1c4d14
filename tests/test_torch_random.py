"""The port's threefry draws are bit-exact against jax.random.

`repro_torch.random` implements jax's default partitionable threefry
(``jax_threefry_partitionable=True``); every reference call here runs
with that flag pinned."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
from repro_torch import random as R  # noqa: E402

SEEDS = [0, 1, 42, 123456, 2**31 - 1, 2**32 - 1, -5]


def _jax(fn, *args, **kw):
    with jax.threefry_partitionable(True):
        return np.asarray(fn(*args, **kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    jk = _jax(jax.random.PRNGKey, seed)
    pk = R.PRNGKey(seed)
    np.testing.assert_array_equal(pk, jk)
    assert pk.dtype == np.uint32
    for num in (2, 3, 16):
        np.testing.assert_array_equal(R.split(pk, num),
                                      _jax(jax.random.split, jk, num))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (3000,), (4, 5)])
def test_uniform(seed, shape):
    jk = _jax(jax.random.split, _jax(jax.random.PRNGKey, seed))[1]
    pk = R.split(R.PRNGKey(seed))[1]
    got = R.uniform(pk, shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _jax(jax.random.uniform, jk, shape))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 10), (0, 3000), (0, 100_000),
                                   (0, 2**27), (5, 5), (7, 3)])
def test_randint(seed, lo, hi):
    jk = _jax(jax.random.PRNGKey, seed)
    pk = R.PRNGKey(seed)
    np.testing.assert_array_equal(
        R.randint(pk, (3000,), lo, hi),
        _jax(jax.random.randint, jk, (3000,), lo, hi))


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("n_cat", [1, 2, 3, 16])
def test_categorical(seed, n_cat):
    """Drawn indices match jax's Gumbel-max, including zero-mass
    categories (logit -inf), which are never drawn."""
    mass = np.random.default_rng(seed & 0xFFFF).random(n_cat)
    if n_cat > 2:
        mass[1] = 0.0
    mass = (mass / mass.sum()).astype(np.float32)
    jk = _jax(jax.random.PRNGKey, seed)
    pk = R.PRNGKey(seed)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.categorical(
            jk, jnp.log(jnp.asarray(mass)), shape=(3000,)))
    got = R.categorical(pk, R.log32(mass), (3000,))
    np.testing.assert_array_equal(got, want)
    if n_cat > 2:
        assert not np.any(got == 1)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(7,), (3000, 33)])
def test_gumbel_bit_for_bit(seed, shape):
    """Gumbel noise -log(-log u) takes both logs as XLA's CPU does, so it
    equals jax's noise to the bit, not only the argmax it feeds."""
    got = R.gumbel(R.PRNGKey(seed), shape)
    want = _jax(jax.random.gumbel, _jax(jax.random.PRNGKey, seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
