"""``repro_torch.prng`` against ``jax.random`` on the CPU, bit for bit:
``key``, ``fold_in`` (by ints and by a 0-d int32 tensor, as the train step
folds in its ``step``), ``random_bits``, ``uniform`` and ``bernoulli``
over several seeds, shapes and probabilities, the reference's
per-(virtual worker, step) key included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import prng

SEEDS = [0, 1, 3, 12345, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (4, 32, 24), (2, 3, 4, 5)]


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for d in (0, 1, 5, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _words(jax.random.fold_in(jk, d)))
    step = torch.tensor(7, dtype=torch.int32)
    np.testing.assert_array_equal(
        prng.fold_in(prng.fold_in(tk, 5), step).numpy(),
        _words(jax.random.fold_in(jax.random.fold_in(jk, 5), 7)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_bernoulli(seed, shape):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 2),
                            9)
    tk = prng.fold_in(prng.fold_in(prng.key(seed), 2), 9)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                  _words(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(
        prng.uniform(tk, shape).numpy().view(np.int32),
        np.asarray(jax.random.uniform(jk, shape)).view(np.int32))
    for p in (0.1, 0.5, 0.9, 0.75):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), vw=st.integers(0, 63),
       step=st.integers(0, 2 ** 31 - 1),
       p=st.floats(0.01, 0.99, allow_nan=False),
       shape=st.lists(st.integers(1, 9), min_size=1, max_size=3))
def test_virtual_worker_masks(seed, vw, step, p, shape):
    """The dropout mask of virtual worker ``vw`` at ``step``."""
    shape = tuple(shape)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                               vw), step)
    tk = prng.fold_in(prng.fold_in(prng.key(seed), vw),
                      torch.tensor(step, dtype=torch.int32))
    np.testing.assert_array_equal(
        prng.bernoulli(tk, p, shape).numpy(),
        np.asarray(jax.random.bernoulli(jk, p, shape)))
