"""The port's threefry generator against ``jax.random``: the same keys and
the same uniform draws, bit for bit (threefry2x32 with
``jax_threefry_partitionable=True``)."""

import jax
import numpy as np
import pytest
import torch

from cold_compress_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_jax_uses_the_partitionable_counter_layout():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 1])
def test_key_and_fold_in_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    t = prng.prng_key(seed)
    np.testing.assert_array_equal(t.numpy(), np.asarray(key).astype(np.int64))
    for data in (0, 1, 7, 2**20 + 3):
        ref = np.asarray(jax.random.fold_in(key, data)).astype(np.int64)
        np.testing.assert_array_equal(prng.fold_in(t, data).numpy(), ref)
        # A 0-d device tensor (the random strategy's step counter) as well.
        got = prng.fold_in(t, torch.tensor(data, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [1, 7, 128, 2048])
@pytest.mark.parametrize("data", [0, 3, 300])
def test_uniform_bit_exact(n, data):
    """The float mapping ``(bits >> 9) | 0x3F800000`` minus 1 and the
    per-element counters (0, i) give the reference's floats exactly."""
    key = jax.random.fold_in(jax.random.PRNGKey(1234), data)
    ref = np.asarray(jax.random.uniform(key, (n,)))
    got = prng.uniform(prng.fold_in(prng.prng_key(1234), data), (n,)).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


def test_uniform_of_a_shape_and_bits():
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax.random.uniform(key, (1, 3, 11)))
    got = prng.uniform(prng.prng_key(5), (1, 3, 11)).numpy()
    assert got.shape == (1, 3, 11) and got.tobytes() == ref.tobytes()
    bits = np.asarray(jax.random.bits(key, (64,))).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(prng.prng_key(5), (64,)).numpy(), bits)
