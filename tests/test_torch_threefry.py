"""PyTorch port: the wavefront scheduler's draws (core/rng.py prng_key,
fold_in, uniform01) against ``jax.random``, bit for bit.

The port follows the form JAX uses with ``jax_threefry_partitionable``
on; each comparison asserts the flag next to it, so a JAX that changes
the default cannot pass silently."""

import jax
import numpy as np
import pytest
import torch

from win32_raytracer_tpu.core.rng import uniform01 as jax_uniform01
from win32_raytracer_tpu_torch.core import rng

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2 ** 31 + 11, 2 ** 32 - 1]
# Row offsets of chunks, the camera/bounce tags, depths, and large words.
DATA = [0, 1, 2, 10, 799, 4800, 123456, 2 ** 20 + 3, 2 ** 31 + 5, 2 ** 32 - 1]


def _pair(key) -> tuple:
    return tuple(int(x) for x in np.asarray(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_exact(seed):
    assert jax.config.jax_threefry_partitionable is True
    key = jax.random.PRNGKey(seed)
    ours = rng.prng_key(seed)
    assert ours == _pair(key)
    for data in DATA:
        assert rng.fold_in(ours, data) == _pair(jax.random.fold_in(key, data))
    # The wavefront's chain: seed -> chunk row -> 1|2 -> depth.
    for y0, tag, depth in ((0, 1, 0), (480, 2, 3), (1 << 16, 2, 10)):
        want = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(key, y0), tag), depth)
        got = rng.fold_in(rng.fold_in(rng.fold_in(ours, y0), tag), depth)
        assert got == _pair(want)


@pytest.mark.parametrize("n", [1, 7, 333, 4097])
@pytest.mark.parametrize("seed", [0, 9, 2 ** 32 - 3])
def test_uniform01_bit_exact(n, seed):
    """[n, 5] draws, odd n included (the reference's threefry pads odd
    counts in its other form), and a 1-d shape."""
    assert jax.config.jax_threefry_partitionable is True
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 96), 2)
    ours_key = rng.fold_in(rng.fold_in(rng.prng_key(seed), 96), 2)
    for shape in ((n, 5), (n,)):
        want = np.asarray(jax_uniform01(key, shape))
        got = rng.uniform01(ours_key, shape).numpy()
        assert got.dtype == want.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform01_range_and_device_argument():
    u = rng.uniform01(rng.prng_key(4), (20000, 5), device="cpu")
    assert u.device.type == "cpu"
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    # Different keys, different streams.
    v = rng.uniform01(rng.fold_in(rng.prng_key(4), 1), (20000, 5))
    assert (u != v).float().mean() > 0.99
