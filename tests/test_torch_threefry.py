"""PyTorch port: the wavefront scheduler's draws (core/rng.py prng_key,
fold_in, uniform01, and the draw kernel's wrapper kernels/draws.py)
against ``jax.random``, bit for bit, and the render's route to them.

The port follows the form JAX uses with ``jax_threefry_partitionable``
on; each comparison asserts the flag next to it, so a JAX that changes
the default cannot pass silently."""

import importlib

import jax
import numpy as np
import pytest
import torch

from win32_raytracer_tpu.core.rng import uniform01 as jax_uniform01
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.core import rng
from win32_raytracer_tpu_torch.kernels import draws
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)
# The module (the package's ``render`` is the entry function).
wavefront = importlib.import_module("win32_raytracer_tpu_torch.render")

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


# The port's two draw functions: core/rng.py's torch ops, and the draw
# kernel's wrapper, which runs them on the CPU.
UNIFORM01 = {"rng": lambda key, shape: rng.uniform01(key, shape),
             "kernel_wrapper": lambda key, shape: draws.uniform01(key, shape, "cpu")}


@pytest.mark.parametrize("impl", sorted(UNIFORM01))
@pytest.mark.parametrize("n", [1, 7, 333, 4097])
@pytest.mark.parametrize("seed", [0, 9, 2 ** 32 - 3])
def test_uniform01_bit_exact(n, seed, impl):
    """[n, 5] draws, odd n included (the reference's threefry pads odd
    counts in its other form), and a 1-d shape."""
    assert jax.config.jax_threefry_partitionable is True
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 96), 2)
    ours_key = rng.fold_in(rng.fold_in(rng.prng_key(seed), 96), 2)
    for shape in ((n, 5), (n,)):
        want = np.asarray(jax_uniform01(key, shape))
        got = UNIFORM01[impl](ours_key, shape).numpy()
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


def test_draw_wrapper_devices():
    """The wrapper launches nothing for the CPU (it runs core/rng.py) and
    raises for a device that is neither the CPU nor a card."""
    before = draws.LAUNCHES
    u = draws.uniform01(rng.prng_key(1), (4, 5), "cpu")
    assert draws.LAUNCHES == before and u.shape == (4, 5)
    with pytest.raises(ValueError, match="unsupported device meta"):
        draws.uniform01(rng.prng_key(1), (4, 5), "meta")


def _recorded(fn):
    """fn(), one render, inside a recorded stretch; (its result, the
    render's counters, {} where it counted nothing)."""
    with profiling.recording():
        out = fn()
    counters = profiling.log()["counters"]
    assert len(counters) <= 1
    return out, next(iter(counters.values()), {})


# backend -> (the route's counter, the other's)
ROUTES = {"auto": ("draws.threefry_kernel", "draws.threefry_plain"),
          "jnp": ("draws.threefry_plain", "draws.threefry_kernel")}


@pytest.mark.parametrize("backend", sorted(ROUTES))
def test_render_image_routes_draws_by_backend(backend):
    """The wavefront takes its draws from the kernel's wrapper where
    resolve_backend gives "kernels" (auto) and from core/rng.py under
    "jnp": one draw for the camera and one a bounce, each chunk, on its
    route's counter alone; a deterministic render draws nothing."""
    cfg = TC(width=12, height=6, samples=2, max_depth=3, seed=3,
             backend=backend, rays_per_chunk=12 * 2 * 4)
    _, counters = _recorded(lambda: wavefront.render_image(
        tb.test_scene(), None, cfg))
    route, other = ROUTES[backend]
    assert counters[route] == 2 * (cfg.max_depth + 2)   # two chunks
    assert other not in counters
    _, counters = _recorded(lambda: wavefront.render_image(
        tb.test_scene(), None, cfg.replace(deterministic=True)))
    assert not any(k.startswith("draws.") for k in counters)


@pytest.mark.parametrize("scene", ["test", "final"])
def test_wavefront_image_equals_the_plain_draws_image(scene, monkeypatch):
    """A CPU wavefront render through the kernel's route is torch.equal to
    the render with core/rng.py's draws called directly (what the
    wavefront drew before the kernel) and to the ``backend="jnp"``
    render, over several chunks."""
    cfg = TC(width=24, height=10, samples=3, seed=11, rays_per_chunk=24 * 3 * 4)
    sc = tb.get_scene(scene)
    auto = wavefront.render_image(sc, None, cfg)
    plain = wavefront.render_image(sc, None, cfg.replace(backend="jnp"))
    monkeypatch.setattr(
        wavefront, "_uniform01",
        lambda key, shape, *, cfg, device: rng.uniform01(key, shape, device=device))
    direct = wavefront.render_image(sc, None, cfg)
    assert auto.shape == (10, 24, 3) and auto.std() > 0
    assert torch.equal(auto, direct) and torch.equal(auto, plain)
