"""PyTorch port: kernel I's wrappers (kernels/hit_grid.py) against the JAX
package's grid kernels run as its own tests run them on the CPU (interpret
mode): ``hit_spheres_grid_rows`` (rows, pass A by v4) and the experimental
``hit_spheres_grid_pallas`` (columns, pass A by v3).

On the CPU the wrappers run kernel I's plain versions.  Tolerances are the
reference's own tests' against their brute oracle (test_hit_grid_rows.py,
test_hit_grid.py): XLA's CPU code rounds the ground sphere's root and the
quadratic's sums with fused multiply-adds where the port rounds twice
(ROADMAP Queue 3), so t agrees to rtol 5e-4 and a grazing ray may flip;
the TPU kernels also return sphere 0's attributes on a miss where the port
writes zeros, so attributes are compared on hit lanes only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu.accel import build_grid_accel as jax_build
from win32_raytracer_tpu.kernels.experimental.hit_grid import hit_spheres_grid_pallas as jax_grid_cols
from win32_raytracer_tpu.kernels.hit_grid_rows import hit_spheres_grid_rows as jax_grid_rows
from win32_raytracer_tpu.scene.builders import random_scene
from win32_raytracer_tpu_torch.accel import build_grid_accel, hit_spheres_grid_plain
from win32_raytracer_tpu_torch.kernels import hit_grid as KI
from win32_raytracer_tpu_torch.kernels.experimental.hit_grid import hit_spheres_grid_pallas
from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grids():
    js = random_scene()
    return jax_build(js, time_hi=0.05), build_grid_accel(scene_from_numpy(js),
                                                         time_hi=0.05)


def _batch(n, rb, seed, mode):
    """tests/test_hit_grid_rows.py's batches: [N, 3] rays, [N] times."""
    rng = np.random.default_rng(seed)
    if mode == "primary":
        o = np.tile([15.0, 2.0, 4.0], (n, 1)) + rng.normal(0, 0.05, (n, 3))
        d = rng.uniform([-12, 0, -12], [12, 2.5, 12], (n, 3)) - o
    else:  # clustered bounce blocks
        centers = rng.uniform([-11, 0.0, -11], [11, 0.4, 11], (n // rb, 3))
        o = (np.repeat(centers, rb, axis=0)
             + rng.uniform(-0.5, 0.5, (n, 3)) * [1.0, 0.4, 1.0])
        d = rng.normal(0, 0.55, (n, 3)) + [0.0, 1.0, 0.0]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0, 0.05, (n,))
    return o.astype(np.float32), d.astype(np.float32), tm.astype(np.float32)


def _compare(ours: dict, ref: dict):
    hp, hj = ours["hit"], ref["hit"]
    assert (hp != hj).mean() < 2e-3, (hp.sum(), hj.sum())
    both = hp & hj
    same = ours["idx"][both] == ref["idx"][both]
    assert same.mean() > 0.998
    sel = both.copy()
    sel[both] &= same
    np.testing.assert_allclose(ours["t"][sel], ref["t"][sel], rtol=5e-4, atol=1e-5)
    np.testing.assert_array_equal(ours["mat_id"][sel], ref["mat_id"][sel])
    np.testing.assert_allclose(ours["albedo"][sel], ref["albedo"][sel], atol=1e-6)
    np.testing.assert_allclose(ours["normal"][sel], ref["normal"][sel],
                               rtol=0, atol=2e-2)


def _rows_np(rec) -> dict:
    return {f: getattr(rec, f).T.numpy() if getattr(rec, f).shape[0] == 3
            else getattr(rec, f)[0].numpy() for f in rec._fields}


def _jrows_np(rec) -> dict:
    return {f: np.asarray(getattr(rec, f)).T if getattr(rec, f).shape[0] == 3
            else np.asarray(getattr(rec, f))[0] for f in rec._fields}


def _cols_np(rec) -> dict:
    return {f: np.asarray(getattr(rec, f)) for f in rec._fields}


@pytest.mark.parametrize("mode", ["primary", "bounce"])
def test_rows_matches_reference(grids, mode, rb=256):
    jg, tg = grids
    o, d, tm = _batch(1024, rb, {"primary": 3, "bounce": 4}[mode], mode)
    ref = jax_grid_rows(jg, jnp.asarray(o.T), jnp.asarray(d.T),
                        jnp.asarray(tm[None]), ray_block=rb, interpret=True)
    ours = KI.hit_spheres_grid_rows(
        tg, torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy()),
        torch.from_numpy(tm[None].copy()), ray_block=rb)
    assert ours.t.shape == (1, 1024)
    _compare(_rows_np(ours), _jrows_np(ref))


@pytest.mark.parametrize("mode", ["primary", "bounce"])
def test_cols_matches_reference(grids, mode, rb=256):
    jg, tg = grids
    o, d, tm = _batch(1024, rb, {"primary": 3, "bounce": 4}[mode], mode)
    ref = jax_grid_cols(jg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                        ray_block=rb, interpret=True)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    ours = KI.hit_spheres_grid_cols(tg, *args, ray_block=rb)
    assert ours.t.shape == (1024,)
    _compare(_cols_np(ours), _cols_np(ref))
    # The experimental module's entry point is the column instance.
    adapter = hit_spheres_grid_pallas(tg, *args, ray_block=rb)
    for f in ours._fields:
        assert torch.equal(getattr(adapter, f), getattr(ours, f)), f


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_padding(grids, layout):
    """N not a multiple of the ray block pads as the reference pads and
    unpads on return; the rows and column instances give one record."""
    jg, tg = grids
    o, d, tm = _batch(512, 256, 5, "bounce")
    o, d, tm = o[:300], d[:300], tm[:300]
    if layout == "rows":
        ref = _jrows_np(jax_grid_rows(jg, jnp.asarray(o.T), jnp.asarray(d.T),
                                      jnp.asarray(tm[None]), ray_block=256,
                                      interpret=True))
        rec = KI.hit_spheres_grid_rows(
            tg, torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy()),
            torch.from_numpy(tm[None].copy()), ray_block=256)
        assert rec.hit.shape == (1, 300)
        ours = _rows_np(rec)
    else:
        ref = _cols_np(jax_grid_cols(jg, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(tm), ray_block=256,
                                     interpret=True))
        rec = KI.hit_spheres_grid_cols(tg, torch.from_numpy(o), torch.from_numpy(d),
                                       torch.from_numpy(tm), ray_block=256)
        assert rec.hit.shape == (300,)
        ours = _cols_np(rec)
    _compare(ours, ref)
    plain = _cols_np(hit_spheres_grid_plain(tg, torch.from_numpy(o),
                                            torch.from_numpy(d),
                                            torch.from_numpy(tm), ray_block=256))
    for f, x in ours.items():
        np.testing.assert_array_equal(x, plain[f], err_msg=f)


def test_wrappers_refuse_other_devices(grids):
    _, tg = grids
    meta = torch.empty((3, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        KI.hit_spheres_grid_rows(tg, meta, meta, torch.empty((1, 8), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        KI.hit_spheres_grid_cols(tg, meta.T, meta.T, torch.empty((8,), device="meta"))
