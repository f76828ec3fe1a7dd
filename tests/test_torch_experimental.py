"""PyTorch port: the experimental hit kernels' adapters
(kernels/experimental/) against the JAX package's experimental kernels in
interpret mode, as its own tests run them on the CPU.

v1 and v2 run on kernel G's wrapper, v5 on kernel A's (their plain versions
here, on the CPU).  The port computes the exact f32 sweep; the reference
kernels factor the quadratic (v2), contract it on the MXU (v5) or fuse
multiply-adds on XLA's CPU, so each is held within the reference test's
own tolerances against its oracle (test_hit_pallas.py for v1 and v2,
test_hit_v5.py for v5), with attributes compared on hit lanes only (the
TPU kernels return sphere 0's row on a miss, the port zeros).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu.kernels.experimental.hit_pallas_v1 import hit_spheres_pallas as jax_v1
from win32_raytracer_tpu.kernels.experimental.hit_pallas_v2 import hit_spheres_pallas_v2 as jax_v2
from win32_raytracer_tpu.kernels.experimental.hit_pallas_v5 import hit_spheres_pallas_v5 as jax_v5
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu_torch.kernels.experimental.hit_pallas_v1 import hit_spheres_pallas
from win32_raytracer_tpu_torch.kernels.experimental.hit_pallas_v2 import hit_spheres_pallas_v2
from win32_raytracer_tpu_torch.kernels.experimental.hit_pallas_v5 import hit_spheres_pallas_v5
from win32_raytracer_tpu_torch.ops.hit import hit_spheres
from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

torch.set_num_threads(1)


def _rays(n, spread, seed, normal=False):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3))
    if normal:
        d = rng.normal(0, 1, (n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        d = rng.uniform(-1, 1, (n, 3))
    tm = rng.uniform(0, 0.05, (n,))
    return o.astype(np.float32), d.astype(np.float32), tm.astype(np.float32)


def _hold(ours: dict, ref: dict, *, hit_flip, same_idx, t_tol, n_atol,
          point=False):
    hp, hj = ours["hit"], ref["hit"]
    assert (hp != hj).mean() < hit_flip, (hp.sum(), hj.sum())
    both = hp & hj
    assert (ours["idx"][both] == ref["idx"][both]).mean() > same_idx
    sel = both & (ours["idx"] == ref["idx"])
    np.testing.assert_allclose(ours["t"][sel], ref["t"][sel], rtol=t_tol[0],
                               atol=t_tol[1])
    np.testing.assert_array_equal(ours["mat_id"][sel], ref["mat_id"][sel])
    np.testing.assert_allclose(ours["albedo"][sel], ref["albedo"][sel], atol=1e-6)
    np.testing.assert_allclose(ours["normal"][sel], ref["normal"][sel],
                               rtol=n_atol[0], atol=n_atol[1])
    if point:
        np.testing.assert_allclose(ours["point"][sel], ref["point"][sel],
                                   rtol=1e-3, atol=1e-3)


def _cols(rec) -> dict:
    return {f: np.asarray(getattr(rec, f)) for f in rec._fields}


@pytest.mark.parametrize("name,spread,seed", [("test", 5.0, 0),
                                              ("random", 15.0, 1)])
def test_v1_matches_reference(name, spread, seed):
    js = jb.get_scene(name)
    o, d, tm = _rays(256, spread, seed)
    ref = jax_v1(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                 ray_block=128, interpret=True)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    ours = hit_spheres_pallas(scene_from_numpy(js), *args, ray_block=128)
    _hold(_cols(ours), _cols(ref), hit_flip=2e-3, same_idx=0.999,
          t_tol=(1e-4, 1e-5), n_atol=(1e-3, 1e-3), point=True)
    plain = hit_spheres(scene_from_numpy(js), *args)   # kernel G's plain version
    for f in ours._fields:
        assert torch.equal(getattr(ours, f), getattr(plain, f)), f


def test_v1_ray_padding():
    """N not a multiple of the reference's block: the adapter takes any N
    (ray_block is ignored), and the t values match the reference's."""
    js = jb.test_scene()
    rng = np.random.default_rng(2)
    o = rng.uniform(-5, 5, (77, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (77, 3)).astype(np.float32)
    tm = np.zeros((77,), np.float32)
    ref = jax_v1(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                 ray_block=128, interpret=True)
    ours = hit_spheres_pallas(scene_from_numpy(js), torch.from_numpy(o),
                              torch.from_numpy(d), torch.from_numpy(tm),
                              ray_block=128)
    assert ours.t.shape == (77,)
    both = ours.hit.numpy() & np.asarray(ref.hit)
    np.testing.assert_allclose(ours.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-4, atol=1e-5)


def test_v2_matches_reference():
    js = jb.random_scene()
    o, d, tm = _rays(512, 10.0, 4)
    ref = jax_v2(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                 ray_block=256, interpret=True)
    ours = hit_spheres_pallas_v2(scene_from_numpy(js), torch.from_numpy(o),
                                 torch.from_numpy(d), torch.from_numpy(tm),
                                 ray_block=256)
    hp, hj = ours.hit.numpy(), np.asarray(ref.hit)
    assert (hp != hj).mean() < 2e-3
    both = hp & hj
    np.testing.assert_allclose(ours.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=2e-2, atol=1e-3)
    assert (ours.idx.numpy()[both] == np.asarray(ref.idx)[both]).mean() > 0.99


@pytest.mark.parametrize("name,spread,seed", [("random", 15.0, 1),
                                              ("test", 5.0, 2)])
def test_v5_matches_reference(name, spread, seed):
    js = jb.get_scene(name)
    o, d, tm = _rays(1024, spread, seed, normal=True)
    ref = jax_v5(js, jnp.asarray(o.T), jnp.asarray(d.T), jnp.asarray(tm[None]),
                 ray_block=256, interpret=True)
    ours = hit_spheres_pallas_v5(
        scene_from_numpy(js), torch.from_numpy(o.T.copy()),
        torch.from_numpy(d.T.copy()), torch.from_numpy(tm[None].copy()),
        ray_block=256)
    assert ours.t.shape == (1, 1024)

    def rows(rec, conv):
        return {f: conv(getattr(rec, f)).T if getattr(rec, f).shape[0] == 3
                else conv(getattr(rec, f))[0] for f in rec._fields}
    _hold(rows(ours, lambda x: x.numpy()), rows(ref, np.asarray),
          hit_flip=5e-3, same_idx=0.995, t_tol=(2e-3, 2e-3), n_atol=(0, 5e-2))
