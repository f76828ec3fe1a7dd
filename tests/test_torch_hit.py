"""PyTorch port: the plain sphere sweep (kernel A's reference) against the
JAX package's exact sweep and its v6 Pallas kernel (interpret mode).

Kernel A itself (CUDA) is held against this plain sweep on the card by
chip_smoke.py phase 2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu.kernels.hit_pallas_v6 import hit_spheres_pallas_v6
from win32_raytracer_tpu.ops.hit import hit_spheres as jax_hit_spheres
from win32_raytracer_tpu.ops.rows import hit_rows_adapter as jax_adapter
from win32_raytracer_tpu.scene.builders import random_scene as jax_random_scene
from win32_raytracer_tpu_torch.kernels import hit as K
from win32_raytracer_tpu_torch.ops.hit import sphere_table
from win32_raytracer_tpu_torch.scene.builders import random_scene

torch.set_num_threads(1)


def _rays(n, seed=0):
    """Rays above the ground, from the camera region and from inside the
    glass spheres; shutter times over the whole motion interval."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-11, 0.01, -11], [11, 3, 11], (n, 3))
    o[: n // 4] = np.array([15.0, 2.0, 4.0]) + rng.normal(0, 0.3, (n // 4, 3))
    o[n // 4: n // 4 + 16] = [0.0, 1.0, 0.0]    # inside the big glass sphere
    d = rng.normal(0, 1, (n, 3))
    t = rng.uniform(0, 1, n)
    return (o.T.astype(np.float32).copy(), d.T.astype(np.float32).copy(),
            t[None].astype(np.float32))


def _port(o, d, t):
    return K.hit_spheres_rows_plain(sphere_table(random_scene()),
                                    *(torch.from_numpy(x) for x in (o, d, t)))


def _root_f64(o, d, t, scene, idx):
    """The winning sphere's near root in float64, and the size of the
    terms the f32 formula rounds: |b| plus (b^2 + a|oc|^2 + a r^2) over
    sqrt(disc), over a.  An f32 evaluation of ops/hit.py's formula is off
    the root by about one f32 epsilon times that scale."""
    c1 = np.asarray(scene.center1, np.float64)
    dc = np.asarray(scene.center2, np.float64) - c1
    t1 = np.asarray(scene.t1, np.float64)
    inv_dt = 1.0 / (np.asarray(scene.t2, np.float64) - t1)
    r = np.asarray(scene.radius, np.float64)[idx]
    lerp = (t[0].astype(np.float64) - t1[idx]) * inv_dt[idx]
    oc = o.T.astype(np.float64) - (c1[idx] + dc[idx] * lerp[:, None])
    dd = d.T.astype(np.float64)
    a = (dd * dd).sum(1)
    b = (dd * oc).sum(1)
    oc2 = (oc * oc).sum(1)
    sq = np.sqrt(np.maximum(b * b - a * (oc2 - r * r), 0.0))
    scale = (np.abs(b) + (b * b + a * oc2 + a * r * r) / np.maximum(sq, 1e-30)) / a
    return (-b - sq) / a, scale


def test_plain_hit_matches_reference_sweep():
    """Same winners as the reference sweep, and t, point and normal within
    rtol 1e-5 plus the f32 rounding bound of the root formula.  XLA's CPU
    code rounds the formula differently from plain f32 ops, and where the
    root is ill conditioned (the r=1000 ground sphere: |oc|^2 ~ 1e6
    cancels to ~1e3) the two differ by up to ~1e-3 relative.  Both stay
    within 1.2 epsilon x scale of the float64 root (measured); the test
    holds both to 4."""
    o, d, t = _rays(4096)
    ours = _port(o, d, t)
    jscene = jax_random_scene()
    ref = jax_adapter(jax_hit_spheres)(jscene, jnp.asarray(o),
                                       jnp.asarray(d), jnp.asarray(t))
    hit_t, hit_j = ours.hit.numpy()[0], np.asarray(ref.hit)[0]
    idx_t, idx_j = ours.idx.numpy()[0], np.asarray(ref.idx)[0]
    assert 0.2 < hit_t.mean() < 0.95
    assert (hit_t == hit_j).mean() >= 0.999
    assert (idx_t == idx_j).mean() >= 0.999
    agree = (idx_t == idx_j) & hit_t & hit_j
    root, scale = _root_f64(o, d, t, jscene, idx_t)
    bound = 4 * 2.0 ** -24 * scale                  # on t
    t_t, t_j = ours.t.numpy()[0], np.asarray(ref.t)[0]
    for got in (t_t, t_j):
        assert (np.abs(got - root) <= bound)[agree].all()
    dlen = np.linalg.norm(d, axis=0)
    radius = np.abs(np.asarray(jscene.radius))[idx_t]
    for f, extra in (("t", 2 * bound), ("point", 2 * bound * dlen),
                     ("normal", 2 * bound * dlen / radius)):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        tol = 1e-5 * np.abs(b) + 1e-6 + extra
        assert (np.abs(a - b) <= tol)[:, agree].all(), f
    for f in ("albedo", "fuzz", "ior", "mat_id"):
        np.testing.assert_array_equal(getattr(ours, f).numpy()[:, agree],
                                      np.asarray(getattr(ref, f))[:, agree])


def test_plain_hit_matches_v6_kernel_interpret():
    """v6's split-bf16 quadratic flips winners at ~1e-4; bound 1%."""
    o, d, t = _rays(1024, seed=1)
    ours = _port(o, d, t)
    ref = hit_spheres_pallas_v6(jax_random_scene(), jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(t),
                                ray_block=1024, n_terms=6, interpret=True)
    assert (ours.hit.numpy() != np.asarray(ref.hit)).mean() < 0.01
    assert (ours.idx.numpy() != np.asarray(ref.idx)).mean() < 0.01


def test_wrapper_on_cpu_is_the_plain_sweep():
    o, d, t = (torch.from_numpy(x) for x in _rays(512, seed=2))
    tab = sphere_table(random_scene())
    before = K.LAUNCHES
    a = K.hit_spheres_rows(tab, o, d, t)
    b = K.hit_spheres_rows_plain(tab, o, d, t)
    assert K.LAUNCHES == before   # nothing launched for CPU tensors
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrapper_rejects_other_devices():
    o, d, t = (torch.from_numpy(x).to("meta") for x in _rays(64, seed=3))
    with pytest.raises(ValueError, match="unsupported device"):
        K.hit_spheres_rows(sphere_table(random_scene()), o, d, t)


def test_no_hit_record_is_zero():
    """Misses carry the 1e30 sentinel and all-zero attributes (idx 0),
    like the reference's zero-initialized winner row."""
    o = np.array([[0.0], [5000.0], [0.0]], np.float32)
    d = np.array([[0.0], [1.0], [0.0]], np.float32)
    rec = _port(o, d, np.zeros((1, 1), np.float32))
    assert not rec.hit.item()
    assert rec.t.item() == np.float32(1e30)
    assert rec.idx.item() == 0 and rec.mat_id.item() == 0
    np.testing.assert_array_equal(rec.normal.numpy()[:, 0], o[:, 0])
