"""PyTorch port: scene builders and camera against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu.scene import camera as jcam
from win32_raytracer_tpu.scene.spheres import SceneBuilder as JaxBuilder
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene import camera as tcam
from win32_raytracer_tpu_torch.scene.spheres import (
    SceneBuilder, SphereScene, scene_from_numpy)

torch.set_num_threads(1)


def _assert_scene_equal(ours: SphereScene, ref):
    for f in SphereScene._fields:
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", ["test", "final"])
def test_builders_array_equal(name):
    _assert_scene_equal(tb.get_scene(name), jb.get_scene(name))


def test_mesh_scenes_not_ported():
    """The mesh scenes build now (tests/test_torch_tri_scene.py holds them
    to the reference); what their path still lacks, the reference's
    working-set rebin, raises naming ROADMAP Queue 1 item 9."""
    from win32_raytracer_tpu_torch.config import RenderConfig
    from win32_raytracer_tpu_torch.persistent import check_supported
    scene = tb.get_scene("mesh20k")
    assert scene.triangles.padded_size == 20608
    with pytest.raises(NotImplementedError, match="item 9"):
        check_supported(RenderConfig(tri_rebin="on"), scene)


def test_scene_from_numpy_round_trip():
    jbld, tbld = JaxBuilder(), SceneBuilder()
    for b in (jbld, tbld):
        b.add_lambertian((0.0, -50.0, 0.0), 50.0, (0.3, 0.4, 0.5))
        b.add_moving((1.0, 0.2, 0.0), (1.0, 0.9, 0.0), 0.0, 0.5, 0.2, 0,
                     albedo=(0.9, 0.1, 0.1))
        b.add_metal((2.0, 0.5, 1.0), -0.3, (0.7, 0.7, 0.7), 0.25)
        b.add_dielectric((-1.0, 0.5, 0.0), 0.5, 1.33)
    ref = jbld.build(pad_to=64)
    ours = scene_from_numpy(ref)
    _assert_scene_equal(ours, ref)
    _assert_scene_equal(tbld.build(pad_to=64), ref)
    assert ours.padded_size == 64


def _simple_cam(mod, aperture=0.0):
    return mod.make_camera((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0),
                           90.0, 2.0, aperture, 1.0)


def test_camera_corners_match_reference_values():
    """The hand-computed corners of tests/test_camera.py."""
    cam = _simple_cam(tcam)
    for f, want in (("origin", [0, 0, 0]), ("right_axis", [1, 0, 0]),
                    ("up_axis", [0, 1, 0]),
                    ("lower_left_corner", [-2, -1, -1]),
                    ("horizontal", [4, 0, 0]), ("vertical", [0, 2, 0])):
        np.testing.assert_allclose(getattr(cam, f).numpy(), want, rtol=1e-6,
                                   atol=1e-6)
    u = torch.tensor([0.0, 1.0, 0.5])
    v = torch.tensor([0.0, 1.0, 0.5])
    o, d, t = tcam.camera_rays(cam, u, v, torch.full((3, 3), 0.5))
    np.testing.assert_allclose(d.numpy(), [[-2, -1, -1], [2, 1, -1],
                                           [0, 0, -1]], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.zeros((3, 3)), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), [0.025] * 3, rtol=1e-6)


@pytest.mark.parametrize("size", [(640, 480), (1200, 800), (48, 32)])
def test_default_camera_matches_reference(size):
    ours, ref = tcam.default_camera(*size), jcam.default_camera(*size)
    for f in tcam.Camera._fields:
        np.testing.assert_allclose(getattr(ours, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6)
    back = tcam.camera_from_numpy(ref)
    for f in tcam.Camera._fields:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(ref, f)))


def test_camera_rays_match_reference_with_lens():
    cam_t = _simple_cam(tcam, aperture=2.0)
    cam_j = _simple_cam(jcam, aperture=2.0)
    rng = np.random.default_rng(2)
    u, v = rng.uniform(0, 1, (2, 500)).astype(np.float32)
    draws = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    ours = tcam.camera_rays(cam_t, torch.from_numpy(u), torch.from_numpy(v),
                            torch.from_numpy(draws))
    ref = jcam.camera_rays(cam_j, jnp.asarray(u), jnp.asarray(v),
                           jnp.asarray(draws))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
