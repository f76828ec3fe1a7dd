"""PyTorch port: renders through the sphere grid (``accel="grid"``) and an
explicit ``hit_fn`` on the persistent scheduler, against the JAX package.

The grid's hit equals the brute sweep's in the port (the same f32 pair
test; tiles keep ascending index order), so a grid render equals the brute
render exactly.  Against the JAX package the paths diverge where XLA's CPU
code rounds a fused multiply-add once and torch twice (the camera ray's
lens offset, the ground sphere's root; ROADMAP Queue 3): bounds are about
2x the values measured when the test was written (random scene, 48x32,
4 spp, seed 7: u8 mean |diff| 0.161, linear means 0.52731 / 0.52727, 99.48%
of linear values within rtol 1e-3, atol 2e-3).  The hit_fn render is held
to the reference's own test's bounds (test_hit_pallas.py: under 1% of
pixels off by more than 2, mean |diff| under 0.5; measured 0.56% and
0.056).
"""

import functools

import numpy as np
import pytest
import torch

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.accel import build_grid_accel as jax_build
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.kernels.experimental.hit_pallas_v1 import hit_spheres_pallas as jax_v1
from win32_raytracer_tpu.kernels.hit_grid_rows import hit_spheres_grid_rows as jax_grid_rows
from win32_raytracer_tpu.render import render as jax_render
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu_torch import cli
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.accel import GridScene, hit_spheres_grid_rows_plain
from win32_raytracer_tpu_torch.animation import orbit_path, render_animation
from win32_raytracer_tpu_torch.api import render
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.io.image import read_image
from win32_raytracer_tpu_torch.kernels import dispatch as D
from win32_raytracer_tpu_torch.kernels import hit_grid as KI
from win32_raytracer_tpu_torch.kernels.experimental.hit_pallas_v1 import hit_spheres_pallas
from win32_raytracer_tpu_torch.render import render as render_scene
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

torch.set_num_threads(1)

SMALL = dict(width=48, height=32, samples=4, seed=7, scheduler="persistent")


def _u8(x):
    return np.clip(np.floor(255.99 * np.sqrt(np.maximum(x, 0.0))), 0, 255)


def test_grid_render_matches_reference():
    js = jb.random_scene()
    ref = np.asarray(JP.render_image_persistent(
        jax_build(js, time_hi=0.05), None, JC(**SMALL),
        hit_fn=functools.partial(jax_grid_rows, interpret=True)))
    ours = TP.render_image_persistent(scene_from_numpy(js), None,
                                      TC(accel="grid", **SMALL)).numpy()
    assert ours.shape == ref.shape == (32, 48, 3)
    assert np.abs(_u8(ours) - _u8(ref)).mean() <= 0.33
    np.testing.assert_allclose(ours.mean(), ref.mean(), rtol=2e-3)
    assert np.isclose(ours, ref, rtol=1e-3, atol=2e-3).mean() >= 0.99


@pytest.mark.parametrize("mode", ["one-shot", "compaction"])
def test_grid_render_equals_brute(mode, monkeypatch):
    """The one-shot tail and, with the floor at 0 and 8 lanes per pixel,
    bounces above the floor (the split route: the grid has neither kernel
    B nor kernel E)."""
    kw = dict(SMALL)
    if mode == "compaction":
        kw.update(samples=8, lanes_per_pixel=8)
        monkeypatch.setattr(TP, "_COMPACT_FLOOR", 0)
    scene = tb.random_scene()
    grid = TP.render_image_persistent(scene, None, TC(accel="grid", **kw))
    brute = TP.render_image_persistent(scene, None, TC(**kw))
    assert torch.equal(grid, brute)


def test_bin_box_matches_reference():
    """ray_binning="on" bins the sphere grid on its tiles' (x, z) span and
    y slab, as the reference does; "auto" keeps the lane order."""
    js = jb.get_scene("final")
    jg = jax_build(js, time_hi=0.05)
    tg, _ = D.get_hit_fn_rows_accel(TC(accel="grid"), scene_from_numpy(js))
    assert isinstance(tg, GridScene)
    box = TP._derive_bin_box(TC(ray_binning="on"), tg)
    assert box is not None and box == JP._derive_bin_box(JC(ray_binning="on"), jg)
    assert TP._derive_bin_box(TC(), tg) is None
    assert JP._derive_bin_box(JC(), jg) is None


def test_binned_grid_render(monkeypatch):
    sorts = []
    real = TP._bin_sort_core

    def spy(*a, **k):
        sorts.append(1)
        return real(*a, **k)
    monkeypatch.setattr(TP, "_bin_sort_core", spy)
    scene = tb.random_scene()
    binned = render(scene, cfg=TC(accel="grid", ray_binning="on", **SMALL),
                    device="cpu").image
    assert sorts, "the binned loop did not run"
    plain = render(scene, cfg=TC(accel="grid", **SMALL), device="cpu").image
    # Binning reorders the lanes and with them the draws: statistically equal.
    assert abs(binned.mean() - plain.mean()) < 2.0


def test_render_hit_fn_on_the_persistent_scheduler():
    """render(hit_fn=<column hit function>) adapts it to rows
    (ops/rows.hit_rows_adapter), as the reference does; through the v1
    adapter (kernel G's wrapper) it equals the default route's image and
    matches the reference's render through its v1 kernel."""
    js = jb.random_scene()
    ts = scene_from_numpy(js)
    kw = dict(width=48, height=32, samples=8, seed=5)
    ours = render_scene(ts, None, TC(**kw), hit_fn=hit_spheres_pallas)
    assert np.array_equal(ours, render_scene(ts, None, TC(**kw)))
    ref = jax_render(js, cfg=JC(**kw), hit_fn=functools.partial(
        jax_v1, ray_block=128, interpret=True))
    diff = np.abs(ours.astype(int) - np.asarray(ref).astype(int))
    assert (diff > 2).mean() < 0.01 and diff.mean() < 0.5


def test_render_animation_with_the_grid():
    """Frame batches build the grid for the first camera, frame by frame
    renders build it per frame; both equal the brute animation."""
    scene = tb.random_scene()
    cams = orbit_path(n_frames=2, aspect_ratio=24 / 16)
    cfg = TC(width=24, height=16, samples=8, seed=3)
    for batch in (2, 1):
        grid = render_animation(scene, cams, cfg.replace(accel="grid"),
                                batch_frames=batch, device="cpu")
        brute = render_animation(scene, cams, cfg, batch_frames=batch,
                                 device="cpu")
        assert len(grid) == 2
        for g, b in zip(grid, brute):
            np.testing.assert_array_equal(g, b)


def test_cli_accel_grid(tmp_path):
    out = tmp_path / "grid.bmp"
    rc = cli.main(["32", "24", "8", "--scene", "random", "--accel", "grid",
                   "--platform", "cpu", "--out", str(out), "--quiet"])
    assert rc == 0
    want = render("random", cfg=TC(width=32, height=24, samples=8,
                                   accel="grid"), device="cpu").image
    np.testing.assert_array_equal(read_image(str(out)), want)
    with pytest.raises(ValueError, match="does not qualify"):
        cli.main(["32", "24", "8", "--scene", "test", "--accel", "grid",
                  "--platform", "cpu", "--out", str(out), "--quiet"])


def test_grid_routes():
    """The grid route resolves to kernel I's wrapper ("auto"; its plain
    version on the CPU) or its plain sweep ("jnp"), each under the thin
    pass that counts and spans it while a render records; a GridScene
    takes the split bounce, so fuse_bounce="on" raises as in the
    reference; a scene that does not qualify raises the reference's
    ValueError; "auto" never picks the sphere grid."""
    scene = tb.get_scene("final")
    g, fn = D.get_hit_fn_rows_accel(TC(accel="grid"), scene)
    assert isinstance(g, GridScene)
    assert fn.__wrapped__ is KI.hit_spheres_grid_rows
    _, fn = D.get_hit_fn_rows_accel(TC(accel="grid", backend="jnp"), scene)
    assert fn.__wrapped__ is hit_spheres_grid_rows_plain
    assert not isinstance(D.get_hit_fn_rows_accel(TC(), scene)[0], GridScene)
    routes = TP.resolve_routes(TC(accel="grid"), g, "cpu", h_virt=8, kpp=1,
                               bin_box=None)
    assert routes.fused is None and routes.hit_sky is None
    with pytest.raises(ValueError, match="fuse_bounce='on'"):
        render(scene, cfg=TC(accel="grid", fuse_bounce="on", **SMALL),
               device="cpu")
    with pytest.raises(ValueError, match="does not qualify"):
        D.get_hit_fn_rows_accel(TC(accel="grid"), tb.get_scene("test"))
