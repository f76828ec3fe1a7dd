"""PyTorch port: mesh renders through the Morton-tile grid and ray binning,
and the binning steps, against the JAX package.

``mesh_scene(subdivisions=3)`` (1,292 triangles) takes the grid and ray
binning in the port at its default knobs, and in the JAX package with
``accel="grid"`` (on the CPU it builds the grid only when asked).  Binning
sorts the lanes by a key of their rays' cells, so a last-place difference
in a ray can move a lane, and with it the draws of every lane it passes:
XLA's CPU code fuses the camera ray's lens offset into one rounding where
torch rounds twice (4 of 4,096 first rays differ in the last place).
Bounds are about 2x the values measured when the test was written (mean
|diff| in u8, Pearson r; seed 5, 48x32, 8 spp): one-shot 0.0621 /
0.99977 (12 of 1,536 pixels differ), compaction 0.0065 / 0.999996."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu import tri_accel as jacc
from win32_raytracer_tpu.api import render as jax_render
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.api import render
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.kernels.dispatch import get_hit_fn_rows_accel
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

torch.set_num_threads(1)

# mode -> (max mean |diff|, min pearson r)
BOUNDS = {"one-shot": (0.13, 0.9995), "compaction": (0.015, 0.99999)}


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


@pytest.mark.parametrize("mode", sorted(BOUNDS))
def test_grid_render_matches_reference(mode, monkeypatch):
    kw = dict(width=48, height=32, samples=8, seed=5)
    if mode == "compaction":
        kw["lanes_per_pixel"] = 8
        monkeypatch.setattr(JP, "_COMPACT_FLOOR", 0)
        monkeypatch.setattr(TP, "_COMPACT_FLOOR", 0)
    sorts = []
    real = TP._bin_sort_core

    def spy(*a, **k):
        sorts.append(1)
        return real(*a, **k)
    monkeypatch.setattr(TP, "_bin_sort_core", spy)
    scene = jb.mesh_scene(subdivisions=3)
    ref = jax_render(scene, cfg=JC(accel="grid", **kw)).image
    # The same scene arrays in both packages.
    ours = render(scene_from_numpy(scene), cfg=TC(**kw), device="cpu").image
    assert sorts, "the binned loop did not run"
    d, r = _stats(ours, ref)
    max_d, min_r = BOUNDS[mode]
    assert d <= max_d and r >= min_r, (d, r)


def _hit_scenes():
    """(port hit scene with its grid, the reference's composite with its
    grid) of mesh_scene(subdivisions=3)."""
    ours, _ = get_hit_fn_rows_accel(TC(), tb.mesh_scene(subdivisions=3))
    js = jb.mesh_scene(subdivisions=3)
    return ours, js._replace(triangles=jacc.build_tri_grid(js.triangles))


def test_derive_bin_box_matches_reference():
    ours, ref = _hit_scenes()
    box = TP._derive_bin_box(TC(), ours)
    assert box == JP._derive_bin_box(JC(), ref)
    assert box == TP._derive_bin_box(TC(ray_binning="on"), ours)
    assert TP._derive_bin_box(TC(ray_binning="off"), ours) is None
    brute, _ = get_hit_fn_rows_accel(TC(), tb.mesh_scene())
    assert TP._derive_bin_box(TC(), brute) is None
    with pytest.raises(ValueError, match="grid-accelerated"):
        TP._derive_bin_box(TC(ray_binning="on"), brute)


def test_bin_sort_matches_reference():
    """The same permutation and parked rays as the reference's sort, on a
    random state whose rays start in and around the grid's box."""
    ours_scene, _ = _hit_scenes()
    box = TP._derive_bin_box(TC(), ours_scene)
    n = 8192
    rng = np.random.default_rng(21)
    arr = dict(
        origin=rng.uniform([-2, -0.5, -2], [2, 2.5, 3.5], (n, 3)).T.astype(np.float32),
        direction=rng.normal(size=(3, n)).astype(np.float32),
        time=rng.uniform(0, 0.05, (1, n)).astype(np.float32),
        throughput=rng.uniform(size=(3, n)).astype(np.float32),
        radiance_sum=rng.uniform(size=(3, n)).astype(np.float32),
        depth=rng.integers(0, 5, (1, n)).astype(np.int32),
        sample=rng.integers(0, 3, (1, n)).astype(np.int32),
        pixel=rng.permutation(n)[None].astype(np.int32),
        path_alive=rng.uniform(size=(1, n)) < 0.7,
        s_base=rng.integers(0, 8, (1, n)).astype(np.int32),
        s_quota=np.full((1, n), 4, np.int32))
    arr["direction"][:, :64] = 0.0       # near-zero components take +-eps
    arr["direction"][1, :64] = 1.0
    ours = TP._bin_sort_core(
        TP.PathState(**{k: torch.from_numpy(v.copy()) for k, v in arr.items()}),
        box=box)
    ref = JP._bin_sort(
        JP.PathState(**{k: jnp.asarray(v) for k, v in arr.items()}),
        box=box, key_variant="pos4+exit4+oct")
    for f in TP.PathState._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    alive = ours.path_alive.numpy()[0]
    assert not alive[int(alive.sum()):].any()       # dead lanes sort last
    assert (ours.origin.numpy()[1, ~alive] == np.float32(-1e9)).all()
