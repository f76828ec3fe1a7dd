"""PyTorch port: whole mesh renders through the brute triangle sweep
against the JAX package (the grid route: test_torch_tri_grid_render.py).

Both packages draw from the same counters and schedule the same lanes, so
on the CPU the port's images match the reference's nearly pixel for pixel.
The routes: ``mesh`` (332 triangles) takes the brute sweep on both sides
at their default knobs; ``accel="off"`` forces it on
``mesh_scene(subdivisions=3)`` (1,292 triangles).  Modes as
tests/test_torch_render.py: "one-shot" keeps the compaction floor,
"compaction" patches the floor to 0 with 8 lanes per pixel.  Bounds are
about 2x the values measured when the test was written (mean |diff| in u8,
Pearson r; seed 5, 48x32, 8 spp): mesh 0.0 / 1.0 in both modes; off
one-shot 0.0 / 1.0, off compaction 0.0026 / 0.999997 (XLA's CPU code fuses
a multiply and an add of the camera ray into one rounding where torch
rounds twice, and a path or two takes another turn)."""

import numpy as np
import pytest
import torch

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.api import render as jax_render
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.api import render
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

torch.set_num_threads(1)


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


# route -> (port scene, port knobs, JAX scene, JAX knobs)
ROUTES = {
    "mesh": (lambda: "mesh", {}, lambda: "mesh", {}),
    # The reference's scene arrays, carried across.
    "off": (lambda: scene_from_numpy(jb.mesh_scene(subdivisions=3)),
            dict(accel="off"), lambda: jb.mesh_scene(subdivisions=3),
            dict(accel="off")),
}

# (route, mode) -> (max mean |diff|, min pearson r)
BOUNDS = {
    ("mesh", "one-shot"): (0.01, 0.99999),
    ("mesh", "compaction"): (0.01, 0.99999),
    ("off", "one-shot"): (0.01, 0.99999),
    ("off", "compaction"): (0.006, 0.99999),
}


def render_both(route, mode, routes, monkeypatch):
    """(port image, reference image, bin sorts the port ran) at 48x32,
    8 spp, seed 5."""
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
    ours_scene, ours_kw, ref_scene, ref_kw = routes[route]
    ref = jax_render(ref_scene(), cfg=JC(**kw, **ref_kw)).image
    res = render(ours_scene(), cfg=TC(**kw, **ours_kw), device="cpu")
    assert res.image.shape == (32, 48, 3)
    return res.image, ref, len(sorts)


@pytest.mark.parametrize("route,mode", sorted(BOUNDS))
def test_mesh_render_matches_reference(route, mode, monkeypatch):
    ours, ref, sorts = render_both(route, mode, ROUTES, monkeypatch)
    assert sorts == 0
    d, r = _stats(ours, ref)
    max_d, min_r = BOUNDS[(route, mode)]
    assert d <= max_d and r >= min_r, (d, r)
