"""The plain reference against the port on the CPU at tiny sizes, and the
control (the reference in bfloat16) failing the cells' limits."""

from __future__ import annotations

import types

import pytest
import torch

from port_bench import cells, compare
from port_bench.reference import render as ref
from port_bench.scenes import camera

from .conftest import TINY_LIMITS


def _port_render(arrays, cam, w, h, spp, seed):
    from win32_raytracer_tpu_torch.api import render
    from win32_raytracer_tpu_torch.config import RenderConfig
    from win32_raytracer_tpu_torch.scene.camera import camera_from_numpy
    from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy
    sp = types.SimpleNamespace(**arrays["spheres"])
    src = sp if arrays["triangles"] is None else types.SimpleNamespace(
        spheres=sp, triangles=types.SimpleNamespace(**arrays["triangles"]))
    cfg = RenderConfig(width=w, height=h, samples=spp, seed=seed)
    return render(scene_from_numpy(src), camera_from_numpy(camera.as_object(cam)),
                  cfg, device="cpu").image


@pytest.mark.parametrize("scene,size,spp", [("final", (96, 64), 8),
                                            ("final", (48, 32), 4),
                                            ("mesh20k", (96, 54), 8)])
def test_reference_agrees_with_the_port(scene, size, spp):
    arrays = cells.scene(scene)
    w, h = size
    cam = camera.reference_view(w / h)
    got = _port_render(arrays, cam, w, h, spp, seed=11)
    rs = ref.RefScene(arrays, "cpu")
    r1, r2 = (ref.render(rs, [cam], w, h, spp, 10, seed=s)[0] for s in (1, 2))
    numbers = compare.image_numbers(got, r1, r2)
    assert compare.judge(numbers, TINY_LIMITS), numbers


@pytest.mark.parametrize("cell", ["final.finished", "mesh20k.finished",
                                  "final.preview"])
def test_control_fails_the_cells_limits(cell):
    """The reference in bfloat16 in the port's place, at a tiny size,
    fails every cell's limits."""
    c = cells.workload(cell)
    arrays = cells.scene(cells.config(c["config"])["scene"])
    cam = camera.reference_view(1.5)
    f32 = ref.RefScene(arrays, "cpu")
    low = ref.RefScene(arrays, "cpu", torch.bfloat16)
    r1, r2 = (ref.render(f32, [cam], 48, 32, 8, 10, seed=s)[0] for s in (1, 2))
    alt = ref.render(low, [cam], 48, 32, 8, 10, seed=3)[0]
    numbers = compare.image_numbers(alt, r1, r2)
    assert not compare.judge(numbers, c["compare"]["limits"]), numbers
    assert not compare.judge(numbers, TINY_LIMITS), numbers


def test_segments_are_counted():
    arrays = cells.scene("final")
    stats = {}
    ref.render(ref.RefScene(arrays, "cpu"), [camera.reference_view(1.5)],
               24, 16, 4, 10, seed=5, stats=stats)
    assert stats["primary"] == 24 * 16 * 4
    assert 1.0 <= stats["segments"] / stats["primary"] <= 11.0
