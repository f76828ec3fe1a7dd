"""The scene arrays and cameras the benchmark makes itself equal the
port's own builders (imported here, in the test, only)."""

from __future__ import annotations

import math

import numpy as np
import pytest

from port_bench.scenes import camera, final, mesh20k


@pytest.mark.parametrize("name,mod", [("final", final), ("mesh20k", mesh20k)])
def test_scene_arrays_equal_the_ports(name, mod):
    from win32_raytracer_tpu_torch.scene.builders import get_scene
    ours, theirs = mod.build(), get_scene(name)
    spheres = theirs if name == "final" else theirs.spheres
    for k, v in ours["spheres"].items():
        assert np.array_equal(v, getattr(spheres, k).numpy()), k
    if name == "mesh20k":
        for k, v in ours["triangles"].items():
            assert np.array_equal(v, getattr(theirs.triangles, k).numpy()), k
    else:
        assert ours["triangles"] is None
    assert int(ours["spheres"]["active"].sum()) == (488 if name == "final" else 3)


def test_reference_view_equals_the_ports():
    from win32_raytracer_tpu_torch.scene.camera import default_camera
    ours, theirs = camera.reference_view(1200 / 800), default_camera(1200, 800)
    for f in camera.FIELDS:
        assert np.array_equal(ours[f], getattr(theirs, f).numpy()), f


def test_orbit_equals_the_ports():
    from win32_raytracer_tpu_torch.animation import orbit_path
    theirs = orbit_path(n_frames=8, aspect_ratio=640 / 480)
    for i, cam in enumerate(theirs):
        ours = camera.orbit_view(2 * math.pi * i / 8, 640 / 480, 16.0, 2.0)
        for f in camera.FIELDS:
            assert np.array_equal(ours[f], getattr(cam, f).numpy()), (i, f)


def test_traffic_seeds_are_distinct_and_repeat():
    from port_bench import cells
    from port_bench.traffic import Traffic
    cell = cells.workload("final.preview")
    config = cells.config(cell["config"])
    a = Traffic(cell["params"], config, 2 ** 31 + 5)
    b = Traffic(cell["params"], config, 2 ** 31 + 5)
    seeds = [a.seed(i) for i in range(-1, 5000)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2 ** 31 for s in seeds)
    assert seeds == [b.seed(i) for i in range(-1, 5000)]
    assert a.cameras(3)[0]["origin"].tolist() == b.cameras(3)[0]["origin"].tolist()
    c = Traffic(cell["params"], config, 7)
    assert a.cameras(0)[0]["origin"].tolist() != c.cameras(0)[0]["origin"].tolist()
