"""The benchmark's configuration ``mesh`` (the port's ``mesh`` scene, 332
triangles, on the brute triangle sweep) against the port and the plain
reference on the CPU: its scene arrays equal the port's builder, the port
routes it to the brute composite (kernel C on every triangle, uncapped),
and a small render through the harness's own program (``run.Program``)
agrees with ``port_bench/reference/render.py`` at the cell
``mesh.finished``'s limits.  The fault the limits catch is in
``test_torch_mesh_brute_fault.py``.  This file imports no JAX."""

from __future__ import annotations

import numpy as np
import torch

from port_bench import cells, compare
from port_bench.run import Program
from port_bench.scenes import mesh
from port_bench.traffic import Traffic
from win32_raytracer_tpu_torch.config import RenderConfig
from win32_raytracer_tpu_torch.kernels import dispatch
from win32_raytracer_tpu_torch.ops.hit_tri import TriTable
from win32_raytracer_tpu_torch.scene.builders import get_scene
from win32_raytracer_tpu_torch.scene.composite import CompositeScene
from win32_raytracer_tpu_torch.tri_accel import build_tri_grid

torch.set_num_threads(1)

CELL = "mesh.finished"
SMALL = {"width": 96, "height": 64, "spp": 16}
# At SMALL, ``noise_excess`` of sound images spreads by about +-0.12
# (fireflies through the glass box and off the metal icosphere): over ten
# seeds the reference against itself read -0.05 to 0.12 and the port -0.11
# to 0.15, so one seed is fixed here and the full-size runs on the card
# are where that limit is tight; ``z_max`` reads 1.8-3.1 against 15.
SEED = 1


def numbers(size, seed):
    """The port's first call of the cell at ``size``, against two
    reference images of the same camera, size and samples."""
    cell = cells.workload(CELL)
    config = cells.config(cell["config"])
    assert cells.render_settings(config) == {}
    traffic = Traffic(cell["params"] | size, config, seed)
    prog = Program(cell, config, traffic, torch.device("cpu"), None)
    (got,) = prog.call(0)
    ref, kw = cells.reference(config), cells.followed(config)
    scene = ref.RefScene(prog.arrays, "cpu")
    size = (traffic.width, traffic.height, traffic.spp, traffic.max_depth)
    r1, r2 = (ref.render(scene, traffic.cameras(0), *size,
                         seed=traffic.seed(0) * 2 + k, **kw)[0]
              for k in (1, 2))
    return compare.image_numbers(got, r1, r2), cell["compare"]["limits"]


def test_scene_arrays_equal_the_ports():
    ours, theirs = mesh.build(), get_scene("mesh")
    for kind in ("spheres", "triangles"):
        for k, v in ours[kind].items():
            port = getattr(getattr(theirs, kind), k).numpy()
            assert np.array_equal(v, port), (kind, k)
    assert int(ours["spheres"]["active"].sum()) == 3
    assert int(ours["triangles"]["active"].sum()) == 332


def test_the_port_takes_the_brute_composite(monkeypatch):
    """No triangle grid for 332 triangles, so the default configuration
    hands every lane to kernel C's entry, with no ``t_cap`` from the
    sphere pass."""
    scene = get_scene("mesh")
    assert build_tri_grid(scene.triangles) is None
    hit_scene, hit_fn = dispatch.get_hit_fn_rows_accel(RenderConfig(), scene)
    assert isinstance(hit_scene, CompositeScene)
    assert isinstance(hit_scene.triangles, TriTable)
    seen = []
    real = dispatch.hit_triangles_rows

    def spy(tris, o, d, t, **k):
        seen.append((o.shape[1], sorted(k)))
        return real(tris, o, d, t, **k)
    monkeypatch.setattr(dispatch, "hit_triangles_rows", spy)
    _, hit_fn = dispatch.get_hit_fn_rows_accel(RenderConfig(), scene)
    g = torch.Generator().manual_seed(3)
    o = torch.tensor([[13.0], [2.0], [3.0]]).expand(3, 64).contiguous()
    d = torch.randn(3, 64, generator=g) * 0.1 - o / 13.0
    hit_fn(hit_scene, o, d, torch.zeros(1, 64))
    assert seen == [(64, ["min_t"])]


def test_mesh_render_agrees_with_the_reference():
    got, limits = numbers(SMALL, SEED)
    assert compare.judge(got, limits), got
