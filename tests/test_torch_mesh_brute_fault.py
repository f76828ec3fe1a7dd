"""A fault in the brute triangle pass that the cell ``mesh.finished``'s
limits catch: kernel C's entry (its plain version on the CPU) loses the
glass box's 12 rows, so the box vanishes from the port's image.  The box
(0.7 wide, ~13 from the camera) must cover whole 16 x 16 blocks of
``compare.py`` for ``z_max`` to see it: ~22 pixels tall at 144 rows,
where ``z_max`` read 21.7-26.4 at 8 spp on two seeds; at 96 x 64, ~10
pixels, it read 10.6.  This file imports no JAX."""

from __future__ import annotations

import pytest
import torch

from win32_raytracer_tpu_torch.kernels import dispatch
from win32_raytracer_tpu_torch.ops.hit_tri import tri_table

from test_torch_mesh_brute_bench import numbers

torch.set_num_threads(1)

FAULT = {"width": 216, "height": 144, "spp": 8}
SEED = 2200000017
BOX_ROWS = slice(320, 332)      # after the icosphere's 320 triangles


@pytest.fixture
def threads():
    """Four threads for this render, the heaviest of the port's CPU tests
    (the plain brute sweep over 248,832 lanes; its result does not depend
    on the thread count, tests/test_torch_threads.py), then one again."""
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(1)


def test_dropped_box_fails_z_max(monkeypatch, threads):
    real = dispatch.hit_triangles_rows

    def drop_box(tris, o, d, t, **k):
        tab = tri_table(tris)
        active = tab.active.clone()
        active[BOX_ROWS] = False
        return real(tab._replace(active=active), o, d, t, **k)
    monkeypatch.setattr(dispatch, "hit_triangles_rows", drop_box)
    got, limits = numbers(FAULT, SEED)
    assert got["z_max"] > limits["z_max"], got
