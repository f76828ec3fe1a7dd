"""The configuration ``final_grid`` (the final scene through the sphere
grid) against the plain reference on the CPU at a small size, through the
harness's own program (``run.Program``: ``api.render`` with the
configuration's ``render`` map applied by ``cells.render_settings``), at
the cell ``final_grid.finished``'s limits; and a fault in the grid's hit
that the limits catch."""

from __future__ import annotations

import pytest
import torch

from port_bench import cells, compare
from port_bench.run import Program
from port_bench.traffic import Traffic

CELL = "final_grid.finished"
SMALL = {"width": 96, "height": 64, "spp": 16}
# The dropped tile's nearest sphere (at the image's edge, near the camera)
# must cover whole 16 x 16 blocks of compare.py for z_max to see it:
# ~27 pixels across at this height.  At SMALL it reads within a sound
# image's z_max, and at 192 x 128 about 13.
FAULT = {"width": 288, "height": 192, "spp": 16}
SEED = 2200000017


def last_tile_dropped(monkeypatch):
    """The grid's hit drops the last scheduled tile's rows: in each ray
    block's row of the tile mask, the highest tile id set is cleared
    before pass B (the plain sweep, which the port runs on the CPU)."""
    from win32_raytracer_tpu_torch import accel
    sweep = accel._sweep_tiles

    def _sweep_tiles(gscene, o, d, tm, mask, *a, **k):
        mask = mask.clone()
        ids = torch.arange(1, mask.shape[1] + 1, dtype=mask.dtype)
        last = (mask * ids).argmax(1)
        mask[torch.arange(mask.shape[0]), last] = 0
        return sweep(gscene, o, d, tm, mask, *a, **k)

    monkeypatch.setattr(accel, "_sweep_tiles", _sweep_tiles)


def _numbers(size=SMALL, seed=SEED):
    """The port's first call of the cell at ``size``, against two
    reference images of the same camera, size and samples."""
    cell = cells.workload(CELL)
    config = cells.config(cell["config"])
    assert cells.render_settings(config) == {"accel": "grid"}
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


def test_grid_render_agrees_with_the_reference():
    numbers, limits = _numbers()
    assert compare.judge(numbers, limits), numbers


def test_dropped_tile_fails_z_max(monkeypatch):
    last_tile_dropped(monkeypatch)
    numbers, limits = _numbers(FAULT)
    assert numbers["z_max"] > limits["z_max"], numbers
