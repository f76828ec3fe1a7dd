"""Probes planted underneath a run (``run.main(plant=...)``): each leaves
a line in a file of the run's directory when the port takes a path, for
the tests that see which path a configuration's render settings took."""

from __future__ import annotations

SPHERE_GRID = "sphere_grid_probe.txt"


def sphere_grid():
    """A line ``build <type>`` for each sphere grid the port builds for a
    render, and ``sweep`` for each call of the sphere grid's hit function
    (kernel I, or its plain version off the card)."""
    from win32_raytracer_tpu_torch.kernels import dispatch

    def mark(line):
        with open(SPHERE_GRID, "a") as f:
            f.write(line + "\n")

    build = dispatch.build_grid_accel

    def build_grid_accel(*a, **k):
        grid = build(*a, **k)
        if grid is not None:
            mark(f"build {type(grid).__name__}")
        return grid

    dispatch.build_grid_accel = build_grid_accel
    for name in ("hit_spheres_grid_rows", "hit_spheres_grid_rows_plain"):
        sweep = getattr(dispatch, name)

        def swept(*a, _sweep=sweep, **k):
            mark("sweep")
            return _sweep(*a, **k)

        setattr(dispatch, name, swept)
