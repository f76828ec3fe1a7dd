"""Kernel I: the sphere grid's pass B and merge (``csrc/hit_grid.cu``).

Replaces ``win32_raytracer_tpu/kernels/hit_grid_rows.py`` (``_grid_kernel_rows``
:98, through ``hit_spheres_grid_rows`` :215), the persistent scheduler's hit
under ``accel="grid"`` on a plain sphere scene, with its rows instance
(:func:`hit_spheres_grid_rows`); and
``win32_raytracer_tpu/kernels/experimental/hit_grid.py`` (``_grid_kernel``
:50, through ``hit_spheres_grid_pallas`` :160) with its column instance
(:func:`hit_spheres_grid_cols`).  Bound by the pair tests the block
schedule leaves (27 f32 operations each); a CTA takes a slice of one ray
block and stages each scheduled tile through shared memory (the source
note in csrc/hit_grid.cu has the detail).

The prelude stays torch ops, as it was XLA around the reference's kernel:
the rays padded to ``ray_block`` as the reference pads them, pass A over
the globals (kernel A in rows, kernel G in columns; their records are
written into the buffers kernel I then merges into), the footprint mask
and the block schedule (accel.py).  The plain versions
(accel.hit_spheres_grid_rows_plain, accel.hit_spheres_grid_plain) read the
same mask, so kernel and plain agree exactly on a card.

Both wrappers launch the kernel for CUDA tensors and run the plain version
for tensors on the CPU; they raise for anything else.  Each kernel I launch
comes with one launch of kernel A (or G) for pass A.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..accel import (
    DEFAULT_RAY_BLOCK_GRID, GRID_ATTR_COLS, GridScene, block_schedule,
    check_schedule_size, footprint_block_mask, footprint_block_mask_rows,
    glob_table, hit_spheres_grid_plain, hit_spheres_grid_rows_plain,
    pad_rays_cols, pad_rays_rows,
)
from ..config import MIN_HIT_T
from ..ops.hit import HitRecord
from ..ops.rows import HitRecordRows
from . import _build

LAUNCHES = 0  # kernel I launches by hit_spheres_grid_rows / _cols


class GridArgs(ctypes.Structure):  # csrc/hit_grid.cu GridArgs
    _fields_ = [
        ("origin", ctypes.c_void_p), ("direction", ctypes.c_void_p),
        ("time", ctypes.c_void_p), ("attrs", ctypes.c_void_p),
        ("sched", ctypes.c_void_p), ("out_f", ctypes.c_void_p),
        ("out_i", ctypes.c_void_p), ("out_hit", ctypes.c_void_p),
        ("stats", ctypes.c_void_p), ("n", ctypes.c_longlong),
        ("n_tiles", ctypes.c_int), ("st", ctypes.c_int),
        ("ray_block", ctypes.c_int), ("min_t", ctypes.c_float),
        ("stream", ctypes.c_void_p),
    ]


class Prepared(NamedTuple):
    """Kernel I's arguments and the tensors they point into (kept alive
    with them): the padded rays, the schedule, and pass A's record, which
    the kernel turns into the merged record of ``n`` lanes."""
    args: GridArgs
    cols: bool
    n: int
    rays: tuple
    sched: torch.Tensor
    rec: object


def _check(gscene: GridScene, origin, direction, time, stats, cols: bool):
    n = origin.shape[0] if cols else origin.shape[1]
    vec, scal = ((n, 3), (n,)) if cols else ((3, n), (1, n))
    checks = [(origin, "origin", torch.float32, vec),
              (direction, "direction", torch.float32, vec),
              (time, "time", torch.float32, scal),
              (gscene.tile_attrs, "tile_attrs", torch.float32,
               (gscene.n_tiles * gscene.tile_rows, GRID_ATTR_COLS))]
    if stats is not None:
        checks.append((stats, "stats", torch.int64, (2,)))
    for t, name, dt, shape in checks:
        _build.check_tensor(t, name, dt, shape, origin.device)


def prepare(gscene: GridScene, origin, direction, time, min_t: float,
            ray_block: int, cols: bool, stats=None) -> Prepared:
    """The wrapper's prelude (padding, pass A, mask, schedule) for rays
    already checked; :func:`launch` then runs kernel I on it (chip_smoke.py
    times the two apart)."""
    from . import hit as K
    from . import hit_cols as G

    glob = glob_table(gscene)
    if cols:
        o, d, tm = pad_rays_cols(origin, direction, time, ray_block)
        rec = G.hit_spheres_cols(glob, o, d, tm, min_t=min_t)
        mask = footprint_block_mask(gscene, o, d, rec.t, min_t, ray_block)
        np_ = o.shape[0]
    else:
        o, d, tm = pad_rays_rows(origin, direction, time, ray_block)
        check_schedule_size(o.shape[1] // ray_block, gscene.n_tiles)
        rec = K.hit_spheres_rows(glob, o, d, tm, min_t=min_t)
        mask = footprint_block_mask_rows(gscene, o, d, rec.t, min_t,
                                         ray_block)
        np_ = o.shape[1]
    sched = block_schedule(mask)
    # The record's t and idx views start its float and int buffers
    # (kernels/hit.record_rows, kernels/hit_cols.record_cols).
    args = GridArgs(
        o.data_ptr(), d.data_ptr(), tm.data_ptr(),
        gscene.tile_attrs.data_ptr(), sched.data_ptr(), rec.t.data_ptr(),
        rec.idx.data_ptr(), rec.hit.data_ptr(),
        None if stats is None else stats.data_ptr(), np_, gscene.n_tiles,
        gscene.tile_rows, ray_block, float(min_t),
        _build.stream_handle(o.device))
    return Prepared(args, cols, np_, (o, d, tm), sched, rec)


def launch(p: Prepared) -> None:
    """One launch of kernel I on prepared arguments (not counted here: the
    wrappers count the launches of the render path)."""
    lib = _build.load()
    _build.check(lib.wrt_hit_grid(ctypes.addressof(p.args), int(p.cols)),
                 "hit_spheres_grid")


def hit_spheres_grid_rows(gscene: GridScene, origin: torch.Tensor,
                          direction: torch.Tensor, time: torch.Tensor,
                          min_t: float = MIN_HIT_T,
                          ray_block: int = DEFAULT_RAY_BLOCK_GRID,
                          stats: Optional[torch.Tensor] = None
                          ) -> HitRecordRows:
    """Nearest front-face hit of rays o/d [3, N], time [1, N] through the
    sphere grid.  ``stats``, an int64 [2] tensor on the card, gains the CTA
    tiles staged and the pair tests computed."""
    global LAUNCHES
    dev = origin.device
    if dev.type == "cpu":
        return hit_spheres_grid_rows_plain(gscene, origin, direction, time,
                                           min_t=min_t, ray_block=ray_block)
    if dev.type != "cuda":
        raise ValueError(f"hit_spheres_grid_rows: unsupported device {dev}")
    _check(gscene, origin, direction, time, stats, cols=False)
    n = origin.shape[1]
    p = prepare(gscene, origin, direction, time, min_t, ray_block, False,
                stats)
    if p.n:
        launch(p)
        LAUNCHES += 1
    return p.rec if p.n == n else HitRecordRows(*(x[:, :n] for x in p.rec))


def hit_spheres_grid_cols(gscene: GridScene, origin: torch.Tensor,
                          direction: torch.Tensor, time: torch.Tensor,
                          min_t: float = MIN_HIT_T,
                          ray_block: int = DEFAULT_RAY_BLOCK_GRID,
                          stats: Optional[torch.Tensor] = None) -> HitRecord:
    """:func:`hit_spheres_grid_rows` for rays o/d [N, 3], time [N] (the
    column layout; pass A on kernel G)."""
    global LAUNCHES
    dev = origin.device
    if dev.type == "cpu":
        return hit_spheres_grid_plain(gscene, origin, direction, time,
                                      min_t=min_t, ray_block=ray_block)
    if dev.type != "cuda":
        raise ValueError(f"hit_spheres_grid_cols: unsupported device {dev}")
    _check(gscene, origin, direction, time, stats, cols=True)
    n = origin.shape[0]
    p = prepare(gscene, origin, direction, time, min_t, ray_block, True,
                stats)
    if p.n:
        launch(p)
        LAUNCHES += 1
    return p.rec if p.n == n else HitRecord(*(x[:n] for x in p.rec))
