"""Kernel I: the sphere grid, two launches (``csrc/hit_grid.cu``).

Replaces ``win32_raytracer_tpu/kernels/hit_grid_rows.py`` (``_grid_kernel_rows``
:98, through ``hit_spheres_grid_rows`` :215), the persistent scheduler's hit
under ``accel="grid"`` on a plain sphere scene, with its rows instance
(:func:`hit_spheres_grid_rows`); and
``win32_raytracer_tpu/kernels/experimental/hit_grid.py`` (``_grid_kernel``
:50, through ``hit_spheres_grid_pallas`` :160) with its column instance
(:func:`hit_spheres_grid_cols`).

Each call is two launches.  The schedule kernel takes what was XLA around
the reference's kernel: the rays padded to ``ray_block`` (the filler rays
made in the kernel), pass A over the globals (kernel A's packed sweep, 256
rows a stage, its record written into the buffers the sweep then merges
into), the footprint mask and the block schedule.  The sweep kernel runs pass B over the
scheduled tiles and merges.  Bound by the pair tests (24 f32 operations
each): pass A's and those the schedule leaves.  The plain versions
(accel.hit_spheres_grid_rows_plain, accel.hit_spheres_grid_plain) compute
the same function; :func:`schedule_plain` is the schedule kernel's plain
version (accel.py's mask and schedule on pass A's t).

Both wrappers launch the kernels for CUDA tensors and run the plain version
for tensors on the CPU; they raise for anything else.
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
from ..ops.hit import ATTR_COLS, HitRecord, _sweep
from ..ops.rows import HitRecordRows
from . import _build
from .hit import record_buffers, record_rows
from .hit_cols import record_buffers_cols, record_cols

LAUNCHES = 0        # sweep kernel launches by hit_spheres_grid_rows / _cols
SCHED_LAUNCHES = 0  # schedule kernel launches by the same
# Lanes per CTA of the sweep kernel (csrc/hit_grid.cu kRays * kThreads).
SWEEP_LANES_PER_CTA = 512
# Rows of the globals table the schedule kernel stages at once (kBlock):
# more take one more pass over a block's lanes per further stage, with
# pass A's (t, row) carried in a scratch buffer between passes.
GLOB_STAGE = 256


class GridArgs(ctypes.Structure):  # csrc/hit_grid.cu GridArgs
    _fields_ = [
        ("origin", ctypes.c_void_p), ("direction", ctypes.c_void_p),
        ("time", ctypes.c_void_p), ("glob", ctypes.c_void_p),
        ("attrs", ctypes.c_void_p), ("boxes", ctypes.c_void_p),
        ("y_slab", ctypes.c_void_p), ("sched", ctypes.c_void_p),
        ("out_f", ctypes.c_void_p), ("out_i", ctypes.c_void_p),
        ("out_hit", ctypes.c_void_p), ("stats", ctypes.c_void_p),
        ("carry_t", ctypes.c_void_p), ("carry_i", ctypes.c_void_p),
        ("n", ctypes.c_longlong), ("nb", ctypes.c_longlong),
        ("n_glob", ctypes.c_int), ("n_tiles", ctypes.c_int),
        ("st", ctypes.c_int), ("ray_block", ctypes.c_int),
        ("min_t", ctypes.c_float), ("stream", ctypes.c_void_p),
    ]


class Prepared(NamedTuple):
    """Both kernels' arguments and the tensors they point into (kept alive
    with them): the schedule and the record of ``n`` lanes, pass A's after
    :func:`schedule`, the merged one after :func:`launch`; pass A's carry
    between stages of globals (None for one stage)."""
    args: GridArgs
    cols: bool
    n: int
    rays: tuple
    sched: torch.Tensor
    rec: object
    carry: Optional[tuple]


def _check(gscene: GridScene, origin, direction, time, stats, cols: bool):
    n = origin.shape[0] if cols else origin.shape[1]
    vec, scal = ((n, 3), (n,)) if cols else ((3, n), (1, n))
    checks = [(origin, "origin", torch.float32, vec),
              (direction, "direction", torch.float32, vec),
              (time, "time", torch.float32, scal),
              (gscene.glob_attrs, "glob_attrs", torch.float32,
               (gscene.glob_attrs.shape[0], ATTR_COLS)),
              (gscene.tile_attrs, "tile_attrs", torch.float32,
               (gscene.n_tiles * gscene.tile_rows, GRID_ATTR_COLS)),
              (gscene.tile_boxes, "tile_boxes", torch.float32,
               (gscene.n_tiles, 4)),
              (gscene.y_slab, "y_slab", torch.float32, (2,))]
    if stats is not None:
        checks.append((stats, "stats", torch.int64, (2,)))
    for t, name, dt, shape in checks:
        _build.check_tensor(t, name, dt, shape, origin.device)


def prepare(gscene: GridScene, origin, direction, time, min_t: float,
            ray_block: int, cols: bool, stats=None) -> Prepared:
    """Output buffers and both kernels' arguments for rays already
    checked: :func:`schedule` then :func:`launch` run the two kernels on
    them (chip_smoke.py times the two apart)."""
    n = origin.shape[0] if cols else origin.shape[1]
    nb = -(-n // ray_block)
    if not cols:
        check_schedule_size(nb, gscene.n_tiles)
    dev = origin.device
    carry, carry_ptrs = None, (None, None)
    if gscene.glob_attrs.shape[0] > GLOB_STAGE:
        carry = (torch.empty(nb * ray_block, dtype=torch.float32, device=dev),
                 torch.empty(nb * ray_block, dtype=torch.int32, device=dev))
        carry_ptrs = tuple(c.data_ptr() for c in carry)
    sched = torch.empty((nb, 1 + gscene.n_tiles), dtype=torch.int32, device=dev)
    bufs = record_buffers_cols(n, dev) if cols else record_buffers(n, dev)
    rec = record_cols(*bufs) if cols else record_rows(*bufs)
    out_f, out_i, hit = bufs
    args = GridArgs(
        origin.data_ptr(), direction.data_ptr(), time.data_ptr(),
        gscene.glob_attrs.data_ptr(), gscene.tile_attrs.data_ptr(),
        gscene.tile_boxes.data_ptr(), gscene.y_slab.data_ptr(),
        sched.data_ptr(), out_f.data_ptr(), out_i.data_ptr(), hit.data_ptr(),
        None if stats is None else stats.data_ptr(), *carry_ptrs, n, nb,
        gscene.glob_attrs.shape[0], gscene.n_tiles, gscene.tile_rows,
        ray_block, float(min_t), _build.stream_handle(dev))
    return Prepared(args, cols, n, (origin, direction, time), sched, rec, carry)


def schedule(p: Prepared) -> None:
    """One launch of the schedule kernel: pass A's record and the block
    schedule (not counted here: the wrappers count the launches of the
    render path)."""
    lib = _build.load()
    _build.check(lib.wrt_hit_grid_schedule(ctypes.addressof(p.args),
                                           int(p.cols)),
                 "hit_spheres_grid schedule")


def launch(p: Prepared) -> None:
    """One launch of the sweep kernel on a scheduled :class:`Prepared`
    (not counted here)."""
    lib = _build.load()
    _build.check(lib.wrt_hit_grid(ctypes.addressof(p.args), int(p.cols)),
                 "hit_spheres_grid")


def schedule_plain(gscene: GridScene, origin, direction, time, min_t: float,
                   ray_block: int, cols: bool):
    """The schedule kernel's plain version: (pass A's t and original index
    per padded lane, the [NB, 1 + T] schedule), by accel.py's padding,
    sweep, mask and schedule."""
    glob = glob_table(gscene)
    if cols:
        o, d, tm = pad_rays_cols(origin, direction, time, ray_block)
        t_a, i_a = _sweep(glob, o, d, tm, min_t, glob.attrs.shape[0])
        mask = footprint_block_mask(gscene, o, d, t_a, min_t, ray_block)
    else:
        o, d, tm = pad_rays_rows(origin, direction, time, ray_block)
        check_schedule_size(o.shape[1] // ray_block, gscene.n_tiles)
        t_a, i_a = _sweep(glob, o.T, d.T, tm[0], min_t, glob.attrs.shape[0])
        mask = footprint_block_mask_rows(gscene, o, d, t_a[None], min_t,
                                         ray_block)
    return t_a, i_a, block_schedule(mask)


def _run(p: Prepared) -> None:
    """Both launches of one wrapper call, counted."""
    global LAUNCHES, SCHED_LAUNCHES
    if p.n:
        schedule(p)
        SCHED_LAUNCHES += 1
        launch(p)
        LAUNCHES += 1


def hit_spheres_grid_rows(gscene: GridScene, origin: torch.Tensor,
                          direction: torch.Tensor, time: torch.Tensor,
                          min_t: float = MIN_HIT_T,
                          ray_block: int = DEFAULT_RAY_BLOCK_GRID,
                          stats: Optional[torch.Tensor] = None
                          ) -> HitRecordRows:
    """Nearest front-face hit of rays o/d [3, N], time [1, N] through the
    sphere grid.  ``stats``, an int64 [2] tensor on the card, gains the
    sweep's CTA tiles (scheduled tiles summed over its CTAs) and its pair
    tests."""
    dev = origin.device
    if dev.type == "cpu":
        return hit_spheres_grid_rows_plain(gscene, origin, direction, time,
                                           min_t=min_t, ray_block=ray_block)
    if dev.type != "cuda":
        raise ValueError(f"hit_spheres_grid_rows: unsupported device {dev}")
    _check(gscene, origin, direction, time, stats, cols=False)
    p = prepare(gscene, origin, direction, time, min_t, ray_block, False,
                stats)
    _run(p)
    return p.rec


def hit_spheres_grid_cols(gscene: GridScene, origin: torch.Tensor,
                          direction: torch.Tensor, time: torch.Tensor,
                          min_t: float = MIN_HIT_T,
                          ray_block: int = DEFAULT_RAY_BLOCK_GRID,
                          stats: Optional[torch.Tensor] = None) -> HitRecord:
    """:func:`hit_spheres_grid_rows` for rays o/d [N, 3], time [N] (the
    column layout)."""
    dev = origin.device
    if dev.type == "cpu":
        return hit_spheres_grid_plain(gscene, origin, direction, time,
                                      min_t=min_t, ray_block=ray_block)
    if dev.type != "cuda":
        raise ValueError(f"hit_spheres_grid_cols: unsupported device {dev}")
    _check(gscene, origin, direction, time, stats, cols=True)
    p = prepare(gscene, origin, direction, time, min_t, ray_block, True,
                stats)
    _run(p)
    return p.rec
