"""Kernel D: the Morton-tile grid sweep in rows layout, two launches
(``csrc/tri_grid.cu``).

Replaces ``win32_raytracer_tpu/kernels/tri_grid_rows.py``
(``_tri_grid_kernel_mxu`` and ``_tri_grid_kernel``, through
``hit_triangles_grid_rows``), the triangle pass of meshes of >= 512
triangles.  Bound by the pair tests the block schedule leaves and the
any-touch tests of the walk (the source note in csrc/tri_grid.cu has the
detail).

Each call is two launches.  The schedule kernel builds on the card what was
XLA around the reference's kernel (``_tri_grid_raw``): the block mask and
entry bounds (tri_accel.tri_block_schedule_rows), then per block the
scheduled tiles sorted front to back by their entry bound (a stable sort,
so ties keep tile-id order; a block's few scheduled tiles ranked by
counting, many by a radix sort through a scratch row per block, so any
number of tiles is served), their count and the bounds in schedule order
floored onto the 1/1024 grid (:func:`block_schedule`, its plain version
with :func:`schedule_plain`), and each lane's segment end.  The sweep kernel
walks the schedule.  The tile boxes quantised outwards onto the same grid
and the geometry packed for 16-byte loads are made once per grid, with the
grid (tri_accel.make_tri_grid).

:func:`hit_triangles_grid_rows` launches the kernels for CUDA tensors and
runs the plain grid sweep (tri_accel.hit_triangles_grid_rows_plain) for
tensors on the CPU; it raises for anything else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import MIN_HIT_T
from ..ops.hit_tri import _T_V0X
from ..ops.rows import HitRecordRows
from ..tri_accel import (
    _TLO_INV, _TLO_SCALE, DEFAULT_TRI_GRID_RAY_BLOCK, TRI_GRID_COLS,
    TriGridScene, hit_triangles_grid_rows_plain, pad_rays,
    tri_block_schedule_rows,
)
from . import _build
from .hit import record_buffers, record_rows

LAUNCHES = 0        # sweep kernel launches by hit_triangles_grid_rows
SCHED_LAUNCHES = 0  # schedule kernel launches by the same

# Entry bounds on the 1/1024 grid (tri_grid_rows' _TLO_*): flooring a
# bound only delays an early exit.  _TLO_PAD sorts unscheduled tiles last
# and ends every schedule row.
_TLO_CAP = np.float32(1.0e6)
_TLO_PAD = np.float32(1.5e6)
# Lanes per CTA of the sweep kernel (csrc/tri_grid.cu kSweepThreads / kSub).
SWEEP_LANES_PER_CTA = 32


class TriGridArgs(ctypes.Structure):  # csrc/tri_grid.cu TriGridArgs
    _fields_ = [
        ("origin", ctypes.c_void_p), ("direction", ctypes.c_void_p),
        ("t_cap", ctypes.c_void_p), ("attrs", ctypes.c_void_p),
        ("geom", ctypes.c_void_p), ("boxes", ctypes.c_void_p),
        ("qboxes", ctypes.c_void_p), ("scene_box", ctypes.c_void_p),
        ("sched", ctypes.c_void_p), ("bounds", ctypes.c_void_p),
        ("cap_eff", ctypes.c_void_p), ("sort_keys", ctypes.c_void_p),
        ("sort_ids", ctypes.c_void_p), ("out_f", ctypes.c_void_p),
        ("out_i", ctypes.c_void_p), ("out_hit", ctypes.c_void_p),
        ("stats", ctypes.c_void_p), ("n", ctypes.c_longlong),
        ("nb", ctypes.c_longlong), ("n_tiles", ctypes.c_int),
        ("st", ctypes.c_int), ("ray_block", ctypes.c_int),
        ("min_t", ctypes.c_float), ("stream", ctypes.c_void_p),
    ]


def block_schedule(mask: torch.Tensor, tlo: torch.Tensor):
    """(sched [NB, 1+T] int32: count then tile ids front to back,
    bounds [NB, T+1] f32 in schedule order, on the 1/1024 grid)."""
    key = torch.where(mask > 0, torch.clamp_max(tlo, float(_TLO_CAP)),
                      float(_TLO_PAD))
    order = torch.argsort(key, dim=1, stable=True)
    count = (mask > 0).sum(dim=1, dtype=torch.int32)
    sched = torch.cat([count[:, None], order.to(torch.int32)], dim=1)
    q = torch.floor(torch.gather(key, 1, order) * float(_TLO_SCALE))
    pad = torch.full((mask.shape[0], 1), float(_TLO_PAD * _TLO_SCALE),
                     device=mask.device)
    bounds = torch.cat([q, pad], dim=1).to(torch.int32)
    return sched.contiguous(), (bounds.to(torch.float32) * float(_TLO_INV)).contiguous()


def schedule_plain(grid: TriGridScene, origin, direction, t_cap,
                   min_t: float, ray_block: int):
    """The schedule kernel's plain version for rays [3, N] (and t_cap
    [1, N]): (sched [NB, 1+T], bounds [NB, T+1], cap_eff [1, Np]) by
    tri_accel.pad_rays, tri_block_schedule_rows and block_schedule."""
    o, d, cap = pad_rays(origin, direction, t_cap, ray_block)
    mask, tlo, cap_eff = tri_block_schedule_rows(grid, o, d, cap, min_t,
                                                 ray_block)
    sched, bounds = block_schedule(mask, tlo)
    return sched, bounds, cap_eff


def hit_triangles_grid_rows(
        grid: TriGridScene, origin: torch.Tensor, direction: torch.Tensor,
        time: torch.Tensor, min_t: float = MIN_HIT_T,
        ray_block: int = DEFAULT_TRI_GRID_RAY_BLOCK,
        t_cap: Optional[torch.Tensor] = None, early_exit: bool = True,
        any_skip: bool = True,
        stats: Optional[torch.Tensor] = None) -> HitRecordRows:
    """Nearest two-sided triangle hit of rays o/d [3, N] through the grid.

    ``t_cap`` [1, N] (a nearer hit from another pass) tightens the block
    mask; ``early_exit`` and ``any_skip`` select the kernel's front-to-back
    stop and its any-touch skip (both exact; off = the A/B arms).  A lane's
    record beyond its segment end (scene box exit and ``t_cap``) is
    unspecified.  ``stats``, an int64 [4] tensor on the card, gains the
    CTA tiles staged, the pair tests, the any-touch tests and the CTA walk
    entries (chip_smoke.py reads it)."""
    global LAUNCHES, SCHED_LAUNCHES
    dev = origin.device
    if dev.type == "cpu":
        return hit_triangles_grid_rows_plain(
            grid, origin, direction, time, min_t=min_t, ray_block=ray_block,
            t_cap=t_cap, early_exit=early_exit, any_skip=any_skip)
    if dev.type != "cuda":
        raise ValueError(f"hit_triangles_grid_rows: unsupported device {dev}")
    n = origin.shape[1]
    n_tiles, st = grid.n_tiles, grid.tile_rows
    checks = [(origin, "origin", torch.float32, (3, n)),
              (direction, "direction", torch.float32, (3, n)),
              (grid.tile_attrs, "tile_attrs", torch.float32,
               (n_tiles * st, TRI_GRID_COLS)),
              (grid.tile_boxes, "tile_boxes", torch.float32, (n_tiles, 6)),
              (grid.scene_box, "scene_box", torch.float32, (6,)),
              (grid.tile_geom, "tile_geom", torch.float32, (n_tiles * st, 12)),
              (grid.tile_qboxes, "tile_qboxes", torch.float32, (n_tiles, 6))]
    if t_cap is not None:
        checks.append((t_cap, "t_cap", torch.float32, (1, n)))
    if stats is not None:
        checks.append((stats, "stats", torch.int64, (4,)))
    for t, name, dt, shape in checks:
        _build.check_tensor(t, name, dt, shape, dev)

    p = prepare(grid, origin, direction, t_cap, min_t, ray_block, stats)
    if p.n:
        schedule(p)
        SCHED_LAUNCHES += 1
        launch(p, early_exit, any_skip)
        LAUNCHES += 1
    return record_rows(p.out_f, p.out_i, p.hit)


class Prepared(NamedTuple):
    """Both kernels' arguments and the tensors they point into (kept alive
    with them): the schedule, the segment ends, the schedule kernel's
    scratch ([NB, T] keys and ids) and the record buffers of ``n``
    lanes."""
    args: TriGridArgs
    n: int
    rays: tuple
    grid: TriGridScene
    sched: torch.Tensor
    bounds: torch.Tensor
    cap_eff: torch.Tensor
    scratch: tuple
    out_f: torch.Tensor
    out_i: torch.Tensor
    hit: torch.Tensor


def prepare(grid: TriGridScene, origin, direction, t_cap, min_t: float,
            ray_block: int, stats=None) -> Prepared:
    """Output buffers and both kernels' arguments for rays already
    checked: :func:`schedule` then :func:`launch` run the two kernels on
    them (chip_smoke.py times the two apart)."""
    n = origin.shape[1]
    nb = -(-n // ray_block)
    dev = origin.device
    t = grid.n_tiles + 1
    sched = torch.empty((nb, t), dtype=torch.int32, device=dev)
    bounds = torch.empty((nb, t), dtype=torch.float32, device=dev)
    cap_eff = torch.empty((n,), dtype=torch.float32, device=dev)
    scratch = (torch.empty((nb, grid.n_tiles), dtype=torch.int32, device=dev),
               torch.empty((nb, grid.n_tiles), dtype=torch.int32, device=dev))
    out_f, out_i, hit = record_buffers(n, dev)
    args = TriGridArgs(
        origin.data_ptr(), direction.data_ptr(),
        None if t_cap is None else t_cap.data_ptr(),
        grid.tile_attrs.data_ptr(), grid.tile_geom.data_ptr(),
        grid.tile_boxes.data_ptr(), grid.tile_qboxes.data_ptr(),
        grid.scene_box.data_ptr(), sched.data_ptr(), bounds.data_ptr(),
        cap_eff.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        out_f.data_ptr(), out_i.data_ptr(),
        hit.data_ptr(), None if stats is None else stats.data_ptr(), n, nb,
        grid.n_tiles, grid.tile_rows, ray_block, float(min_t),
        _build.stream_handle(dev))
    return Prepared(args, n, (origin, direction, t_cap), grid, sched, bounds,
                    cap_eff, scratch, out_f, out_i, hit)


def schedule(p: Prepared) -> None:
    """One launch of the schedule kernel: sched, bounds and the segment
    ends (not counted here: the wrapper counts the launches of the render
    path)."""
    lib = _build.load()
    _build.check(lib.wrt_tri_grid_schedule(ctypes.addressof(p.args)),
                 "hit_triangles_grid_rows schedule")


def launch(p: Prepared, early_exit: bool, any_skip: bool) -> None:
    """One launch of the sweep kernel on a scheduled :class:`Prepared`
    (not counted here)."""
    lib = _build.load()
    _build.check(lib.wrt_hit_tri_grid(ctypes.addressof(p.args),
                                      int(early_exit), int(any_skip)),
                 "hit_triangles_grid_rows")
