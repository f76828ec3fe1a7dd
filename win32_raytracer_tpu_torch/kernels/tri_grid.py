"""Kernel D: the Morton-tile grid sweep in rows layout (``csrc/tri_grid.cu``).

Replaces ``win32_raytracer_tpu/kernels/tri_grid_rows.py``
(``_tri_grid_kernel_mxu`` and ``_tri_grid_kernel``, through
``hit_triangles_grid_rows``), the triangle pass of meshes of >= 512
triangles.  Bound by the pair tests the block schedule leaves; a CTA takes
a slice of one ray block, stages each scheduled tile through shared memory
and skips tiles per CTA and per warp (the source note in
csrc/tri_grid.cu has the detail).

The schedule prelude stays torch ops here, as it was XLA around the
reference's kernel (``_tri_grid_raw``): the block mask and entry bounds
(tri_accel.tri_block_schedule_rows), then per block the scheduled tiles
sorted front to back by their entry bound (a stable sort, so ties keep
tile-id order), their count, the bounds in schedule order floored onto the
1/1024 grid, and the tile boxes quantised outwards onto the same grid.

:func:`hit_triangles_grid_rows` launches the kernel for CUDA tensors and
runs the plain grid sweep (tri_accel.hit_triangles_grid_rows_plain) for
tensors on the CPU; it raises for anything else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import MIN_HIT_T
from ..ops.rows import HitRecordRows
from ..tri_accel import (
    DEFAULT_TRI_GRID_RAY_BLOCK, TRI_GRID_COLS, TriGridScene,
    hit_triangles_grid_rows_plain, pad_rays, tri_block_schedule_rows,
)
from . import _build
from .hit import record_buffers, record_rows

LAUNCHES = 0  # kernel launches by hit_triangles_grid_rows

# Entry bounds and tile boxes on a 1/1024 grid (tri_grid_rows' _TLO_*):
# flooring a bound and widening a box by a step only delay an early exit
# or pass an extra tile, never skip a reachable one.  _TLO_PAD sorts
# unscheduled tiles last and ends every schedule row.
_TLO_SCALE = np.float32(1024.0)
_TLO_INV = np.float32(1.0 / 1024.0)
_TLO_CAP = np.float32(1.0e6)
_TLO_PAD = np.float32(1.5e6)
_BX_CLIP = np.float32(1.0e6)


class TriGridArgs(ctypes.Structure):  # csrc/tri_grid.cu TriGridArgs
    _fields_ = [
        ("rays", ctypes.c_void_p), ("attrs", ctypes.c_void_p),
        ("sched", ctypes.c_void_p), ("tlo", ctypes.c_void_p),
        ("boxes", ctypes.c_void_p), ("out_f", ctypes.c_void_p),
        ("out_i", ctypes.c_void_p), ("out_hit", ctypes.c_void_p),
        ("stats", ctypes.c_void_p), ("n", ctypes.c_longlong),
        ("n_tiles", ctypes.c_int), ("st", ctypes.c_int),
        ("ray_block", ctypes.c_int), ("min_t", ctypes.c_float),
        ("stream", ctypes.c_void_p),
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


def quantized_boxes(tile_boxes: torch.Tensor) -> torch.Tensor:
    """[T, 6] tile boxes widened onto the 1/1024 grid (floor - 1 step on
    the low sides, ceil + 1 on the high ones), as the kernel reads them."""
    b = torch.clamp(tile_boxes, -float(_BX_CLIP), float(_BX_CLIP)) * float(_TLO_SCALE)
    q = torch.empty(b.shape, dtype=torch.int32, device=b.device)
    q[:, 0::2] = torch.floor(b[:, 0::2]).to(torch.int32) - 1
    q[:, 1::2] = torch.ceil(b[:, 1::2]).to(torch.int32) + 1
    return (q.to(torch.float32) * float(_TLO_INV)).contiguous()


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
    unspecified.  ``stats``, an int64 [2] tensor on the card, gains the
    tiles staged and the pair tests computed (chip_smoke.py reads it)."""
    global LAUNCHES
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
              (grid.tile_boxes, "tile_boxes", torch.float32, (n_tiles, 6))]
    if t_cap is not None:
        checks.append((t_cap, "t_cap", torch.float32, (1, n)))
    if stats is not None:
        checks.append((stats, "stats", torch.int64, (2,)))
    for t, name, dt, shape in checks:
        _build.check_tensor(t, name, dt, shape, dev)

    p = prepare(grid, origin, direction, t_cap, min_t, ray_block, stats)
    if p.n:
        launch(p, early_exit, any_skip)
        LAUNCHES += 1
    rec = record_rows(p.out_f, p.out_i, p.hit)
    return rec if p.n == n else HitRecordRows(*(x[:, :n] for x in rec))


class Prepared(NamedTuple):
    """Kernel D's arguments and the tensors they point into (kept alive
    with them): the padded rays, the schedule, the quantised boxes and the
    record buffers of ``n`` lanes."""
    args: TriGridArgs
    n: int
    rays: torch.Tensor
    sched: torch.Tensor
    bounds: torch.Tensor
    boxes: torch.Tensor
    out_f: torch.Tensor
    out_i: torch.Tensor
    hit: torch.Tensor


def prepare(grid: TriGridScene, origin, direction, t_cap, min_t: float,
            ray_block: int, stats=None) -> Prepared:
    """The wrapper's schedule prelude (torch ops) and output buffers, for
    rays already checked; :func:`launch` then runs the kernel on them
    (chip_smoke.py times the two apart)."""
    o, d, cap = pad_rays(origin, direction, t_cap, ray_block)
    np_ = o.shape[1]
    mask, tlo, cap_eff = tri_block_schedule_rows(grid, o, d, cap, min_t,
                                                 ray_block)
    sched, bounds = block_schedule(mask, tlo)
    boxes = quantized_boxes(grid.tile_boxes)
    rays = torch.cat([o, d, cap_eff], dim=0)
    out_f, out_i, hit = record_buffers(np_, o.device)
    args = TriGridArgs(
        rays.data_ptr(), grid.tile_attrs.data_ptr(), sched.data_ptr(),
        bounds.data_ptr(), boxes.data_ptr(), out_f.data_ptr(),
        out_i.data_ptr(), hit.data_ptr(),
        None if stats is None else stats.data_ptr(), np_, grid.n_tiles,
        grid.tile_rows, ray_block, float(min_t),
        _build.stream_handle(o.device))
    return Prepared(args, np_, rays, sched, bounds, boxes, out_f, out_i, hit)


def launch(p: Prepared, early_exit: bool, any_skip: bool) -> None:
    """One launch of kernel D on prepared arguments (not counted here: the
    wrapper counts the launches of the render path)."""
    lib = _build.load()
    _build.check(lib.wrt_hit_tri_grid(ctypes.addressof(p.args),
                                      int(early_exit), int(any_skip)),
                 "hit_triangles_grid_rows")
