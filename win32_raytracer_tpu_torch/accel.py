"""Uniform-grid acceleration for the sphere hit sweep.

The port of ``win32_raytracer_tpu/accel.py`` (``build_grid_accel`` :118,
``footprint_block_mask`` :223, ``merge_best`` :321,
``hit_spheres_grid_jnp`` :335) and of the rows mask of
``win32_raytracer_tpu/kernels/hit_grid_rows.py``
(``footprint_block_mask_rows`` :48).

* Spheres are split into **globals** (radius above 3x the median: the
  ground sphere and the heroes) and **gridded** ones, binned by centre into
  a near-square (x, z) lattice of tiles of about 16 spheres.  Tile boxes
  include the motion over the shutter window and the radius.
* Pass A sweeps the globals.  Each ray then gets a conservative
  **footprint**, the (x, z) interval it sweeps inside the gridded spheres'
  y slab, clipped to [min_t, pass A's t]; per block of ``ray_block`` rays
  the footprints are min/max-reduced and tested against every tile box,
  an [NB, T] mask.
* Pass B sweeps the masked tiles only, in ascending tile id, strict <
  across tiles and the lowest row within one (tile rows are in ascending
  original index).  The two passes merge lexicographically on
  (t, original index), the brute sweep's earliest-index rule.

The plain sweeps here (:func:`hit_spheres_grid_plain`, column layout, and
:func:`hit_spheres_grid_rows_plain`) are kernel I's plain versions
(kernels/hit_grid.py): they read the same mask, compute the masked tiles
(unlike the reference's jnp oracle, which computes every tile and discards
the masked ones; the result is the same) and fetch the winner's row by
index.  Padding rows have radius 0 and are gated by ``r != 0``, as in the
reference; the brute sweep's active mask and this gate agree because the
build drops inactive spheres.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import MIN_HIT_T
from .ops.hit import (
    _A_ALB, _A_ALR, _A_C1X, _A_C1Z, _A_DCX, _A_DCZ, _A_FUZZ, _A_IDX, _A_INVDT,
    _A_IOR, _A_MAT, _A_RADIUS, _A_T1, ATTR_COLS, F32_MAX, HitRecord,
    SphereTable, _sweep,
)
from .ops.rows import HitRecordRows
from .scene.spheres import SphereScene, scene_from_numpy
from .tri_accel import pad_rays

# Tile rows carry one more, all-ones column, as in the reference (its
# winner flag through the MXU; read by nothing here).
GRID_ATTR_COLS = ATTR_COLS + 1  # 17

# Rays per schedule block: the reference's default for both the rows and
# the column kernel (hit_grid_rows.DEFAULT_RAY_BLOCK_GRID_ROWS,
# experimental/hit_grid.DEFAULT_RAY_BLOCK_GRID).  The mask depends on it.
DEFAULT_RAY_BLOCK_GRID = 2048

_BIG = np.float32(1e8)          # t / coordinate clamp for open footprints
_EPS = np.float32(1e-12)        # |dy| floor of the slab division
# The reference's guard of its scalar-prefetched schedule (a TPU SMEM
# limit, hit_grid_rows.py:170-178), kept so both packages take the same
# configurations.
_SCHED_LIMIT = 768 * 1024


class GridScene(NamedTuple):
    """A SphereScene plus its uniform-grid arrays.  ``base`` is untouched,
    so the brute sweep keeps working on it."""

    base: SphereScene
    glob_attrs: torch.Tensor   # [Sg, ATTR_COLS] globals (original idx col)
    tile_attrs: torch.Tensor   # [T * St, GRID_ATTR_COLS] tiles, row-major
    tile_boxes: torch.Tensor   # [T, 4] f32: x_lo, x_hi, z_lo, z_hi
    y_slab: torch.Tensor       # [2] f32: y_lo, y_hi over all gridded spheres

    @property
    def padded_size(self) -> int:
        return self.base.padded_size

    @property
    def n_tiles(self) -> int:
        return self.tile_boxes.shape[0]

    @property
    def tile_rows(self) -> int:
        return self.tile_attrs.shape[0] // self.tile_boxes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tile_attrs.device


def grid_from_numpy(src, device="cpu") -> GridScene:
    """Port grid from any object carrying the reference ``GridScene``'s
    fields as arrays."""
    def f32(x):
        return torch.as_tensor(np.array(x), dtype=torch.float32,
                               device=device)
    return GridScene(scene_from_numpy(src.base, device), f32(src.glob_attrs),
                     f32(src.tile_attrs), f32(src.tile_boxes),
                     f32(src.y_slab))


def glob_table(gscene: GridScene) -> SphereTable:
    """The globals as a sphere table for pass A, gated by r != 0 (their
    padding rows have radius 0)."""
    g = gscene.glob_attrs
    return SphereTable(g, (g[:, _A_RADIUS] != 0.0).contiguous())


def _attr_rows(sc: dict, sel: np.ndarray, cols: int) -> np.ndarray:
    """Packed attribute rows (ops/hit._attr_matrix layout) for sphere
    indices ``sel``, with the ORIGINAL scene index in the idx column."""
    out = np.zeros((len(sel), cols), np.float32)
    c1, c2 = sc["center1"][sel], sc["center2"][sel]
    out[:, _A_C1X:_A_C1Z + 1] = c1
    out[:, _A_DCX:_A_DCZ + 1] = c2 - c1
    out[:, _A_T1] = sc["t1"][sel]
    out[:, _A_INVDT] = 1.0 / (sc["t2"][sel] - sc["t1"][sel])
    out[:, _A_RADIUS] = sc["radius"][sel]
    out[:, _A_MAT] = sc["mat_id"][sel]
    out[:, _A_ALR:_A_ALB + 1] = sc["albedo"][sel]
    out[:, _A_FUZZ] = sc["fuzz"][sel]
    out[:, _A_IOR] = sc["ior"][sel]
    out[:, _A_IDX] = sel
    if cols > ATTR_COLS:
        out[:, ATTR_COLS] = 1.0
    return out


def _pad_rows(rows: np.ndarray, to: int) -> np.ndarray:
    """Pad attribute rows with inactive spheres (radius 0, parked at
    y = -1e8)."""
    pad = to - len(rows)
    if pad <= 0:
        return rows
    filler = np.zeros((pad, rows.shape[1]), np.float32)
    filler[:, _A_C1X + 1] = -1.0e8
    filler[:, _A_INVDT] = 1.0
    if rows.shape[1] > ATTR_COLS:
        filler[:, ATTR_COLS] = 1.0
    return np.concatenate([rows, filler], axis=0)


# Built grids memoised by the identity of the SphereScene (the reference's
# rule); an entry holds the scene (grid.base), so its id cannot be reused
# while the entry lives.  Bounded FIFO.
_SGRID_CACHE: dict = {}
_SGRID_CACHE_MAX = 8


def build_grid_accel(scene: SphereScene, time_hi: float = 1.0,
                     target_per_tile: int = 16,
                     global_radius_factor: float = 3.0,
                     max_tile_rows: int = 64,
                     min_gridded: int = 64) -> Optional[GridScene]:
    """A :class:`GridScene` on the scene's device, or None when the scene
    does not benefit (fewer than ``min_gridded`` small spheres, or a tile
    would need more than ``max_tile_rows`` rows).  ``time_hi`` bounds the
    shutter window sampled (pass the camera's shutter_close): motion
    extents are evaluated over [0, time_hi]."""
    key = (id(scene), time_hi, target_per_tile, global_radius_factor,
           max_tile_rows, min_gridded)
    cached = _SGRID_CACHE.get(key)
    if cached is not None and cached.base is scene:
        return cached
    sc = {f: getattr(scene, f).cpu().numpy() for f in SphereScene._fields}
    active = np.flatnonzero(sc["active"])
    if len(active) == 0:
        return None
    r = np.abs(sc["radius"][active])

    # Centres at the shutter endpoints (motion is linear in time).
    inv_dt = 1.0 / (sc["t2"][active] - sc["t1"][active])
    l0 = (0.0 - sc["t1"][active]) * inv_dt
    l1 = (time_hi - sc["t1"][active]) * inv_dt
    c1, c2 = sc["center1"][active], sc["center2"][active]
    dc = c2 - c1
    p0 = c1 + dc * l0[:, None]
    p1 = c1 + dc * l1[:, None]
    lo = np.minimum(p0, p1) - r[:, None]
    hi = np.maximum(p0, p1) + r[:, None]

    med_r = float(np.median(r))
    is_global = r > global_radius_factor * max(med_r, 1e-6)
    gridded = active[~is_global]
    globals_ = active[is_global]
    if len(gridded) < min_gridded:
        return None

    glo, ghi = lo[~is_global], hi[~is_global]
    # (x, z) tile lattice of about target_per_tile spheres per tile.
    cx = 0.5 * (glo[:, 0] + ghi[:, 0])
    cz = 0.5 * (glo[:, 2] + ghi[:, 2])
    x0, x1 = float(cx.min()), float(cx.max())
    z0, z1 = float(cz.min()), float(cz.max())
    n_tiles_target = max(1, len(gridded) // target_per_tile)
    aspect = max((x1 - x0), 1e-6) / max((z1 - z0), 1e-6)
    tz = max(1, int(round(np.sqrt(n_tiles_target / max(aspect, 1e-6)))))
    tx = max(1, -(-n_tiles_target // tz))

    ix = np.clip(((cx - x0) / max(x1 - x0, 1e-6) * tx).astype(int), 0, tx - 1)
    iz = np.clip(((cz - z0) / max(z1 - z0, 1e-6) * tz).astype(int), 0, tz - 1)
    tid = ix * tz + iz
    t_count = np.bincount(tid, minlength=tx * tz)
    st = -(-int(t_count.max()) // 8) * 8   # rows padded to a multiple of 8
    if st == 0 or st > max_tile_rows:
        return None

    n_t = tx * tz
    tiles = np.zeros((n_t, st, GRID_ATTR_COLS), np.float32)
    boxes = np.zeros((n_t, 4), np.float32)
    for t in range(n_t):
        # Ascending original index inside a tile: within-tile ties resolve
        # to the earliest index, like the brute sweep.
        sel = gridded[tid == t]
        tiles[t] = _pad_rows(_attr_rows(sc, sel, GRID_ATTR_COLS), st)
        if len(sel):
            m = np.isin(gridded, sel)
            boxes[t] = (glo[m][:, 0].min(), ghi[m][:, 0].max(),
                        glo[m][:, 2].min(), ghi[m][:, 2].max())
        else:
            boxes[t] = (1e9, -1e9, 1e9, -1e9)   # never overlaps

    y_lo, y_hi = float(glo[:, 1].min()), float(ghi[:, 1].max())
    sg = max(8, -(-len(globals_) // 8) * 8)
    gl = _pad_rows(_attr_rows(sc, globals_, ATTR_COLS), sg)

    dev = scene.device
    out = GridScene(
        base=scene,
        glob_attrs=torch.from_numpy(gl).to(dev),
        tile_attrs=torch.from_numpy(
            tiles.reshape(n_t * st, GRID_ATTR_COLS)).to(dev),
        tile_boxes=torch.from_numpy(boxes).to(dev),
        y_slab=torch.tensor([y_lo, y_hi], dtype=torch.float32, device=dev))
    if len(_SGRID_CACHE) >= _SGRID_CACHE_MAX:
        _SGRID_CACHE.pop(next(iter(_SGRID_CACHE)))
    _SGRID_CACHE[key] = out
    return out


def _footprint_mask(gscene: GridScene, o, d, t_cap, min_t: float,
                    ray_block: int) -> torch.Tensor:
    """The mask from o/d as three [Np] components each (``o[0]`` is x),
    t_cap [Np]; the reference's operations in its order."""
    nb = o[0].shape[0] // ray_block
    y_lo, y_hi = gscene.y_slab[0], gscene.y_slab[1]
    ox, oy, oz = o
    dx, dy, dz = d
    eps, big = float(_EPS), float(_BIG)
    dy_safe = torch.where(dy.abs() < eps, torch.where(dy < 0, -eps, eps), dy)
    ta = (y_lo - oy) / dy_safe
    tb = (y_hi - oy) / dy_safe
    lo_t = torch.clamp_min(torch.minimum(ta, tb), float(np.float32(min_t)))
    hi_t = torch.minimum(torch.maximum(ta, tb), torch.clamp_max(t_cap, big))
    empty = lo_t > hi_t

    xa, xb = ox + lo_t * dx, ox + hi_t * dx
    za, zb = oz + lo_t * dz, oz + hi_t * dz

    def block(x, fill, reduce_max):
        x = torch.where(empty, fill, x).reshape(nb, ray_block)
        return x.amax(1) if reduce_max else x.amin(1)

    bx_min = block(torch.minimum(xa, xb), big, False)
    bx_max = block(torch.maximum(xa, xb), -big, True)
    bz_min = block(torch.minimum(za, zb), big, False)
    bz_max = block(torch.maximum(za, zb), -big, True)

    bx = gscene.tile_boxes
    overlap = ((bx_min[:, None] <= bx[None, :, 1])
               & (bx_max[:, None] >= bx[None, :, 0])
               & (bz_min[:, None] <= bx[None, :, 3])
               & (bz_max[:, None] >= bx[None, :, 2]))
    return overlap.to(torch.int32)


def footprint_block_mask(gscene: GridScene, origin: torch.Tensor,
                         direction: torch.Tensor, t_cap: torch.Tensor,
                         min_t: float, ray_block: int) -> torch.Tensor:
    """[Np/ray_block, T] int32, 1 where the block must test the tile, for
    rays o/d [Np, 3] padded to a multiple of ``ray_block`` and t_cap [Np]
    (pass A's t, F32_MAX = none).  Per ray: the t interval inside the y
    slab, clipped to [min_t, min(t_cap, 1e8)], swept into an (x, z) box
    (empty when lo > hi); per block: min/max; per (block, tile): box
    overlap.  Conservative: never skips a possible hit."""
    return _footprint_mask(gscene, origin.T, direction.T, t_cap, min_t,
                           ray_block)


def footprint_block_mask_rows(gscene: GridScene, origin: torch.Tensor,
                              direction: torch.Tensor, t_cap: torch.Tensor,
                              min_t: float, ray_block: int) -> torch.Tensor:
    """:func:`footprint_block_mask` for rays [3, Np] and t_cap [1, Np]."""
    return _footprint_mask(gscene, origin, direction, t_cap[0], min_t,
                           ray_block)


def check_schedule_size(n_blocks: int, n_tiles: int) -> None:
    """The reference's ValueError when its [NB, 1+T] i32 schedule would
    not fit 768 KiB of TPU scalar memory, double-buffered."""
    smem = n_blocks * (1 + n_tiles) * 4 * 2
    if smem > _SCHED_LIMIT:
        raise ValueError(
            f"grid hit schedule needs ~{smem >> 10} KiB SMEM "
            f"(NB={n_blocks} x (1+T={1 + n_tiles}) i32, double-buffered) > "
            "768 KiB — raise ray_block or split the batch")


def block_schedule(mask: torch.Tensor) -> torch.Tensor:
    """[NB, 1+T] int32: the count of scheduled tiles, then their ids in
    ascending order (the unscheduled ids after them), as the reference
    builds it by an argsort of where(mask, id, T + id)."""
    n_tiles = mask.shape[1]
    ids = torch.arange(n_tiles, dtype=torch.int32, device=mask.device)
    key = torch.where(mask > 0, ids, n_tiles + ids)
    order = torch.argsort(key, dim=1).to(torch.int32)
    count = (mask > 0).sum(dim=1, dtype=torch.int32)
    return torch.cat([count[:, None], order], dim=1).contiguous()


def pad_rays_rows(origin, direction, time, ray_block: int):
    """Rays o/d [3, N], t [1, N] padded to a multiple of ``ray_block`` as
    the reference's rows kernel pads them: filler rays parked below
    everything (o = (0, -1e9, 0), d = (0, 0, 1), t = 0), whose footprints
    are empty (the triangle grid's filler, tri_accel.pad_rays)."""
    o, d, _ = pad_rays(origin, direction, None, ray_block)
    pad = o.shape[1] - origin.shape[1]
    if pad:
        time = torch.cat([time, time.new_zeros((1, pad))], dim=1)
    return o, d, time


def pad_rays_cols(origin, direction, time, ray_block: int):
    """Rays o/d [N, 3], t [N] padded as the reference's column kernel pads
    them: o = (0, -1e9, 0), a zero direction, t = 0 (an empty footprint;
    the filler's pair tests come out NaN, which no gate passes)."""
    pad = (-origin.shape[0]) % ray_block
    if not pad:
        return origin, direction, time
    fill_o = origin.new_zeros((pad, 3))
    fill_o[:, 1] = -1e9
    return (torch.cat([origin, fill_o]),
            torch.cat([direction, direction.new_zeros((pad, 3))]),
            torch.cat([time, time.new_zeros((pad,))]))


def merge_best(t_a, row_a, t_b, row_b):
    """Lexicographic (t, original index) merge of two bests: exact-t ties
    between different spheres pick the smaller original index, the brute
    sweep's earliest-index rule.  Rows are zero on a miss here, so a pass
    B miss never displaces pass A."""
    better = (t_b < t_a) | ((t_b == t_a) & (row_b[:, _A_IDX] < row_a[:, _A_IDX]))
    return (torch.where(better, t_b, t_a),
            torch.where(better[:, None], row_b, row_a))


def assemble_hit_record(origin, direction, time, best_t,
                        best_a) -> HitRecord:
    """The HitRecord of winning attribute rows [N, >= 16] (zero on a miss):
    ops/hit.hit_spheres' epilogue."""
    hit = best_t < F32_MAX
    t_safe = torch.where(hit, best_t, 0.0)
    point = origin + t_safe[:, None] * direction
    lerp = (time - best_a[:, _A_T1]) * best_a[:, _A_INVDT]
    center = (best_a[:, _A_C1X:_A_C1Z + 1]
              + best_a[:, _A_DCX:_A_DCZ + 1] * lerp[:, None])
    radius = best_a[:, _A_RADIUS]
    denom = torch.where(radius == 0.0, 1.0, radius)
    normal = (point - center) / denom[:, None]
    return HitRecord(
        hit=hit, t=best_t, point=point, normal=normal,
        idx=best_a[:, _A_IDX].to(torch.int32),
        mat_id=best_a[:, _A_MAT].to(torch.int32),
        albedo=best_a[:, _A_ALR:_A_ALB + 1], fuzz=best_a[:, _A_FUZZ],
        ior=best_a[:, _A_IOR])


def _rows_of(attrs: torch.Tensor, t: torch.Tensor, i: torch.Tensor):
    """Attribute rows [N, 16] of winners ``i`` (zero where t is F32_MAX)."""
    hit = t < F32_MAX
    return torch.where(hit[:, None], attrs[i.clamp_min(0), :ATTR_COLS], 0.0)


_LANE_CHUNK = 1 << 18


def _sweep_tiles(gscene: GridScene, o, d, tm, mask, min_t: float,
                 ray_block: int):
    """Pass B over the masked tiles, column rays [Np, 3]: each tile in
    ascending id over the lanes of its blocks, the tile's nearest row
    (lowest row on ties) taken where strictly nearer.  Returns (t [Np],
    winning row of tile_attrs [Np], -1 where none)."""
    np_ = o.shape[0]
    dev = o.device
    best_t = torch.full((np_,), F32_MAX, dtype=torch.float32, device=dev)
    best_row = torch.full((np_,), -1, dtype=torch.int64, device=dev)
    st = gscene.tile_rows
    in_block = torch.arange(ray_block, device=dev)
    for tile, blocks in enumerate(mask.T.bool().cpu()):
        blocks = torch.nonzero(blocks)[:, 0].to(dev)
        if not len(blocks):
            continue
        tl = gscene.tile_attrs[tile * st:(tile + 1) * st, :ATTR_COLS]
        tab = SphereTable(tl, tl[:, _A_RADIUS] != 0.0)
        lanes = (blocks[:, None] * ray_block + in_block).reshape(-1)
        for c0 in range(0, len(lanes), _LANE_CHUNK):
            ln = lanes[c0:c0 + _LANE_CHUNK]
            tile_t, first = _sweep(tab, o[ln], d[ln], tm[ln], min_t, st)
            better = tile_t < best_t[ln]
            best_t[ln] = torch.where(better, tile_t, best_t[ln])
            best_row[ln] = torch.where(better, tile * st + first, best_row[ln])
    return best_t, best_row


def _grid_hit(gscene: GridScene, o, d, tm, min_t: float,
              ray_block: int) -> HitRecord:
    """Both passes and the merge on padded column rays."""
    glob = glob_table(gscene)
    t_a, i_a = _sweep(glob, o, d, tm, min_t, glob.attrs.shape[0])
    mask = footprint_block_mask(gscene, o, d, t_a, min_t, ray_block)
    t_b, row_b = _sweep_tiles(gscene, o, d, tm, mask, min_t, ray_block)
    t_m, row_m = merge_best(t_a, _rows_of(glob.attrs, t_a, i_a),
                            t_b, _rows_of(gscene.tile_attrs, t_b, row_b))
    return assemble_hit_record(o, d, tm, t_m, row_m)


def hit_spheres_grid_plain(gscene: GridScene, origin: torch.Tensor,
                           direction: torch.Tensor, time: torch.Tensor,
                           min_t: float = MIN_HIT_T,
                           ray_block: int = DEFAULT_RAY_BLOCK_GRID
                           ) -> HitRecord:
    """The plain grid hit of rays o/d [N, 3], time [N] (column layout):
    kernel I's plain version for its column instance, and the twin of the
    reference's ``hit_spheres_grid_jnp``.  Equal to the brute sweep up to
    the cross-tile tie rule; zeros in the record's fields on a miss."""
    n = origin.shape[0]
    o, d, tm = pad_rays_cols(origin, direction, time, ray_block)
    rec = _grid_hit(gscene, o, d, tm, min_t, ray_block)
    return HitRecord(*(x[:n] for x in rec))


def hit_spheres_grid_rows_plain(gscene: GridScene, origin: torch.Tensor,
                                direction: torch.Tensor, time: torch.Tensor,
                                min_t: float = MIN_HIT_T,
                                ray_block: int = DEFAULT_RAY_BLOCK_GRID
                                ) -> HitRecordRows:
    """:func:`hit_spheres_grid_plain` for rays [3, N], time [1, N] (the
    persistent scheduler's layout, padded as the reference's rows kernel
    pads), with the reference's schedule-size guard: kernel I's plain
    version for its rows instance."""
    n = origin.shape[1]
    o, d, tm = pad_rays_rows(origin, direction, time, ray_block)
    check_schedule_size(o.shape[1] // ray_block, gscene.n_tiles)
    rec = _grid_hit(gscene, o.T, d.T, tm[0], min_t, ray_block)
    return HitRecordRows(
        hit=rec.hit[None, :n], t=rec.t[None, :n], point=rec.point.T[:, :n],
        normal=rec.normal.T[:, :n], idx=rec.idx[None, :n],
        mat_id=rec.mat_id[None, :n], albedo=rec.albedo.T[:, :n],
        fuzz=rec.fuzz[None, :n], ior=rec.ior[None, :n])
