"""Ray-triangle intersection, plain torch (the triangle kernels' reference).

Two-sided Moller-Trumbore in exact f32, in the operation order of the
reference's sweep (``win32_raytracer_tpu/ops/hit_tri.py``) and of the CUDA
kernels (csrc/common.cuh ``tri_pair_geom``): triangles with ``|det| < 1e-9``
are rejected, the nearest ``t > min_t`` wins and the earliest index keeps
exact ties; inactive (padding) triangles are masked.  The shading normal is
the unit geometric normal e1 x e2; entering and exiting are resolved by the
material math, as for spheres.

The sweeps take rows ([3, N] rays, records as ``HitRecordRows``; the
persistent scheduler) or columns (:func:`hit_triangles`, [N, 3] rays and a
column ``HitRecord``; the wavefront scheduler), with the same arithmetic.
The brute sweep is tiled over triangles and chunked over rays so it never
holds an [N, T] array, and the winner's attributes are fetched by index.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from ..config import MIN_HIT_T
from ..core.vec import sqrt_rn
from ..scene.triangles import TriangleScene
from .hit import F32_MAX, HitRecord
from .rows import HitRecordRows

# Packed triangle attribute columns.
_T_V0X, _T_V0Y, _T_V0Z = 0, 1, 2
_T_E1X, _T_E1Y, _T_E1Z = 3, 4, 5
_T_E2X, _T_E2Y, _T_E2Z = 6, 7, 8
_T_MAT, _T_ALR, _T_ALG, _T_ALB = 9, 10, 11, 12
_T_FUZZ, _T_IOR, _T_IDX = 13, 14, 15
TRI_ATTR_COLS = 16

_DET_EPS = np.float32(1e-9)

_RAY_CHUNK = 1 << 16


class TriTable(NamedTuple):
    """What the brute sweep reads: the packed attribute matrix and the
    active mask.  Built once per render (``tri_table``)."""

    attrs: torch.Tensor   # [T, TRI_ATTR_COLS] f32
    active: torch.Tensor  # [T] bool

    @property
    def padded_size(self) -> int:
        return self.attrs.shape[0]


def tri_attr_matrix(scene: TriangleScene) -> torch.Tensor:
    """Per-triangle attributes packed into one [T, 16] f32 matrix."""
    idx_f = torch.arange(scene.padded_size, dtype=torch.float32,
                         device=scene.device)
    return torch.stack([
        scene.v0[:, 0], scene.v0[:, 1], scene.v0[:, 2],
        scene.e1[:, 0], scene.e1[:, 1], scene.e1[:, 2],
        scene.e2[:, 0], scene.e2[:, 1], scene.e2[:, 2],
        scene.mat_id.to(torch.float32),
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.fuzz, scene.ior, idx_f,
    ], dim=1).contiguous()


def tri_table(scene: Union[TriangleScene, TriTable]) -> TriTable:
    if isinstance(scene, TriTable):
        return scene
    return TriTable(tri_attr_matrix(scene), scene.active.contiguous())


def tri_pair_t(tl: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
               min_t: float) -> torch.Tensor:
    """Moller-Trumbore of rays o/d [3, R] against triangle rows ``tl``
    [S, >= 9] (_T_* columns): the [S, R] t of each valid hit, F32_MAX
    elsewhere.  ``1 / det`` divides tensor by tensor, an IEEE division on
    every device (torch turns division by a Python scalar into a
    multiplication by its reciprocal on a card)."""
    ox, oy, oz = o[0:1], o[1:2], o[2:3]
    dx, dy, dz = d[0:1], d[1:2], d[2:3]

    def col(c):
        return tl[:, c:c + 1]

    e1x, e1y, e1z = col(_T_E1X), col(_T_E1Y), col(_T_E1Z)
    e2x, e2y, e2z = col(_T_E2X), col(_T_E2Y), col(_T_E2Z)
    px = dy * e2z - dz * e2y                              # pvec = d x e2
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() >= float(_DET_EPS)
    one = det.new_ones(())
    inv_det = one / torch.where(ok, det, one)
    tx = ox - col(_T_V0X)                                 # tvec = o - v0
    ty = oy - col(_T_V0Y)
    tz = oz - col(_T_V0Z)
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y                              # qvec = tvec x e1
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > min_t)
    return torch.where(valid, t, F32_MAX)


def nearest_rows(t: torch.Tensor):
    """(nearest t [R], its first row [R] int64) of an [S, R] t matrix."""
    tmin = t.min(dim=0).values
    rows = torch.arange(t.shape[0], device=t.device)[:, None]
    first = torch.where(t == tmin, rows, t.shape[0]).min(dim=0).values
    return tmin, first


def _sweep(tab: TriTable, o, d, min_t, tile):
    """(best t [R], winner row [R] int64, -1 where no hit)."""
    r = o.shape[1]
    best_t = torch.full((r,), F32_MAX, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    for s0 in range(0, tab.attrs.shape[0], tile):
        t = tri_pair_t(tab.attrs[s0:s0 + tile], o, d, min_t)
        t = torch.where(tab.active[s0:s0 + tile, None], t, F32_MAX)
        tile_t, first = nearest_rows(t)
        better = tile_t < best_t
        best_t = torch.where(better, tile_t, best_t)
        best_i = torch.where(better, s0 + first, best_i)
    return best_t, best_i


def gather_rows(table: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """[C, N] attribute rows of the winners ``row`` [N] of a [*, C] table
    (all zero where row < 0, a miss), read by index."""
    g = table[row.clamp_min(0)]
    return torch.where(row[:, None] >= 0, g, 0.0).T


def hit_triangles_rows(scene: Union[TriangleScene, TriTable],
                       origin: torch.Tensor, direction: torch.Tensor,
                       time: torch.Tensor, min_t: float = MIN_HIT_T,
                       tile: int = 128) -> HitRecordRows:
    """Nearest two-sided hit of rays o/d [3, N] against every active
    triangle (``time`` is unused: meshes are static; it keeps the hit
    function's signature)."""
    del time
    tab = tri_table(scene)
    n = origin.shape[1]
    parts = [_sweep(tab, origin[:, r0:r0 + _RAY_CHUNK],
                    direction[:, r0:r0 + _RAY_CHUNK], min_t, tile)
             for r0 in range(0, max(n, 1), _RAY_CHUNK)]
    best_t = torch.cat([p[0] for p in parts])[:n]
    best_i = torch.cat([p[1] for p in parts])[:n]
    return tri_record_rows_from_gather(origin, direction, best_t[None],
                                       gather_rows(tab.attrs, best_i))


def tri_record_rows_from_gather(o, d, t_out, g) -> HitRecordRows:
    """HitRecordRows from the nearest t [1, N] (F32_MAX on a miss) and the
    winner's attribute rows ``g`` [TRI_ATTR_COLS+, N] (_T_* layout): the
    epilogue the plain sweeps share with the kernels (csrc/common.cuh
    ``tri_winner_record``) — hit flag, point, the unit cross-product
    normal and the attribute rows."""
    hit = t_out < F32_MAX
    t_safe = torch.where(hit, t_out, 0.0)
    point = o + t_safe * d
    e1 = g[_T_E1X:_T_E1X + 3]
    e2 = g[_T_E2X:_T_E2X + 3]
    gx = e1[1:2] * e2[2:3] - e1[2:3] * e2[1:2]
    gy = e1[2:3] * e2[0:1] - e1[0:1] * e2[2:3]
    gz = e1[0:1] * e2[1:2] - e1[1:2] * e2[0:1]
    norm = sqrt_rn(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-30))
    normal = torch.cat([gx, gy, gz], dim=0) / norm
    return HitRecordRows(
        hit=hit, t=t_out, point=point, normal=normal,
        idx=g[_T_IDX:_T_IDX + 1].to(torch.int32),
        mat_id=g[_T_MAT:_T_MAT + 1].to(torch.int32),
        albedo=g[_T_ALR:_T_ALB + 1], fuzz=g[_T_FUZZ:_T_FUZZ + 1],
        ior=g[_T_IOR:_T_IOR + 1])


def hit_triangles(scene: Union[TriangleScene, TriTable], origin: torch.Tensor,
                  direction: torch.Tensor, time: torch.Tensor,
                  min_t: float = MIN_HIT_T, tile: int = 128) -> HitRecord:
    """Column form of :func:`hit_triangles_rows`: rays o/d [N, 3], ``time``
    [N] (unused), a column ``HitRecord`` (``ops.hit_tri.hit_triangles`` of
    the JAX package).  The same sweep runs on the transposed views."""
    rec = hit_triangles_rows(scene, origin.T, direction.T, time[None],
                             min_t=min_t, tile=tile)
    return HitRecord(
        hit=rec.hit[0], t=rec.t[0], point=rec.point.T, normal=rec.normal.T,
        idx=rec.idx[0], mat_id=rec.mat_id[0], albedo=rec.albedo.T,
        fuzz=rec.fuzz[0], ior=rec.ior[0])


def combine_hits(a: HitRecord, b: HitRecord, idx_offset_b: int = 0) -> HitRecord:
    """Nearest of two column hit records (spheres, then triangles whose
    indices start after the spheres'): strict ``b.t < a.t``, so geometry A
    keeps exact ties."""
    take_b = b.t < a.t
    tb = take_b[:, None]
    return HitRecord(
        hit=a.hit | b.hit,
        t=torch.where(take_b, b.t, a.t),
        point=torch.where(tb, b.point, a.point),
        normal=torch.where(tb, b.normal, a.normal),
        idx=torch.where(take_b, b.idx + idx_offset_b, a.idx),
        mat_id=torch.where(take_b, b.mat_id, a.mat_id),
        albedo=torch.where(tb, b.albedo, a.albedo),
        fuzz=torch.where(take_b, b.fuzz, a.fuzz),
        ior=torch.where(take_b, b.ior, a.ior),
    )
