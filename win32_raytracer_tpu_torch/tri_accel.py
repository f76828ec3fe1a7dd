"""Uniform-grid (Morton-tiled) acceleration for the triangle sweep.

The port of ``win32_raytracer_tpu.tri_accel``.  Triangles are sorted by the
Morton code of their centroid (or split recursively at the median of the
widest axis) and cut into tiles of ``tile_rows`` contiguous triangles;
within a tile, members are re-sorted by index so within-tile ties resolve
to the earliest index, like the brute sweep.  Per ray: clip to the scene
box and to ``t_cap`` (a nearer hit from the sphere pass occludes anything
farther); per ray block: min/max-reduce the ray segments' boxes and test the
block box against every tile box, a conservative [NB, T] mask.  Kernel D
(kernels/tri_grid.py) sweeps only the tiles the mask leaves, front to back.

The plain grid sweep here (:func:`hit_triangles_grid_rows_plain`) is kernel
D's plain version and the twin of the reference's
``hit_triangles_grid_rows_jnp``: the masked tiles in tile-id order.  It
matches the brute sweep up to the cross-tile tie rule, and kernel D up to
the visit order on exact ties.  The reference's split-bf16 coefficient
stacks (``tile_coeffs``) are not ported: the port's sweep is exact f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import MIN_HIT_T
from .core.vec import sqrt_rn
from .ops.hit import F32_MAX
from .ops.hit_tri import (
    TRI_ATTR_COLS, _T_ALB, _T_ALR, _T_E1X, _T_E2X, _T_FUZZ, _T_IDX, _T_IOR,
    _T_MAT, _T_V0X, gather_rows, nearest_rows, tri_pair_t,
    tri_record_rows_from_gather,
)
from .ops.rows import HitRecordRows
from .scene.triangles import TriangleScene, triangles_from_numpy

# Tile rows carry one extra all-ones column, as in the reference.
TRI_GRID_COLS = TRI_ATTR_COLS + 1  # 17

_BIG = np.float32(1e8)
_EPS = np.float32(1e-12)

# Rows per tile (the reference's default: fewer, fatter tiles measured
# best there) and rays per schedule block (tri_grid_rows'
# DEFAULT_TRI_GRID_RAY_BLOCK).
DEFAULT_TILE_ROWS = 128
DEFAULT_TRI_GRID_RAY_BLOCK = 2048

# Kernel D's tile boxes on a 1/1024 grid (tri_grid_rows' _TLO_SCALE,
# _TLO_INV and _BX_CLIP): widening a box by a step only passes an extra
# tile, never skips a reachable one.
_TLO_SCALE = np.float32(1024.0)
_TLO_INV = np.float32(1.0 / 1024.0)
_BX_CLIP = np.float32(1.0e6)


class TriGridScene(NamedTuple):
    """A TriangleScene plus its Morton-tiled acceleration arrays.  ``base``
    is untouched, so the brute sweep keeps working on it.  The last two
    fields are kernel D's per-grid tables, derived from the others by
    :func:`make_tri_grid` (build grids with it)."""

    base: TriangleScene
    tile_attrs: torch.Tensor  # [T * St, TRI_GRID_COLS], tile-major
    tile_boxes: torch.Tensor  # [T, 6] f32: x0, x1, y0, y1, z0, z1
    scene_box: torch.Tensor   # [6] f32 union of tile boxes
    tile_geom: torch.Tensor   # [T * St, 12] f32: v0, e1, e2, three zeros
    tile_qboxes: torch.Tensor  # [T, 6] f32: tile_boxes on the 1/1024 grid

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

    def to(self, device) -> "TriGridScene":
        return TriGridScene(self.base.to(device),
                            *(x.to(device) for x in self[1:]))


def quantized_boxes(tile_boxes: torch.Tensor) -> torch.Tensor:
    """[T, 6] tile boxes widened onto the 1/1024 grid (floor - 1 step on
    the low sides, ceil + 1 on the high ones), as kernel D reads them."""
    b = torch.clamp(tile_boxes, -float(_BX_CLIP), float(_BX_CLIP)) * float(_TLO_SCALE)
    q = torch.empty(b.shape, dtype=torch.int32, device=b.device)
    q[:, 0::2] = torch.floor(b[:, 0::2]).to(torch.int32) - 1
    q[:, 1::2] = torch.ceil(b[:, 1::2]).to(torch.int32) + 1
    return (q.to(torch.float32) * float(_TLO_INV)).contiguous()


def packed_geometry(tile_attrs: torch.Tensor) -> torch.Tensor:
    """[T * St, 12] f32: each tile row's v0, e1, e2 and three zeros, the
    three float4s kernel D stages per triangle."""
    g = tile_attrs[:, _T_V0X:_T_V0X + 9]
    return torch.cat([g, g.new_zeros((g.shape[0], 3))], dim=1).contiguous()


def make_tri_grid(base: TriangleScene, tile_attrs: torch.Tensor,
                  tile_boxes: torch.Tensor,
                  scene_box: torch.Tensor) -> TriGridScene:
    """A :class:`TriGridScene` with kernel D's tables made from its
    arrays, once per grid."""
    return TriGridScene(base, tile_attrs, tile_boxes, scene_box,
                        packed_geometry(tile_attrs), quantized_boxes(tile_boxes))


def tri_grid_from_numpy(src, device="cpu") -> TriGridScene:
    """Port grid from any object carrying the reference ``TriGridScene``'s
    fields as arrays (its ``tile_coeffs`` are not read)."""
    def f32(x):
        return torch.as_tensor(np.array(x), dtype=torch.float32,
                               device=device)
    return make_tri_grid(triangles_from_numpy(src.base, device),
                         f32(src.tile_attrs), f32(src.tile_boxes),
                         f32(src.scene_box))


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave three integer grids into Morton codes (up to 21 bits per
    axis; the caller clamps to 1023)."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v
    return (spread(x) | (spread(y) << np.uint64(1))
            | (spread(z) << np.uint64(2)))


def _median_split_order(cen: np.ndarray, st: int) -> np.ndarray:
    """BVH-style tile partition: split the set recursively along the
    widest centroid axis, the cut rounded to a multiple of ``st``, so
    contiguous st-chunks of the returned order are the leaves."""
    n = len(cen)
    out = np.empty(n, np.int64)
    pos = 0
    stack = [np.arange(n, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        if len(idx) <= st:
            out[pos:pos + len(idx)] = idx
            pos += len(idx)
            continue
        c = cen[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        ordax = idx[np.argsort(c[:, ax], kind="stable")]
        n_tiles = -(-len(idx) // st)
        cut = (n_tiles // 2) * st
        # LIFO: push right first so the left half lands first in `out`.
        stack.append(ordax[cut:])
        stack.append(ordax[:cut])
    return out


# Built grids memoised by the identity of the TriangleScene (the reference's
# rule); an entry holds the scene (grid.base), so its id cannot be reused
# while the entry lives.  Bounded FIFO.
_GRID_CACHE: dict = {}
_GRID_CACHE_MAX = 8


def build_tri_grid(scene: TriangleScene, tile_rows: int = DEFAULT_TILE_ROWS,
                   min_tris: int = 512,
                   partition: str = "morton") -> Optional[TriGridScene]:
    """A :class:`TriGridScene` on the scene's device, or None when the mesh
    has fewer than ``min_tris`` active triangles (the brute sweep wins
    there).  ``partition``: "morton" (centroid space-filling-curve cuts) or
    "median" (recursive widest-axis median splits, tighter tile boxes)."""
    key = (id(scene), tile_rows, min_tris, partition)
    cached = _GRID_CACHE.get(key)
    if cached is not None and cached.base is scene:
        return cached
    sc = {f: getattr(scene, f).cpu().numpy() for f in
          ("v0", "e1", "e2", "mat_id", "albedo", "fuzz", "ior", "active")}
    sel = np.flatnonzero(sc["active"])
    if len(sel) < min_tris:
        return None
    sc = {f: v[sel] for f, v in sc.items()}

    # Triangle boxes + centroid tile order.
    vs = np.stack([sc["v0"], sc["v0"] + sc["e1"], sc["v0"] + sc["e2"]])
    lo, hi = vs.min(axis=0), vs.max(axis=0)               # [F, 3]
    cen = 0.5 * (lo + hi)
    if partition == "median":
        order = _median_split_order(cen, tile_rows)
    elif partition == "morton":
        cmin, cmax = cen.min(axis=0), cen.max(axis=0)
        ext = np.maximum(cmax - cmin, 1e-9)
        q = np.clip(((cen - cmin) / ext * 1023.0), 0,
                    1023).astype(np.uint32)
        order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]),
                           kind="stable")
    else:
        raise ValueError(f"unknown partition {partition!r} "
                         "(use morton|median)")

    st = tile_rows
    n_t = -(-len(sel) // st)
    attrs = np.zeros((n_t, st, TRI_GRID_COLS), np.float32)
    boxes = np.empty((n_t, 6), np.float32)
    for t in range(n_t):
        mem = order[t * st:(t + 1) * st]
        mem = mem[np.argsort(sel[mem], kind="stable")]  # earliest-idx ties
        m = len(mem)
        rows = attrs[t, :m]
        rows[:, _T_V0X:_T_V0X + 3] = sc["v0"][mem]
        rows[:, _T_E1X:_T_E1X + 3] = sc["e1"][mem]
        rows[:, _T_E2X:_T_E2X + 3] = sc["e2"][mem]
        rows[:, _T_MAT] = sc["mat_id"][mem]
        rows[:, _T_ALR:_T_ALB + 1] = sc["albedo"][mem]
        rows[:, _T_FUZZ] = sc["fuzz"][mem]
        rows[:, _T_IOR] = sc["ior"][mem]
        rows[:, _T_IDX] = sel[mem]
        # Padding rows: e1 = e2 = 0 -> det = 0 -> rejected.
        attrs[t, :, TRI_ATTR_COLS] = 1.0
        boxes[t] = (lo[mem][:, 0].min(), hi[mem][:, 0].max(),
                    lo[mem][:, 1].min(), hi[mem][:, 1].max(),
                    lo[mem][:, 2].min(), hi[mem][:, 2].max())
    sbox = np.array([boxes[:, 0].min(), boxes[:, 1].max(),
                     boxes[:, 2].min(), boxes[:, 3].max(),
                     boxes[:, 4].min(), boxes[:, 5].max()], np.float32)

    dev = scene.device
    grid = make_tri_grid(
        base=scene,
        tile_attrs=torch.from_numpy(attrs.reshape(n_t * st, TRI_GRID_COLS)).to(dev),
        tile_boxes=torch.from_numpy(boxes).to(dev),
        scene_box=torch.from_numpy(sbox).to(dev))
    if len(_GRID_CACHE) >= _GRID_CACHE_MAX:
        _GRID_CACHE.pop(next(iter(_GRID_CACHE)))
    _GRID_CACHE[key] = grid
    return grid


def _slab(lo_p, hi_p, o, d):
    """Entry and exit t of rays o/d [N] through the slab [lo_p, hi_p] of
    one axis, with +-eps for near-zero d (the reference's convention)."""
    d_safe = torch.where(d.abs() < _EPS,
                         torch.where(d < 0, -float(_EPS), float(_EPS)), d)
    ta = (lo_p - o) / d_safe
    tb = (hi_p - o) / d_safe
    return torch.minimum(ta, tb), torch.maximum(ta, tb)


def clip_segment_to_box(scene_box, origin, direction, t_cap=None,
                        min_t=MIN_HIT_T):
    """(lo_t, hi_t) [N] of each ray's [min_t, t_cap]-clipped chord through
    the [6] scene box (hi_t < lo_t: no touch)."""
    n = origin.shape[1]
    f32 = dict(dtype=torch.float32, device=origin.device)
    lo_t = torch.full((n,), float(np.float32(min_t)), **f32)
    hi_t = torch.full((n,), float(_BIG), **f32)
    if t_cap is not None:
        hi_t = torch.minimum(hi_t, t_cap)
    for ax in range(3):
        near, far = _slab(scene_box[2 * ax], scene_box[2 * ax + 1],
                          origin[ax], direction[ax])
        lo_t = torch.maximum(lo_t, near)
        hi_t = torch.minimum(hi_t, far)
    return lo_t, hi_t


def tri_block_schedule_rows(grid: TriGridScene, origin: torch.Tensor,
                            direction: torch.Tensor,
                            t_cap: Optional[torch.Tensor], min_t: float,
                            ray_block: int):
    """Conservative per-block tile schedule inputs ``(mask, tlo, cap_eff)``
    for rays o/d [3, Np] (Np a multiple of ``ray_block``):

    * ``mask`` [NB, T] int32: 1 where some ray of the block may reach the
      tile (its clipped segment's box overlaps the tile box);
    * ``tlo`` [NB, T] f32: a lower bound on the t at which any ray of the
      block can first touch the tile (the distance from the block's origin
      box to the tile box over the block's largest |d|), the key of kernel
      D's front-to-back order and early exit;
    * ``cap_eff`` [1, Np] f32: each lane's segment end (0 for a lane whose
      segment is empty)."""
    n = origin.shape[1]
    nb = n // ray_block
    lo_t, hi_t = clip_segment_to_box(
        grid.scene_box, origin, direction,
        t_cap=None if t_cap is None else t_cap[0], min_t=min_t)
    empty = lo_t > hi_t

    def block_min(x):
        return torch.where(empty, float(_BIG), x).reshape(nb, ray_block).amin(1)

    def block_max(x):
        return torch.where(empty, -float(_BIG), x).reshape(nb, ray_block).amax(1)

    bx = grid.tile_boxes
    overlap = torch.ones((nb, grid.n_tiles), dtype=torch.bool,
                         device=origin.device)
    o_mins, o_maxs = [], []
    for ax in range(3):
        o, d = origin[ax], direction[ax]
        pa, pb = o + lo_t * d, o + hi_t * d
        lo_b = block_min(torch.minimum(pa, pb))
        hi_b = block_max(torch.maximum(pa, pb))
        overlap &= ((lo_b[:, None] <= bx[None, :, 2 * ax + 1])
                    & (hi_b[:, None] >= bx[None, :, 2 * ax]))
        o_mins.append(block_min(o))
        o_maxs.append(block_max(o))

    d2 = (direction[0] * direction[0] + direction[1] * direction[1]
          + direction[2] * direction[2])
    dmax = sqrt_rn(torch.where(empty, 0.0, d2).reshape(nb, ray_block)
                      .amax(1))
    dist2 = torch.zeros((nb, grid.n_tiles), dtype=torch.float32,
                        device=origin.device)
    for ax in range(3):
        gap = torch.clamp_min(torch.maximum(
            bx[None, :, 2 * ax] - o_maxs[ax][:, None],
            o_mins[ax][:, None] - bx[None, :, 2 * ax + 1]), 0.0)
        dist2 = dist2 + gap * gap
    tlo = torch.clamp_min(
        sqrt_rn(dist2) / torch.clamp_min(dmax, float(_EPS))[:, None],
        float(np.float32(min_t)))
    cap_eff = torch.where(empty, 0.0, hi_t)[None, :]
    return overlap.to(torch.int32), tlo, cap_eff


def pad_rays(origin, direction, t_cap, ray_block: int):
    """Pad rays [3, N] (and t_cap [1, N]) to a multiple of ``ray_block``
    with filler rays parked below everything (o = (0, -1e9, 0),
    d = (0, 0, 1)), whose segments are empty."""
    pad = (-origin.shape[1]) % ray_block
    if not pad:
        return origin, direction, t_cap
    fill_o = origin.new_zeros((3, pad))
    fill_o[1] = -1e9
    fill_d = direction.new_zeros((3, pad))
    fill_d[2] = 1.0
    if t_cap is not None:
        t_cap = torch.cat([t_cap, t_cap.new_zeros((1, pad))], dim=1)
    return (torch.cat([origin, fill_o], dim=1),
            torch.cat([direction, fill_d], dim=1), t_cap)


_LANE_CHUNK = 1 << 16


def hit_triangles_grid_rows_plain(
        grid: TriGridScene, origin: torch.Tensor, direction: torch.Tensor,
        time: torch.Tensor, min_t: float = MIN_HIT_T,
        ray_block: int = DEFAULT_TRI_GRID_RAY_BLOCK,
        t_cap: Optional[torch.Tensor] = None, early_exit: bool = True,
        any_skip: bool = True) -> HitRecordRows:
    """The plain grid sweep: every tile in id order, over the lanes of the
    blocks whose mask row holds it, strict < across tiles and the lowest
    row within one; the winner's row is read once after the sweep.

    ``early_exit`` and ``any_skip`` are kernel D's knobs and change nothing
    here.  A lane's record beyond its segment end (the scene box exit and
    ``t_cap``) is unspecified in both: compare records where t < cap."""
    del time, early_exit, any_skip
    n = origin.shape[1]
    o, d, t_cap = pad_rays(origin, direction, t_cap, ray_block)
    mask = tri_block_schedule_rows(grid, o, d, t_cap, min_t,
                                   ray_block)[0].bool()
    np_ = o.shape[1]
    best_t = torch.full((np_,), F32_MAX, dtype=torch.float32, device=o.device)
    best_row = torch.full((np_,), -1, dtype=torch.int64, device=o.device)
    st = grid.tile_rows
    in_block = torch.arange(ray_block, device=o.device)
    for tile, blocks in enumerate(mask.T.cpu()):
        blocks = torch.nonzero(blocks)[:, 0].to(o.device)
        if not len(blocks):
            continue
        lanes = (blocks[:, None] * ray_block + in_block).reshape(-1)
        tl = grid.tile_attrs[tile * st:(tile + 1) * st]
        for c0 in range(0, len(lanes), _LANE_CHUNK):
            ln = lanes[c0:c0 + _LANE_CHUNK]
            tile_t, first = nearest_rows(
                tri_pair_t(tl, o[:, ln], d[:, ln], min_t))
            better = tile_t < best_t[ln]
            best_t[ln] = torch.where(better, tile_t, best_t[ln])
            best_row[ln] = torch.where(better, tile * st + first,
                                       best_row[ln])
    rec = tri_record_rows_from_gather(o, d, best_t[None],
                                      gather_rows(grid.tile_attrs, best_row))
    return HitRecordRows(*(x[:, :n] for x in rec))
