"""Ray-sphere intersection, plain torch (the sphere kernel's reference).

Semantics of the reference's sweep (RayTracer.cpp:433-589) in exact f32:
near root only, ``discriminant >= 0``, ``t > min_t``, strictly nearer wins
so the earliest sphere index keeps exact ties, inactive (padding) spheres
masked, centers lerped by shutter time (RayTracer.cpp:449-452), normal =
(point - center) / radius with a radius-0 guard.

The sweep is tiled over spheres and chunked over rays so it never holds
an [N, S] array, and the winner's attributes are fetched by index.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..config import MIN_HIT_T
from ..core.vec import sqrt_rn
from ..scene.spheres import SphereScene

# No-hit sentinel (the reference's numeric_limits<float>::max stand-in).
F32_MAX = 1e30

# Packed attribute-matrix columns (see _attr_matrix).
_A_C1X, _A_C1Y, _A_C1Z = 0, 1, 2
_A_DCX, _A_DCY, _A_DCZ = 3, 4, 5
_A_T1, _A_INVDT, _A_RADIUS = 6, 7, 8
_A_MAT, _A_ALR, _A_ALG, _A_ALB = 9, 10, 11, 12
_A_FUZZ, _A_IOR, _A_IDX = 13, 14, 15
ATTR_COLS = 16

_RAY_CHUNK = 1 << 16


class HitRecord(NamedTuple):
    """Batched ``ptr::HitRecord`` (RayTracer.cpp:120-127) with the winning
    sphere's material selected."""

    hit: torch.Tensor     # [N] bool
    t: torch.Tensor       # [N] f32 (F32_MAX where no hit)
    point: torch.Tensor   # [N, 3] f32
    normal: torch.Tensor  # [N, 3] f32
    idx: torch.Tensor     # [N] int32 (0 where no hit)
    mat_id: torch.Tensor  # [N] int32
    albedo: torch.Tensor  # [N, 3] f32
    fuzz: torch.Tensor    # [N] f32
    ior: torch.Tensor     # [N] f32


class SphereTable(NamedTuple):
    """What the sweep reads: the packed attribute matrix and the active
    mask.  Built once per render (``sphere_table``)."""

    attrs: torch.Tensor   # [S, ATTR_COLS] f32
    active: torch.Tensor  # [S] bool

    @property
    def padded_size(self) -> int:
        return self.attrs.shape[0]


def _attr_matrix(scene: SphereScene) -> torch.Tensor:
    """Per-sphere attributes packed into one [S, 16] f32 matrix."""
    s = scene.padded_size
    dc = scene.center2 - scene.center1
    idx_f = torch.arange(s, dtype=torch.float32, device=scene.device)
    return torch.stack([
        scene.center1[:, 0], scene.center1[:, 1], scene.center1[:, 2],
        dc[:, 0], dc[:, 1], dc[:, 2],
        scene.t1, 1.0 / (scene.t2 - scene.t1), scene.radius,
        scene.mat_id.to(torch.float32),
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.fuzz, scene.ior, idx_f,
    ], dim=1).contiguous()


def sphere_table(scene: Union[SphereScene, SphereTable]) -> SphereTable:
    if isinstance(scene, SphereTable):
        return scene
    return SphereTable(_attr_matrix(scene), scene.active.contiguous())


def _sweep(tab: SphereTable, origin, direction, time, min_t, tile):
    """(best t [n], winner index [n] int64, -1 where no hit)."""
    n = origin.shape[0]
    dev = origin.device
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    a = dx * dx + dy * dy + dz * dz            # [n, 1] (d need not be unit)
    tcol = time[:, None]
    best_t = torch.full((n,), F32_MAX, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    s = tab.attrs.shape[0]
    for s0 in range(0, s, tile):
        tl = tab.attrs[s0:s0 + tile]
        act = tab.active[s0:s0 + tile][None, :]
        lerp = (tcol - tl[:, _A_T1][None, :]) * tl[:, _A_INVDT][None, :]
        cx = tl[:, _A_C1X][None, :] + tl[:, _A_DCX][None, :] * lerp
        cy = tl[:, _A_C1Y][None, :] + tl[:, _A_DCY][None, :] * lerp
        cz = tl[:, _A_C1Z][None, :] + tl[:, _A_DCZ][None, :] * lerp
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b_half = dx * ocx + dy * ocy + dz * ocz
        r = tl[:, _A_RADIUS][None, :]
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b_half * b_half - a * c          # = discriminant / 4
        t = (-b_half - sqrt_rn(torch.clamp_min(disc, 0.0))) / a
        valid = (disc >= 0.0) & (t > min_t) & act
        t = torch.where(valid, t, F32_MAX)
        tile_t = t.min(dim=1).values
        cols = torch.arange(t.shape[1], device=dev)
        first = torch.where(t == tile_t[:, None], cols, t.shape[1]).min(dim=1).values
        better = tile_t < best_t
        best_t = torch.where(better, tile_t, best_t)
        best_i = torch.where(better, s0 + first, best_i)
    return best_t, best_i


def hit_spheres(scene: Union[SphereScene, SphereTable], origin: torch.Tensor,
                direction: torch.Tensor, time: torch.Tensor,
                min_t: float = MIN_HIT_T, tile: int = 128) -> HitRecord:
    """Nearest front-face hit of each ray ([N, 3] origin/direction, [N]
    time) against every active sphere."""
    tab = sphere_table(scene)
    n = origin.shape[0]
    parts = [_sweep(tab, origin[r0:r0 + _RAY_CHUNK],
                    direction[r0:r0 + _RAY_CHUNK], time[r0:r0 + _RAY_CHUNK],
                    min_t, tile)
             for r0 in range(0, max(n, 1), _RAY_CHUNK)]
    best_t = torch.cat([p[0] for p in parts])[:n]
    best_i = torch.cat([p[1] for p in parts])[:n]

    hit = best_t < F32_MAX
    g = torch.where(hit[:, None], tab.attrs[best_i.clamp_min(0)], 0.0)
    t_safe = torch.where(hit, best_t, 0.0)
    point = origin + t_safe[:, None] * direction
    lerp = (time - g[:, _A_T1]) * g[:, _A_INVDT]
    center = g[:, _A_C1X:_A_C1Z + 1] + g[:, _A_DCX:_A_DCZ + 1] * lerp[:, None]
    radius = g[:, _A_RADIUS]
    denom = torch.where(radius == 0.0, 1.0, radius)
    normal = (point - center) / denom[:, None]
    return HitRecord(
        hit=hit, t=best_t, point=point, normal=normal,
        idx=g[:, _A_IDX].to(torch.int32), mat_id=g[:, _A_MAT].to(torch.int32),
        albedo=g[:, _A_ALR:_A_ALB + 1], fuzz=g[:, _A_FUZZ], ior=g[:, _A_IOR])
