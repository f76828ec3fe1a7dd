"""Lane-major ("rows") layout: vectors are [3, N], scalars [1, N].

The persistent scheduler's state lives in this layout, as in the JAX
package.  This module holds the rows forms of ops.hit / core.materials /
scene.camera with the reference's quirks (RayTracer.cpp:604-701).  Dot
products are written x*x' + y*y' + z*z' in that order, which is also the
order the CUDA kernels use (csrc/common.cuh).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import MIN_HIT_T, RenderConfig
from ..core import materials as mat
from ..core.vec import sqrt_rn
from ..scene.camera import Camera
from .hit import HitRecord

_TWO_PI = 2.0 * math.pi


class HitRecordRows(NamedTuple):
    """HitRecord in rows layout."""

    hit: torch.Tensor     # [1, N] bool
    t: torch.Tensor       # [1, N] f32
    point: torch.Tensor   # [3, N] f32
    normal: torch.Tensor  # [3, N] f32
    idx: torch.Tensor     # [1, N] int32
    mat_id: torch.Tensor  # [1, N] int32
    albedo: torch.Tensor  # [3, N] f32
    fuzz: torch.Tensor    # [1, N] f32
    ior: torch.Tensor     # [1, N] f32


def combine_hits_rows(a: HitRecordRows, b: HitRecordRows,
                      idx_offset_b: int = 0) -> HitRecordRows:
    """Nearest of two rows hit records (e.g. spheres, then triangles whose
    indices start after the spheres'): strict ``b.t < a.t``, so geometry A
    keeps exact ties."""
    take_b = b.t < a.t
    return HitRecordRows(
        hit=a.hit | b.hit,
        t=torch.where(take_b, b.t, a.t),
        point=torch.where(take_b, b.point, a.point),
        normal=torch.where(take_b, b.normal, a.normal),
        idx=torch.where(take_b, b.idx + idx_offset_b, a.idx),
        mat_id=torch.where(take_b, b.mat_id, a.mat_id),
        albedo=torch.where(take_b, b.albedo, a.albedo),
        fuzz=torch.where(take_b, b.fuzz, a.fuzz),
        ior=torch.where(take_b, b.ior, a.ior),
    )


def rdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[3, N] . [3, N] -> [1, N]."""
    return a[0:1] * b[0:1] + a[1:2] * b[1:2] + a[2:3] * b[2:3]


def rnormalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp_min(sqrt_rn(rdot(a, a)), 1e-37)


def sky_color_rows(d: torch.Tensor) -> torch.Tensor:
    """[3, N] dirs -> [3, N] sky gradient (RayTracer.cpp:690-701)."""
    t = 0.5 * (rnormalize(d)[1:2] + 1.0)
    white = torch.ones((3, 1), dtype=torch.float32, device=d.device)
    tint = torch.tensor([[0.5], [0.7], [1.0]], dtype=torch.float32,
                        device=d.device)
    return (1.0 - t) * white + t * tint


def reflect_rows(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return v - 2.0 * rdot(v, n) * n


def refract_rows(d, n, ni_over_nt, discriminant_bias):
    nd = rnormalize(d)
    dt = rdot(nd, n)
    disc = discriminant_bias - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    refr = (ni_over_nt * (nd - n * dt)
            - n * sqrt_rn(torch.clamp_min(disc, 0.0)))
    return refr, ok


def sample_unit_ball_rows(u: torch.Tensor) -> torch.Tensor:
    """u [3, N] uniforms -> [3, N] points uniform in the unit ball.  The
    radius is exp(log(u)/3) (log(0) -> -inf -> 0), the form the JAX rows
    path and the CUDA bounce kernel use."""
    z = 1.0 - 2.0 * u[0:1]
    phi = _TWO_PI * u[1:2]
    r = torch.exp(torch.log(u[2:3]) * (1.0 / 3.0))
    s = sqrt_rn(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.cat([r * s * torch.cos(phi), r * s * torch.sin(phi), r * z])


def camera_rays_rows(cam: Camera, u: torch.Tensor, v: torch.Tensor,
                     draws: torch.Tensor):
    """u/v [1, N], draws [3, N] -> (origin [3, N], direction [3, N],
    time [1, N]).  The camera's fields are one camera's ([3] vectors, []
    scalars) or one per lane ([3, N] and [1, N]: a multi-frame batch)."""
    def col(f):
        return f if f.dim() == 2 else f[:, None]

    time = cam.shutter_open + (cam.shutter_close - cam.shutter_open) * draws[0:1]
    r = sqrt_rn(draws[1:2]) * cam.lens_radius
    theta = _TWO_PI * draws[2:3]
    offset = (col(cam.right_axis) * (r * torch.cos(theta))
              + col(cam.up_axis) * (r * torch.sin(theta)))
    origin = col(cam.origin) + offset
    direction = (col(cam.lower_left_corner)
                 + u * col(cam.horizontal)
                 + v * col(cam.vertical)
                 - origin)
    return origin, direction, time


class ScatterRowsResult(NamedTuple):
    origin: torch.Tensor       # [3, N]
    direction: torch.Tensor    # [3, N]
    attenuation: torch.Tensor  # [3, N]
    alive: torch.Tensor        # [1, N] bool


def scatter_rows(direction: torch.Tensor, hit: HitRecordRows,
                 draws: torch.Tensor, cfg: RenderConfig) -> ScatterRowsResult:
    """Material scatter, every reference quirk (RayTracer.cpp:604-688)."""
    eps = float(np.float32(cfg.epsilon))
    one_eps = float(np.float32(1.0) - np.float32(cfg.epsilon))
    n, hp = hit.normal, hit.point
    ball = sample_unit_ball_rows(draws[0:3])

    # Lambertian (RayTracer.cpp:604-617); metal shares its origin.
    lam_origin = hp + eps * n
    lam_dir = one_eps * n + ball
    # Metal (RayTracer.cpp:618-635).
    met_dir = reflect_rows(direction, n) + hit.fuzz * ball
    met_ok = rdot(met_dir, n) > 0.0
    # Dielectric (RayTracer.cpp:636-688), quirks included.
    dir_to_light = rnormalize(-direction)
    entering = rdot(dir_to_light, n) > 0.0
    ni_over_nt = torch.where(entering, 1.0 / hit.ior, hit.ior)
    rfn = torch.where(entering, n, -n)
    offset = eps * n
    refract_offset = torch.where(entering, -offset, offset)

    cosine = rdot(dir_to_light, rfn)
    schlick_arg = ni_over_nt if cfg.schlick_uses_ni_over_nt else hit.ior
    reflect_prob = mat.schlick(cosine, schlick_arg)
    is_reflected = (cfg.reflect_thres + draws[3:4]) < reflect_prob

    refr_dir, refr_ok = refract_rows(-direction, rfn, ni_over_nt,
                                     cfg.refract_discriminant_bias)
    refl_dir = reflect_rows(direction, n)
    tir_dir = reflect_rows(direction, rfn)

    die_dir = torch.where(is_reflected, refl_dir,
                          torch.where(refr_ok, refr_dir, tir_dir))
    die_origin = torch.where(is_reflected | ~refr_ok,
                             hp - refract_offset, hp + refract_offset)

    is_met = hit.mat_id == mat.METAL
    is_die = hit.mat_id == mat.DIELECTRIC
    new_origin = torch.where(is_die, die_origin, lam_origin)
    new_dir = torch.where(is_die, die_dir,
                          torch.where(is_met, met_dir, lam_dir))
    att = torch.where(is_die, 1.0, hit.albedo)
    alive = torch.where(is_met, met_ok, True)
    return ScatterRowsResult(origin=new_origin, direction=new_dir,
                             attenuation=att, alive=alive)


def hit_rows_adapter(column_hit_fn):
    """Wrap a column-layout hit function (ops.hit signature) into the rows
    interface: (table, o [3, N], d [3, N], t [1, N], min_t)."""
    def rows_fn(scene, o_r, d_r, t_r, min_t=MIN_HIT_T):
        rec: HitRecord = column_hit_fn(scene, o_r.T, d_r.T, t_r[0],
                                       min_t=min_t)
        return HitRecordRows(
            hit=rec.hit[None], t=rec.t[None], point=rec.point.T,
            normal=rec.normal.T, idx=rec.idx[None], mat_id=rec.mat_id[None],
            albedo=rec.albedo.T, fuzz=rec.fuzz[None], ior=rec.ior[None])
    return rows_fn
