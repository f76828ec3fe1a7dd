"""Wavefront material scatter, column layout (``win32_raytracer_tpu.ops.scatter``).

The batched, masked-lane form of the material branches of the reference's
recursive ``getColor`` (RayTracer.cpp:604-688): every material is
evaluated for every lane and the results selected by material id.

* Lambertian (RayTracer.cpp:604-617): target = hit + normal + ball point;
  origin offset by epsilon along the normal; attenuation = albedo.
* Metal (RayTracer.cpp:618-635): reflect the unnormalized incoming
  direction, add fuzz * ball point; a scattered direction into the surface
  is absorbed (black).
* Dielectric (RayTracer.cpp:636-688), quirks included: Schlick with
  ni_over_nt (not the IOR), reflect when ``reflect_thres + r < prob``,
  refract with the 2.0 discriminant, attenuation (1, 1, 1), and the origin
  offset signs of each branch.

The ball sample is ``core/rng.sample_unit_ball`` (radius ``u^(1/3)``); the
reference's column path takes ``cbrt``, which can differ in the last
place, so threshold decisions (metal absorb, Schlick reflect) may flip on
a few lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..core import materials as mat
from ..core.rng import sample_unit_ball
from ..core.vec import dot, normalize
from .hit import HitRecord


class ScatterResult(NamedTuple):
    origin: torch.Tensor       # [N, 3] new ray origin
    direction: torch.Tensor    # [N, 3] new ray direction (unnormalized)
    attenuation: torch.Tensor  # [N, 3] throughput multiplier
    alive: torch.Tensor        # [N] bool: False = absorbed (black)


def scatter(scene, direction: torch.Tensor, hit: HitRecord,
            draws: torch.Tensor, cfg: RenderConfig) -> ScatterResult:
    """One scatter event for every lane.  ``draws`` [N, >= 4]: three
    uniforms for the ball sample, one for the dielectric reflect
    decision.  The material rides in the hit record; ``scene`` is unused
    and keeps the reference's signature."""
    del scene
    eps = float(np.float32(cfg.epsilon))
    one_eps = float(np.float32(1.0) - np.float32(cfg.epsilon))
    n, hp = hit.normal, hit.point
    ball = sample_unit_ball(draws[:, 0:3])

    # Lambertian (RayTracer.cpp:604-617); metal shares its origin.
    lam_origin = hp + eps * n
    # (hit + normal + ball) - (hit + eps*normal) = (1-eps)*normal + ball
    lam_dir = one_eps * n + ball

    # Metal (RayTracer.cpp:618-635).
    met_dir = mat.reflect(direction, n) + hit.fuzz[:, None] * ball
    met_ok = dot(met_dir, n) > 0.0

    # Dielectric (RayTracer.cpp:636-688).
    dir_to_light = normalize(-direction)
    entering = dot(dir_to_light, n) > 0.0
    ni_over_nt = torch.where(entering, 1.0 / hit.ior, hit.ior)
    rfn = torch.where(entering[:, None], n, -n)      # ray-facing normal
    offset = eps * n
    refract_offset = torch.where(entering[:, None], -offset, offset)

    cosine = dot(dir_to_light, rfn)
    schlick_arg = ni_over_nt if cfg.schlick_uses_ni_over_nt else hit.ior
    reflect_prob = mat.schlick(cosine, schlick_arg)
    is_reflected = (cfg.reflect_thres + draws[:, 3]) < reflect_prob

    refr_dir, refr_ok = mat.refract(-direction, rfn, ni_over_nt,
                                    cfg.refract_discriminant_bias)
    refl_dir = mat.reflect(direction, n)       # Schlick-reflection branch
    tir_dir = mat.reflect(direction, rfn)      # total internal reflection

    die_dir = torch.where(is_reflected[:, None], refl_dir,
                          torch.where(refr_ok[:, None], refr_dir, tir_dir))
    die_origin = torch.where((is_reflected | ~refr_ok)[:, None],
                             hp - refract_offset, hp + refract_offset)

    # Select by material id.
    is_met = (hit.mat_id == mat.METAL)[:, None]
    is_die = (hit.mat_id == mat.DIELECTRIC)[:, None]
    new_origin = torch.where(is_die, die_origin, lam_origin)
    new_dir = torch.where(is_die, die_dir,
                          torch.where(is_met, met_dir, lam_dir))
    att = torch.where(is_die, 1.0, hit.albedo)
    alive = torch.where(hit.mat_id == mat.METAL, met_ok, True)
    return ScatterResult(origin=new_origin, direction=new_dir,
                         attenuation=att, alive=alive)
