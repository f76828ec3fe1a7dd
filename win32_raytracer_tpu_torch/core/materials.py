"""Material scatter math (reference helpers, batched over ``[..., 3]``).

* ``quantize``  — [-1,1] -> [0,1] (RayTracer.cpp:139-143)
* ``reflect``   — mirror reflection (RayTracer.cpp:146-152)
* ``refract``   — Snell refraction with the reference's **2.0** discriminant
                  quirk (RayTracer.cpp:155-175); returns (dir, ok_mask)
* ``schlick``   — Fresnel approximation (RayTracer.cpp:178-184)

Material ids match the reference enum order (RayTracer.cpp:93-98).
"""

from __future__ import annotations

import torch

from .vec import dot, normalize, sqrt_rn

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2


def quantize(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x + 1.0)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``v - 2 (v.n) n``; v need not be normalized."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(d: torch.Tensor, n: torch.Tensor, ni_over_nt: torch.Tensor,
            discriminant_bias: float = 2.0):
    """Refract ``d`` (normalized internally) about ``n``; the discriminant
    is ``bias - ni_over_nt^2 (1 - dt^2)``.  Returns (refracted, ok)."""
    nd = normalize(d)
    dt = dot(nd, n)
    disc = discriminant_bias - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    safe = sqrt_rn(torch.clamp_min(disc, 0.0))
    refr = ni_over_nt[..., None] * (nd - n * dt[..., None]) - n * safe[..., None]
    return refr, ok


def schlick(cos_theta: torch.Tensor, refractive_index) -> torch.Tensor:
    r0 = (1.0 - refractive_index) / (1.0 + refractive_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cos_theta, 5.0)


def sky_color(d: torch.Tensor) -> torch.Tensor:
    """Background gradient on normalized dir.y (RayTracer.cpp:690-701)."""
    t = quantize(normalize(d)[..., 1])[..., None]
    white = torch.ones(3, dtype=torch.float32, device=d.device)
    tint = torch.tensor([0.5, 0.7, 1.0], dtype=torch.float32, device=d.device)
    return (1.0 - t) * white + t * tint
