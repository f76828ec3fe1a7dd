"""Hit backend selection (the sphere branch of the reference's
``kernels/dispatch.py``).

``cfg.backend``: "auto" routes through the kernel wrappers, which launch
the CUDA kernels for tensors on a card and run their plain versions for
tensors on the CPU; "pallas" asks for the CUDA kernels and raises off a
card; "jnp" runs the plain torch ops on any device (the kernels'
reference, as the jnp path is the JAX package's).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from .hit import hit_spheres_rows, hit_spheres_rows_plain


def resolve_backend(cfg: RenderConfig, device) -> str:
    """"kernels" or "plain".

    "plain" comes only from an explicit ``backend="jnp"``: on a card it is
    the reference path that chip_smoke.py's small render (phase 4) holds
    the kernels against, and nothing selects it implicitly.  "auto", the
    default, always resolves to the kernel wrappers."""
    device = torch.device(device)
    if cfg.backend == "auto":
        return "kernels"
    if cfg.backend == "pallas":
        if device.type != "cuda":
            raise ValueError("backend='pallas' selects the CUDA kernels and "
                             f"needs a CUDA device (got {device})")
        return "kernels"
    if cfg.backend == "jnp":
        return "plain"
    raise ValueError(f"unknown backend {cfg.backend!r} (use auto|pallas|jnp)")


def get_hit_fn_rows(cfg: RenderConfig, device):
    """Rows-layout sphere hit function for the persistent scheduler."""
    if resolve_backend(cfg, device) == "kernels":
        return hit_spheres_rows
    return hit_spheres_rows_plain
