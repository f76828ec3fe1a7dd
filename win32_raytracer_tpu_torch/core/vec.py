"""Vec3 helpers over ``[..., 3]`` tensors.

Sums are written out term by term (x + y) + z so every device evaluates
them in the same order as the reference's ``jnp.sum`` over three values.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length_sq(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_sq(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """``a / max(|a|, 1e-37)`` (SimpleMath ``Vector3::Normalize``)."""
    return a / torch.clamp_min(length(a), 1e-37)[..., None]
