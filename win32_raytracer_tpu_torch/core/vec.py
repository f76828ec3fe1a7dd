"""Vec3 helpers over ``[..., 3]`` tensors.

Sums are written out term by term (x + y) + z so every device evaluates
them in the same order as the reference's ``jnp.sum`` over three values.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``x`` (IEEE sqrt, as CUDA's
    ``sqrtf`` and ``torch.sqrt`` on a card give it).

    On the CPU ``torch.sqrt`` is not: it rounds about 0.6% of f32 inputs to
    a neighbour of the right value, and the first call in a process with
    several threads has returned values thousands of ulps off for one
    thread's share of the elements, in f32 and in f64 (ROADMAP Queue 3).
    There numpy takes the root: its loops issue the processor's IEEE square
    root, one thread, whatever torch's thread count."""
    if x.device.type != "cpu" or x.dtype not in (torch.float32, torch.float64):
        return torch.sqrt(x)
    a = x.detach().numpy()
    out = np.empty(a.shape, a.dtype)
    with np.errstate(invalid="ignore"):
        np.sqrt(a, out=out)
    return torch.from_numpy(out)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length_sq(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(length_sq(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """``a / max(|a|, 1e-37)`` (SimpleMath ``Vector3::Normalize``)."""
    return a / torch.clamp_min(length(a), 1e-37)[..., None]
