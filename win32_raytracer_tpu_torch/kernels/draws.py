"""The wavefront scheduler's threefry uniform draws (``csrc/draws.cu``).

Replaces no TPU kernel: the JAX package draws with
``jax.random.uniform``, which XLA compiles.  Its plain version,
``core/rng.uniform01``, computes the same bits as ~180 int64 torch ops a
draw; the kernel is bound by its ~75 integer operations an element and
writes 4 bytes an element (the source note in csrc/draws.cu has the
detail).

:func:`uniform01` launches the kernel for a CUDA device and runs the plain
version for the CPU; it raises for anything else.  The wavefront takes its
draws from it where ``kernels/dispatch.resolve_backend`` gives "kernels",
and from :func:`uniform01_plain` under ``backend="jnp"``.  While a render
records, each call counts ``draws.threefry_kernel`` or
``draws.threefry_plain`` by that route (the CPU's kernel route runs the
plain version): the engaged share is kernel / (kernel + plain).
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..utils import profiling
from . import _build

LAUNCHES = 0  # launches of threefry_uniform_kernel by uniform01


def uniform01(key: tuple, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: U[0, 1) f32 on ``device``, bit
    for bit (``core/rng.uniform01``'s bits)."""
    global LAUNCHES
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"threefry uniform01: unsupported device {dev}")
    profiling.count("draws.threefry_kernel")
    if dev.type == "cpu":
        return rng.uniform01(key, shape, device=dev)
    n = math.prod(shape)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n:
        lib = _build.load()
        _build.check(lib.wrt_threefry_uniform(
            int(key[0]), int(key[1]), n, out.data_ptr(),
            _build.stream_handle(dev)), "threefry uniform01")
        LAUNCHES += 1
    return out


def uniform01_plain(key: tuple, shape, device) -> torch.Tensor:
    """``core/rng.uniform01`` on any device: the kernel's reference, the
    draws of ``backend="jnp"``."""
    profiling.count("draws.threefry_plain")
    return rng.uniform01(key, shape, device=device)
