"""Random number generation.

1. ``ReferenceLcg`` — bit-faithful reproduction of the reference's SIMD
   "fast rand" (RayTracer.cpp:31-58), seeded 666 like every reference
   ``ThreadContext`` (RayTracer.cpp:27), so the scene builders lay out the
   reference's exact spheres.  Four independent 32-bit LCG lanes

       s0' = s0 * 214013 + 2531011     s1' = s1 * 17405 + 10395331
       s2' = s2 * 214013 + 13737667    s3' = s3 * 69069 + 1   (mod 2**32)

   from state (seed+1, seed, seed+1, seed); floats are
   ``(float(int32(s)) / 2^31 + 1) * 0.5``.

2. ``hash_uniform01`` — the persistent scheduler's counter-based draws,
   bit-identical to the JAX package's: (salt, step, row, lane) through two
   murmur3 finalizers.  torch has no uint32 multiply or shift on the CPU,
   so the uint32 arithmetic runs in int64 with the product split into
   16-bit halves and masked back to 32 bits (no int64 overflow anywhere).

3. ``prng_key`` / ``fold_in`` / ``uniform01`` — the wavefront scheduler's
   draws: ``jax.random``'s threefry-2x32 keys and uniforms, bit for bit,
   in the form JAX uses with ``jax_threefry_partitionable`` on (the
   default since JAX 0.5): a key is a pair of uint32, ``fold_in(key, x)``
   hashes the counter pair (0, x), and ``uniform01`` hashes each element's
   flat index split into (hi, lo) words, xors the two output words and
   keeps 23 mantissa bits.  Keys are Python ints folded on the host; only
   the bulk hash runs as int64 tensor ops (add, xor, shift) masked to
   32 bits: the plain version of the draw kernel (kernels/draws.py),
   which the wavefront takes on a card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .vec import sqrt_rn

_LCG_MUL = np.array([214013, 17405, 214013, 69069], dtype=np.uint32)
_LCG_ADD = np.array([2531011, 10395331, 13737667, 1], dtype=np.uint32)

#: 2^31 as f32 — what ``_mm_cvtepi32_ps(INT_MAX)`` evaluates to.
_F_MAX = np.float32(2147483648.0)

_M32 = 0xFFFFFFFF
_K1 = 0x85EBCA6B
_K2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_INV24 = 1.0 / (1 << 24)


def lcg_init_state(seed: int = 666) -> np.ndarray:
    """Initial 4-lane state for the reference LCG (RayTracer.cpp:63-66)."""
    s = np.uint32(seed)
    return np.array([s + 1, s, s + 1, s], dtype=np.uint32)


def lcg_step(state: np.ndarray) -> np.ndarray:
    """One LCG step over the 4 lanes (uint32 wraparound)."""
    return (state * _LCG_MUL + _LCG_ADD).astype(np.uint32)


def lcg_floats(state: np.ndarray) -> np.ndarray:
    """Lane state -> 4 floats in [0, 1) (RayTracer.cpp:49-53)."""
    as_i32 = state.view(np.int32) if state.dtype == np.uint32 else state
    return ((as_i32.astype(np.float32) / _F_MAX) + np.float32(1.0)) * np.float32(0.5)


class ReferenceLcg:
    """Host-side ``ptr::ThreadContext::rand_sse``: each :meth:`rand4`
    advances the state once and returns its 4 floats."""

    def __init__(self, seed: int = 666):
        self.state = lcg_init_state(seed)

    def rand4(self) -> np.ndarray:
        self.state = lcg_step(self.state)
        return lcg_floats(self.state)

    def stream(self, n_calls: int) -> np.ndarray:
        out = np.empty((n_calls, 4), dtype=np.float32)
        for i in range(n_calls):
            out[i] = self.rand4()
        return out


def _fmix32_int(x: int) -> int:
    """murmur3's 32-bit finalizer on a Python int."""
    x ^= x >> 16
    x = (x * _K1) & _M32
    x ^= x >> 13
    x = (x * _K2) & _M32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a uint32 constant:
    both partial products stay below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _K1)
    x = x ^ (x >> 13)
    x = _mul32(x, _K2)
    return x ^ (x >> 16)


def hash_uniform01(shape, salt, step, purpose: int,
                   device=None) -> torch.Tensor:
    """Counter-based U[0,1) f32 draws, [rows, N] (lane = column index).

    ``salt`` is taken as its uint32 bits, ``step`` as int32 cast to uint32;
    the (step, row) part of the counter is lane-independent and is hashed
    on the host."""
    rows, n = shape
    s = _fmix32_int((((int(step) & _M32) * _GOLDEN) & _M32)
                    ^ (int(salt) & _M32) ^ (purpose & _M32))
    row_keys = torch.tensor(
        [_fmix32_int((s + r * _K1) & _M32) for r in range(rows)],
        dtype=torch.int64, device=device)
    lane = torch.arange(n, dtype=torch.int64, device=device)
    x = _fmix32(lane[None, :] ^ row_keys[:, None])
    return (x >> 8).to(torch.float32) * _INV24


_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def _threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) under the
    key (k1, k2): the rounds and key injections of JAX's
    ``_threefry2x32_lowering``.  The words are Python ints or int64
    tensors in [0, 2^32)."""
    ks = (k1, k2, k1 ^ k2 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ (((x1 << r) & _M32) | (x1 >> (32 - r)))
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``: the pair (0, seed mod 2^32), as JAX
    builds it with 64-bit mode off."""
    return (0, int(seed) & _M32)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data mod 2^32), on the host."""
    return _threefry2x32(key[0], key[1], 0, int(data) & _M32)


def uniform01(key: tuple, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: U[0, 1) f32, bit for bit."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    hi = idx >> 32 if n > _M32 else 0
    b1, b2 = _threefry2x32(key[0], key[1], hi, idx & _M32)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)


def sample_unit_ball(u: torch.Tensor) -> torch.Tensor:
    """u[..., 3] uniforms -> points uniform in the unit ball (analytic
    replacement for RayTracer.cpp:187-200's rejection loop)."""
    z = 1.0 - 2.0 * u[..., 0]
    phi = (2.0 * math.pi) * u[..., 1]
    r = torch.pow(u[..., 2], 1.0 / 3.0)
    s = sqrt_rn(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * s * torch.cos(phi), r * s * torch.sin(phi), r * z],
                       dim=-1)


def sample_unit_disc(u: torch.Tensor) -> torch.Tensor:
    """u[..., 2] uniforms -> points uniform on the unit disc, z = 0
    (RayTracer.cpp:203-216)."""
    r = sqrt_rn(u[..., 0])
    theta = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                        torch.zeros_like(r)], dim=-1)
