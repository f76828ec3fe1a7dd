"""The RTIOW final scene as the reference's ``generateRandomScene``
(RayTracer.cpp:768-891) lays it out: a ground sphere, three hero spheres
and a 22 x 22 jittered grid of small spheres drawn by the reference's
four-lane LCG at seed 666 (RayTracer.cpp:31-66), 488 spheres in all."""

from __future__ import annotations

import numpy as np

from .common import DIELECTRIC, LAMBERTIAN, METAL, Spheres

_MUL = np.array([214013, 17405, 214013, 69069], dtype=np.uint32)
_ADD = np.array([2531011, 10395331, 13737667, 1], dtype=np.uint32)


class Lcg:
    """``ThreadContext::rand_sse``: four 32-bit LCG lanes from state
    (seed+1, seed, seed+1, seed); each draw advances them once and maps
    each to ``(float(int32(s)) / 2^31 + 1) / 2`` in f32."""

    def __init__(self, seed: int = 666):
        s = np.uint32(seed)
        self.state = np.array([s + 1, s, s + 1, s], dtype=np.uint32)

    def rand4(self) -> np.ndarray:
        self.state = (self.state * _MUL + _ADD).astype(np.uint32)
        f = self.state.view(np.int32).astype(np.float32)
        return (f / np.float32(2147483648.0) + np.float32(1.0)) * np.float32(0.5)


def build() -> dict:
    lcg = Lcg(666)
    s = Spheres()
    s.add((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
    s.add((0.0, 1.0, 0.0), 1.0, DIELECTRIC, ior=1.5)
    s.add((-4.0, 1.0, 0.0), 1.0, LAMBERTIAN, albedo=(0.4, 0.2, 0.1))
    s.add((4.0, 1.0, 0.0), 1.0, METAL, albedo=(0.7, 0.6, 0.5), fuzz=0.0)
    for a in range(-11, 11):
        for c in range(-11, 11):
            r = lcg.rand4()
            center = (a + 0.9 * float(r[0]), 0.2, c + 0.9 * float(r[1]))
            choice = float(r[2])
            if choice < 0.8:       # lambertian, moving up 3 over [0, 1]
                r = lcg.rand4()
                color = (float(r[0] * r[1]), float(r[1] * r[2]),
                         float(r[2] * r[3]))
                s.add(center, 0.2, LAMBERTIAN, albedo=color,
                      center2=(center[0], center[1] + 3.0, center[2]))
            elif choice < 0.95:    # metal
                r = lcg.rand4()
                color = (0.5 * (1.0 + float(r[1])), 0.5 * (1.0 + float(r[2])),
                         0.5 * (1.0 + float(r[3])))
                s.add(center, 0.2, METAL, albedo=color, fuzz=0.5 * float(r[0]))
            else:                  # dielectric
                s.add(center, 0.2, DIELECTRIC, ior=1.5)
    return {"spheres": s.arrays(), "triangles": None}
