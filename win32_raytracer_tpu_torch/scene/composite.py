"""Composite scenes: spheres + triangle meshes in one render.

The reference renders spheres only; meshes are a capability extension
(BASELINE.json config 4).  A composite scene runs both geometry sweeps and
keeps the nearer hit per ray (ops/rows.combine_hits_rows for the
persistent scheduler, ops/hit_tri.combine_hits for the wavefront), so
scatter and the schedulers only ever see hit records.  The rows hit
functions that do this are in kernels/dispatch.py; :func:`make_hit_fn`
builds the column one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .spheres import SphereScene
from .triangles import TriangleScene


class CompositeScene(NamedTuple):
    spheres: Optional[SphereScene]
    triangles: Optional[TriangleScene]

    @property
    def padded_size(self) -> int:
        return sum(x.padded_size for x in self if x is not None)

    @property
    def device(self) -> torch.device:
        part = self.spheres if self.spheres is not None else self.triangles
        return part.device

    def to(self, device) -> "CompositeScene":
        return CompositeScene(*(None if x is None else x.to(device)
                                for x in self))


def make_hit_fn(scene, sphere_fn, tri_fn=None):
    """Resolve a scene (sphere, triangle or composite; scenes or their
    tables) and a column sphere hit function into one column hit function
    ``f(scene, o, d, t, min_t)``, as ``win32_raytracer_tpu.scene.composite``
    does.  ``tri_fn`` defaults to the plain ``ops/hit_tri.hit_triangles``.
    A composite sweeps spheres, then triangles, and keeps the nearer hit
    (strict, so spheres keep exact ties), triangle indices after the
    spheres'."""
    from ..ops.hit_tri import TriTable, combine_hits, hit_triangles

    if tri_fn is None:
        tri_fn = hit_triangles
    if isinstance(scene, (TriangleScene, TriTable)):
        return tri_fn
    if not isinstance(scene, CompositeScene):
        return sphere_fn
    if scene.spheres is None and scene.triangles is None:
        raise ValueError("empty composite scene")

    def composite(sc, o, d, t, min_t=0.001):
        if sc.spheres is None:
            return tri_fn(sc.triangles, o, d, t, min_t=min_t)
        rec = sphere_fn(sc.spheres, o, d, t, min_t=min_t)
        if sc.triangles is None:
            return rec
        rec_t = tri_fn(sc.triangles, o, d, t, min_t=min_t)
        return combine_hits(rec, rec_t, idx_offset_b=sc.spheres.padded_size)
    return composite
