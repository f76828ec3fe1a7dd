"""Composite scenes: spheres + triangle meshes in one render.

The reference renders spheres only; meshes are a capability extension
(BASELINE.json config 4).  A composite scene runs both geometry sweeps and
keeps the nearer hit per ray (ops/rows.combine_hits_rows), so scatter and
the scheduler only ever see hit records.  The hit functions that do this
are in kernels/dispatch.py.
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
