"""Sphere and triangle arrays in the port's padded layout (a frozen copy
of the layout rules of ``win32_raytracer_tpu_torch.scene``)."""

from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
PAD = 128           # rows pad to a multiple of this
PARK = (0.0, -1.0e8, 0.0)   # where padding rows sit: no ray reaches them


class Spheres:
    """Host-side list of spheres; ``arrays()`` lays them out padded."""

    def __init__(self):
        self.rows = []  # (c1, c2, t1, t2, radius, mat, albedo, fuzz, ior)

    def add(self, center, radius, mat, albedo=(0.0, 0.0, 0.0), fuzz=0.0,
            ior=1.0, center2=None, t1=0.0, t2=1.0):
        c1 = tuple(float(v) for v in center)
        c2 = c1 if center2 is None else tuple(float(v) for v in center2)
        self.rows.append((c1, c2, float(t1), float(t2), float(radius),
                          int(mat), tuple(float(v) for v in albedo),
                          float(fuzz), float(ior)))

    def arrays(self) -> dict:
        n = len(self.rows)
        p = max(PAD, -(-n // PAD) * PAD)
        out = {
            "center1": np.zeros((p, 3), np.float32),
            "center2": np.zeros((p, 3), np.float32),
            "t1": np.zeros((p,), np.float32),
            "t2": np.ones((p,), np.float32),
            "radius": np.zeros((p,), np.float32),
            "mat_id": np.zeros((p,), np.int32),
            "albedo": np.zeros((p, 3), np.float32),
            "fuzz": np.zeros((p,), np.float32),
            "ior": np.ones((p,), np.float32),
            "active": np.zeros((p,), bool),
        }
        for i, (c1, c2, t1, t2, r, m, al, fz, io) in enumerate(self.rows):
            out["center1"][i], out["center2"][i] = c1, c2
            out["t1"][i], out["t2"][i], out["radius"][i] = t1, t2, r
            out["mat_id"][i], out["albedo"][i] = m, al
            out["fuzz"][i], out["ior"][i], out["active"][i] = fz, io, True
        out["center1"][n:] = out["center2"][n:] = PARK
        return out


def triangle_arrays(vertices, faces, mat_id, albedo, fuzz, ior) -> dict:
    """Per-face arrays (``mat_id`` [F], ``albedo`` [F, 3]; ``fuzz`` and
    ``ior`` scalars) of a triangle list, padded like the spheres."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    f = len(faces)
    p = max(PAD, -(-f // PAD) * PAD)
    tri = vertices[faces]
    out = {k: np.zeros((p, 3), np.float32) for k in ("v0", "e1", "e2")}
    out["v0"][f:] = PARK
    out["v0"][:f] = tri[:, 0]
    out["e1"][:f] = tri[:, 1] - tri[:, 0]
    out["e2"][:f] = tri[:, 2] - tri[:, 0]
    out["mat_id"] = np.zeros((p,), np.int32)
    out["mat_id"][:f] = mat_id
    out["albedo"] = np.zeros((p, 3), np.float32)
    out["albedo"][:f] = albedo
    out["fuzz"] = np.zeros((p,), np.float32)
    out["fuzz"][:f] = np.float32(fuzz)
    out["ior"] = np.ones((p,), np.float32)
    out["ior"][:f] = np.float32(ior)
    out["active"] = np.zeros((p,), bool)
    out["active"][:f] = True
    return out
