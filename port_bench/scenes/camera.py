"""Cameras the benchmark makes itself: the thin-lens basis of
RayTracer.cpp:237-274 in f32 numpy, the reference's hard-coded view
(RayTracer.cpp:903-915) and points on an orbit around its target.

A camera is a dict of arrays in the field order of the port's ``Camera``;
the port takes it through ``scene.camera.camera_from_numpy``, the plain
reference reads it as it is."""

from __future__ import annotations

import math
import types

import numpy as np

FIELDS = ("origin", "lower_left_corner", "horizontal", "vertical",
          "right_axis", "up_axis", "lens_radius", "shutter_open",
          "shutter_close")
LOOK_FROM = (15.0, 2.0, 4.0)     # RayTracer.cpp:906
LOOK_TO = (0.0, 1.0, 0.0)
UP = (0.0, 1.0, 0.0)
VFOV = 20.0
APERTURE = 0.1
SHUTTER = (0.0, 0.05)            # RayTracer.cpp:233-234


def make_camera(look_from, look_to, aspect: float, vfov: float = VFOV,
                aperture: float = APERTURE, up=UP) -> dict:
    """Camera basis in f32, focused on ``look_to``."""
    look_from = np.asarray(look_from, np.float32)
    look_to = np.asarray(look_to, np.float32)
    up = np.asarray(up, np.float32)
    focus = np.float32(np.linalg.norm(look_to - look_from))
    half_h = np.float32(np.tan(np.float32(math.radians(vfov)) / np.float32(2)))
    half_w = np.float32(aspect) * half_h

    def norm(v):
        return (v / np.sqrt(np.dot(v, v))).astype(np.float32)

    look = norm(look_to - look_from)
    right = norm(np.cross(look, up))
    up_axis = norm(np.cross(right, look))
    lower_left = (look_from + look * focus - right * (half_w * focus)
                  - up_axis * (half_h * focus)).astype(np.float32)
    vals = (look_from, lower_left,
            (2.0 * half_w * focus * right).astype(np.float32),
            (2.0 * half_h * focus * up_axis).astype(np.float32),
            right, up_axis, np.float32(aperture) / np.float32(2),
            np.float32(SHUTTER[0]), np.float32(SHUTTER[1]))
    return {f: np.asarray(v, np.float32) for f, v in zip(FIELDS, vals)}


def reference_view(aspect: float) -> dict:
    """The reference's fixed camera."""
    return make_camera(LOOK_FROM, LOOK_TO, aspect)


def orbit_view(angle: float, aspect: float, radius: float,
               height: float) -> dict:
    """The camera at ``angle`` (radians) on a circle of ``radius`` around
    the reference's target, at ``height``, looking at the target."""
    look_from = (LOOK_TO[0] + radius * math.cos(angle), height,
                 LOOK_TO[2] + radius * math.sin(angle))
    return make_camera(look_from, LOOK_TO, aspect)


def as_object(cam: dict):
    """The camera as an object with one attribute per field (what
    ``camera_from_numpy`` reads)."""
    return types.SimpleNamespace(**cam)
