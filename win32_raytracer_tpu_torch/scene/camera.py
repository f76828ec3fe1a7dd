"""Thin-lens camera (``ptr::Camera``, RayTracer.cpp:219-289).

The basis is built on the host in f32 numpy exactly as the JAX package
builds it, then held as tensors; ray generation is a pure function of
uniform draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SHUTTER_CLOSE_T, SHUTTER_OPEN_T
from ..core.rng import sample_unit_disc


class Camera(NamedTuple):
    origin: torch.Tensor             # [3]
    lower_left_corner: torch.Tensor  # [3]
    horizontal: torch.Tensor         # [3]
    vertical: torch.Tensor           # [3]
    right_axis: torch.Tensor         # [3]
    up_axis: torch.Tensor            # [3]
    lens_radius: torch.Tensor        # [] f32
    shutter_open: torch.Tensor       # [] f32
    shutter_close: torch.Tensor      # [] f32

    def to(self, device) -> "Camera":
        return Camera(*(x.to(device) for x in self))


def camera_from_numpy(src, device="cpu") -> Camera:
    """Port camera from any object carrying the ``Camera`` fields as
    arrays (e.g. the JAX package's camera)."""
    return Camera(*(
        torch.as_tensor(np.array(getattr(src, f), np.float32), device=device)
        for f in Camera._fields))


def make_camera(look_from, look_to, up, vfov_degrees: float,
                aspect_ratio: float, aperture: float, focus_dist: float,
                shutter_open: float = SHUTTER_OPEN_T,
                shutter_close: float = SHUTTER_CLOSE_T,
                device="cpu") -> Camera:
    """Build the camera basis exactly as RayTracer.cpp:237-274 (f32 math)."""
    look_from = np.asarray(look_from, np.float32)
    look_to = np.asarray(look_to, np.float32)
    up = np.asarray(up, np.float32)

    lens_radius = np.float32(aperture) / np.float32(2.0)
    theta = np.float32(math.radians(vfov_degrees))
    half_height = np.float32(np.tan(theta / np.float32(2.0)))
    half_width = np.float32(aspect_ratio) * half_height

    def norm(v):
        return (v / np.sqrt(np.dot(v, v))).astype(np.float32)

    look_dir = norm(look_to - look_from)
    right = norm(np.cross(look_dir, up))
    up_axis = norm(np.cross(right, look_dir))

    focus = np.float32(focus_dist)
    origin = look_from
    lower_left = (origin + look_dir * focus
                  - right * (half_width * focus)
                  - up_axis * (half_height * focus)).astype(np.float32)
    horizontal = (2.0 * half_width * focus * right).astype(np.float32)
    vertical = (2.0 * half_height * focus * up_axis).astype(np.float32)

    fields = (origin, lower_left, horizontal, vertical, right, up_axis,
              np.float32(lens_radius), np.float32(shutter_open),
              np.float32(shutter_close))
    return Camera(*(torch.as_tensor(np.asarray(x, np.float32), device=device)
                    for x in fields))


def default_camera(width: int, height: int, device="cpu") -> Camera:
    """The reference's hard-coded view (RayTracer.cpp:903-915)."""
    look_from = (15.0, 2.0, 4.0)
    look_to = (0.0, 1.0, 0.0)
    focus = float(np.linalg.norm(np.asarray(look_to, np.float32)
                                 - np.asarray(look_from, np.float32)))
    return make_camera(look_from, look_to, (0.0, 1.0, 0.0),
                       vfov_degrees=20.0, aspect_ratio=width / height,
                       aperture=0.1, focus_dist=focus, device=device)


def camera_rays(cam: Camera, u: torch.Tensor, v: torch.Tensor,
                draws: torch.Tensor):
    """Batch ``Camera::getRay`` (RayTracer.cpp:276-288): u/v [N], draws
    [N, 3] (shutter time, lens disc) -> (origin [N,3], direction [N,3]
    unnormalized, time [N])."""
    time = cam.shutter_open + (cam.shutter_close - cam.shutter_open) * draws[..., 0]
    disc = sample_unit_disc(draws[..., 1:3]) * cam.lens_radius
    offset = (cam.right_axis[None, :] * disc[..., 0:1]
              + cam.up_axis[None, :] * disc[..., 1:2])
    origin = cam.origin[None, :] + offset
    direction = (cam.lower_left_corner[None, :]
                 + u[..., None] * cam.horizontal[None, :]
                 + v[..., None] * cam.vertical[None, :]
                 - origin)
    return origin, direction, time
