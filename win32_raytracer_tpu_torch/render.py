"""Render entry point and tonemap (``win32_raytracer_tpu.render``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import RenderConfig, resolve_scheduler
from .persistent import Scene
from .scene.camera import Camera, default_camera


def tonemap(linear: torch.Tensor) -> torch.Tensor:
    """Gamma-2 + u8 quantization (RayTracer.cpp:948-954)."""
    c = torch.sqrt(torch.clamp_min(linear, 0.0))
    return torch.clamp(torch.floor(255.99 * c), 0.0, 255.0).to(torch.uint8)


def render_image(scene, cam, cfg):
    """The fixed-depth wavefront scheduler (deterministic renders and
    spp < 8)."""
    raise NotImplementedError(
        "the wavefront scheduler is not ported yet: ROADMAP Queue 2 "
        "(wavefront render_image); use samples >= 8 or "
        "scheduler='persistent'")


def render(scene: Scene, cam: Optional[Camera] = None,
           cfg: Optional[RenderConfig] = None) -> np.ndarray:
    """Render a sphere, triangle or composite scene to a u8 [H, W, 3] image
    (top row first) on the scene's device."""
    cfg = cfg or RenderConfig()
    if cam is None:
        cam = default_camera(cfg.width, cfg.height, device=scene.device)
    scheduler = resolve_scheduler(cfg)
    if scheduler == "persistent":
        from .persistent import render_image_persistent
        linear = render_image_persistent(scene, cam, cfg)
    elif scheduler == "wavefront":
        linear = render_image(scene, cam, cfg)
    else:
        raise ValueError(
            f"unknown scheduler {cfg.scheduler!r} (auto|wavefront|persistent)")
    return tonemap(linear).cpu().numpy()
