"""Public render API (``win32_raytracer_tpu.api``, RayTracer.h:16-33).

* :func:`render`       — blocking, returns a :class:`RenderResult`;
* :func:`render_async` — completion-callback variant returning a handle.

Both take ``device=``: None means CUDA when a card is present, else the
CPU.  Work on a card runs the hand-written kernels; on the CPU their plain
versions.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .config import RenderConfig
from .render import render as _render_single
from .scene.builders import get_scene
from .scene.camera import Camera, default_camera
from .scene.spheres import SphereScene


@dataclasses.dataclass
class RenderResult:
    """Analogue of ``ptr::RenderResult`` (RayTracer.h:8-13)."""

    image: np.ndarray            # u8 [H, W, 3], top row first
    duration_ms: float           # wall clock, like renderDuration
    config: RenderConfig
    mrays_per_sec: float         # primary rays / wall clock
    device: str = "cpu"          # where it ran

    @property
    def image_parts(self) -> List[np.ndarray]:
        """Row blocks of 8, top to bottom (imageParts analogue)."""
        block = 8  # the reference's blockSizeY (RayTracer.cpp:979)
        return [self.image[y:y + block]
                for y in range(0, self.image.shape[0], block)]


def resolve_device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _resolve(scene, cam, cfg, device):
    cfg = cfg or RenderConfig()
    if isinstance(scene, str):
        scene = get_scene(scene)
    if scene is None:
        # The reference's render() always builds the RTIOW random scene.
        scene = get_scene("random")
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    return scene.to(device), cam.to(device), cfg


def render(scene: Optional[SphereScene | str] = None,
           cam: Optional[Camera] = None, cfg: Optional[RenderConfig] = None,
           *, device=None, mesh=None, shard_mode: str = "rows") -> RenderResult:
    """Blocking render of a SphereScene, a scene name ('test' / 'random' /
    'final') or None (the RTIOW random scene, like the reference)."""
    if mesh is not None:
        raise NotImplementedError(
            f"multi-device rendering (shard_mode={shard_mode!r}) is not "
            "ported yet: ROADMAP Queue 1 item 11")
    dev = resolve_device(device)
    scene, cam, cfg = _resolve(scene, cam, cfg, dev)
    start = time.perf_counter()
    image = _render_single(scene, cam, cfg)   # ends in a device->host copy
    dur = (time.perf_counter() - start) * 1e3
    rays = cfg.width * cfg.height * cfg.samples
    return RenderResult(image=image, duration_ms=dur, config=cfg,
                        mrays_per_sec=rays / (dur / 1e3) / 1e6,
                        device=str(dev))


class AsyncRender:
    """Handle for an in-flight render (the std::thread analogue)."""

    def __init__(self, thread: threading.Thread):
        self._thread = thread
        self.result: Optional[RenderResult] = None
        self.error: Optional[BaseException] = None

    def join(self, timeout: Optional[float] = None) -> Optional[RenderResult]:
        self._thread.join(timeout)
        if self.error is not None:
            raise self.error
        return self.result

    def done(self) -> bool:
        return not self._thread.is_alive()


def render_async(scene: Optional[SphereScene | str] = None,
                 cam: Optional[Camera] = None,
                 cfg: Optional[RenderConfig] = None,
                 callback: Optional[Callable[[RenderResult], None]] = None,
                 **kw) -> AsyncRender:
    """Non-blocking render; invokes ``callback(result)`` on completion
    (``ptr::asyncRender``)."""
    handle: AsyncRender

    def work():
        try:
            res = render(scene, cam, cfg, **kw)
            handle.result = res
            if callback is not None:
                callback(res)
        except BaseException as e:  # surfaced on join()
            handle.error = e

    thread = threading.Thread(target=work, daemon=True)
    handle = AsyncRender(thread)
    thread.start()
    return handle
