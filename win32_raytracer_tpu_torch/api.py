"""Public render API (``win32_raytracer_tpu.api``, RayTracer.h:16-33).

* :func:`render`       — blocking, returns a :class:`RenderResult`;
* :func:`render_async` — completion-callback variant returning a handle.

Both take ``device=``: None means the CUDA card, and raises when there is
none (pass ``device="cpu"`` to render on the CPU).  Work on a card runs
the hand-written kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .config import RenderConfig
from .persistent import Scene
from .render import render as _render_single
from .scene.builders import get_scene
from .scene.camera import Camera, default_camera
from .utils import profiling


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
    """``device``, or the CUDA card when it is None; raises RuntimeError
    when it is None and there is no card, rather than run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port renders on the card by default; pass "
            "device='cpu' to render on the CPU")
    return torch.device("cuda")


def mesh_device(mesh, device=None) -> torch.device:
    """The device of a render: :func:`resolve_device` without a mesh, this
    rank's device (parallel/shard.rank_device) with one; a ``device`` of
    another type than the mesh's raises."""
    if mesh is None:
        return resolve_device(device)
    from .parallel.shard import rank_device
    dev = rank_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device={device!r} but the mesh's ranks run on "
                         f"{dev.type}")
    return dev


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


@profiling.render_entry("api.render")
def render(scene: Optional[Scene | str] = None,
           cam: Optional[Camera] = None, cfg: Optional[RenderConfig] = None,
           *, device=None, mesh=None, shard_mode: str = "rows") -> RenderResult:
    """Blocking render of a sphere, triangle or composite scene, a scene
    name ('test' / 'random' / 'final' / 'mesh' / 'mesh20k') or None (the
    RTIOW random scene, like the reference), through one camera (a camera
    list renders through ``animation.render_animation``).

    ``mesh`` (parallel/shard.make_mesh) renders over the ranks of a mesh:
    every rank calls this and gets the whole image; ``shard_mode`` is
    "rows", "spp" or "persistent" (parallel/shard.render_image_sharded).
    The device is then the rank's."""
    if isinstance(cam, (list, tuple)) and not isinstance(cam, Camera):
        raise TypeError("render takes one camera; render a list of cameras "
                        "with animation.render_animation")
    dev = mesh_device(mesh, device)
    scene, cam, cfg = _resolve(scene, cam, cfg, dev)
    start = time.perf_counter()
    if mesh is not None:
        from .parallel.shard import render_sharded
        image = render_sharded(scene, cam, cfg, mesh=mesh, mode=shard_mode)
    else:
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


def render_async(scene: Optional[Scene | str] = None,
                 cam: Optional[Camera] = None,
                 cfg: Optional[RenderConfig] = None,
                 callback: Optional[Callable[[RenderResult], None]] = None,
                 **kw) -> AsyncRender:
    """Non-blocking render; invokes ``callback(result)`` on completion
    (``ptr::asyncRender``).  The device is resolved before the thread
    starts, so a missing card raises here, as in :func:`render`."""
    handle: AsyncRender
    kw["device"] = mesh_device(kw.get("mesh"), kw.get("device"))

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
