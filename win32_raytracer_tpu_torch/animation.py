"""Animated camera flythroughs (``win32_raytracer_tpu.animation``;
BASELINE.json config 5).

The reference renderer has one hard-coded camera (RayTracer.cpp:906-915);
this renders a camera path.  On the persistent scheduler frames render in
batches: a batch of F frames is one virtual image of F * height rows with
one camera per frame (``persistent.render_image_persistent`` with a camera
list), so the scheduler's tail and its alive checks are paid once per
batch instead of once per frame.  On the wavefront scheduler
(deterministic renders, below 8 spp) each frame is one ``api.render``.
Over a mesh of ranks a batch's tall image shards by interleaved row blocks
(parallel/persistent_shard.py), as the reference's sharded flythrough.
"""

from __future__ import annotations

import math
import os
import struct
import time
import zlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .config import RenderConfig, resolve_scheduler
from .scene.camera import Camera, make_camera
from .utils import profiling


def orbit_path(
    look_to=(0.0, 1.0, 0.0),
    radius: float = 16.0,
    height: float = 2.0,
    n_frames: int = 24,
    vfov_degrees: float = 20.0,
    aspect_ratio: float = 4.0 / 3.0,
    aperture: float = 0.1,
    up=(0.0, 1.0, 0.0),
    start_angle: float = 0.0,
    sweep: float = 2.0 * math.pi,
    device="cpu",
) -> List[Camera]:
    """Circular orbit around ``look_to`` (focus follows the target)."""
    cams = []
    look_to = np.asarray(look_to, np.float32)
    for i in range(n_frames):
        a = start_angle + sweep * i / n_frames
        look_from = np.asarray(
            [look_to[0] + radius * math.cos(a), height,
             look_to[2] + radius * math.sin(a)], np.float32)
        focus = float(np.linalg.norm(look_to - look_from))
        cams.append(make_camera(look_from, look_to, up, vfov_degrees,
                                aspect_ratio, aperture, focus, device=device))
    return cams


def _auto_batch_frames(cfg: RenderConfig, n_frames: int = 0) -> int:
    """Frames per batch: as many as a budget of max(rays_per_chunk, 10M)
    lanes holds at the multi-frame lanes-per-pixel rule
    (``persistent._resolve_kpp``); a long animation splits into even
    batches."""
    from .persistent import _resolve_kpp

    budget = max(cfg.rays_per_chunk, 10 << 20)
    frames_cap = max(1, min(n_frames or 8,
                            budget // max(1, cfg.width * cfg.height)))
    kpp = _resolve_kpp(cfg, cfg.samples, max(frames_cap, 2),
                       cfg.width * cfg.height)
    per_frame = cfg.width * cfg.height * kpp
    bf = max(1, min(frames_cap, budget // max(1, per_frame)))
    if n_frames >= 2:
        n_batches = -(-n_frames // bf)
        bf = -(-n_frames // n_batches)
    return bf


@profiling.render_entry("animation.render_animation")
def render_animation(
    scene,
    cameras: Sequence[Camera],
    cfg: Optional[RenderConfig] = None,
    out_pattern: Optional[str] = None,
    mesh=None,
    shard_mode: str = "rows",
    frame_callback: Optional[Callable[[int, np.ndarray, float], None]] = None,
    batch_frames: int = 0,
    resume: bool = False,
    *,
    device=None,
) -> List[np.ndarray]:
    """Render one u8 [H, W, 3] image per camera; optionally write
    ``out_pattern % i`` (e.g. ``"fly_%04d.png"``) and/or call
    ``frame_callback(i, image, ms)``.

    ``scene`` is a scene or a scene name.  ``device``: None means the CUDA
    card, and raises when there is none (pass ``device="cpu"``).  With a
    ``mesh`` (parallel/shard.make_mesh) every rank calls this: batches
    render through the persistent scheduler over the mesh (shard modes
    "rows" and "persistent"), single frames through ``api.render(mesh=,
    shard_mode=)``, and only rank 0 of the mesh writes ``out_pattern``.

    Frame seeds derive from (cfg.seed, batch start), so animations are
    reproducible and frames decorrelated.  ``batch_frames`` (0 = auto,
    :func:`_auto_batch_frames`) frames render as one batch, one chunk each;
    1 renders frame by frame through ``api.render``.  ``resume`` with
    ``out_pattern`` skips a batch whose frame files all read back at this
    resolution (resumed frames call ``frame_callback`` with ms 0.0); a
    missing, unreadable or wrong-size file re-renders its batch, with its
    original seed, so a resumed animation equals an uninterrupted one."""
    from .api import _resolve, mesh_device, render as api_render
    from .parallel.shard import is_writer

    cfg = cfg or RenderConfig()
    scheduler = resolve_scheduler(cfg)
    cameras = list(cameras)
    # A batch is one tall image sharded by row blocks: on a mesh, only the
    # row-block modes batch.
    mesh_batchable = mesh is None or shard_mode in ("rows", "persistent")
    if batch_frames <= 0:
        batch_frames = (_auto_batch_frames(cfg, len(cameras))
                        if scheduler == "persistent" and mesh_batchable
                        else 1)
    if batch_frames > 1 and not mesh_batchable:
        raise ValueError(
            f"batch_frames={batch_frames} needs shard_mode 'rows' or "
            f"'persistent' on a mesh (got {shard_mode!r})")
    if batch_frames > 1 and scheduler != "persistent":
        raise ValueError(
            f"batch_frames={batch_frames} requires the persistent "
            f"scheduler (resolved scheduler is {scheduler!r})")
    dev = mesh_device(mesh, device)
    scene, _, cfg = _resolve(scene, cameras[0] if cameras else None, cfg, dev)

    def read_back(path):
        """A prior run's frame, or None (missing, unreadable, or not this
        render's resolution)."""
        if not os.path.exists(path):
            return None
        from .io.image import read_image
        try:
            img = read_image(path)
        except (OSError, ValueError, struct.error, zlib.error):
            return None
        return img if img.shape == (cfg.height, cfg.width, 3) else None

    def emit(i, img, ms):
        if out_pattern and is_writer(mesh):
            from .io.image import write_image
            os.makedirs(os.path.dirname(out_pattern) or ".", exist_ok=True)
            write_image(out_pattern % i, img)
        if frame_callback:
            frame_callback(i, img, ms)

    frames: List[np.ndarray] = []
    if batch_frames == 1:
        for i, cam in enumerate(cameras):
            if resume and out_pattern:
                img = read_back(out_pattern % i)
                if img is not None:
                    frames.append(img)
                    if frame_callback:
                        frame_callback(i, img, 0.0)
                    continue
            res = api_render(scene, cam=cam, cfg=cfg.replace(
                seed=cfg.seed * 1000003 + i), device=dev, mesh=mesh,
                shard_mode=shard_mode)
            frames.append(res.image)
            emit(i, res.image, res.duration_ms)
        return frames

    from .persistent import _resolve_kpp, render_image_persistent
    from .render import tonemap

    if mesh is not None:
        from .parallel.persistent_shard import render_image_persistent_sharded

        def render_batch(s, group, c):
            return render_image_persistent_sharded(s, group, c, mesh)
    else:
        render_batch = render_image_persistent

    # Size the chunk with the multi-frame kpp rule, so each batch is one
    # chunk: more chunks would bring back the per-chunk tail.
    per_frame = cfg.width * cfg.height * _resolve_kpp(
        cfg, cfg.samples, batch_frames, cfg.width * cfg.height)
    pending = None  # (b0, host frames [F, H, W, 3], copy event, per-frame ms)

    def materialize(p):
        b0_, host, copied, ms = p
        if copied is not None:
            copied.synchronize()
        for i, img in enumerate(host.numpy()):
            frames.append(img)
            emit(b0_ + i, img, ms)

    for b0 in range(0, len(cameras), batch_frames):
        group = cameras[b0:b0 + batch_frames]
        if resume and out_pattern:
            imgs = []
            for i in range(len(group)):   # the batch re-renders whole
                img = read_back(out_pattern % (b0 + i))
                if img is None:
                    break
                imgs.append(img)
            if len(imgs) == len(group):
                if pending is not None:
                    materialize(pending)
                    pending = None
                for i, img in enumerate(imgs):
                    frames.append(img)
                    if frame_callback:
                        frame_callback(b0 + i, img, 0.0)
                continue
        fcfg = cfg.replace(seed=cfg.seed * 1000003 + b0,
                           rays_per_chunk=max(cfg.rays_per_chunk,
                                              len(group) * per_frame))
        t0 = time.perf_counter()
        linear = render_batch(scene, group, fcfg)
        u8 = tonemap(linear)            # [F, H, W, 3], still on the device
        copied = None
        if u8.device.type == "cuda":
            # One copy of the batch to pinned host memory behind an event:
            # the host goes on to the next batch while it lands.
            done = torch.cuda.Event()
            done.record()
            host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(u8, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            done.synchronize()
        else:
            host = u8
        # Per-frame wall of the batch's compute (the copy excluded).
        ms = (time.perf_counter() - t0) * 1e3 / len(group)
        if pending is not None:
            materialize(pending)
        pending = (b0, host, copied, ms)
    if pending is not None:
        materialize(pending)
    return frames
