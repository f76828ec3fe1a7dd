"""Checkpoint / resume for long high-spp renders
(``win32_raytracer_tpu.utils.checkpoint``).

The C++ reference keeps only ``out.bmp`` (Game.cpp:104).  Two
granularities here:

* **Pass level** (both schedulers): the render is split into ``passes`` of
  ``samples / passes`` spp; after each pass the running radiance sum
  ([H, W, 3] f64) and the pass count go to an ``.npz``.  Pass seeds are
  ``seed * 1000003 + p``, so a resumed render gives the image an
  uninterrupted checkpointed one gives.
* **Chunk level** (persistent scheduler, opt-in): within a pass, after
  each row chunk the [3, H*W] f32 accumulator and the next row go to the
  file too, so a pass resumes mid-image.  A chunk's draws depend only on
  (seed, y0) and every flush adds in an order fixed by its stream
  (``persistent._flush``), so the resume is bit-exact on a card too.

A render over a mesh of ranks (``mesh=``) checkpoints at pass level;
rank 0 of the mesh writes the file.

The file has the JAX package's keys and format 3, and is written through
a ``.tmp.npz`` and ``os.replace``: a checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig, resolve_scheduler
from ..parallel.shard import barrier, is_writer

# 3: + rays_per_chunk / lanes_per_pixel (chunk boundaries and the lane
# encoding feed the per-chunk draw salts).
_FORMAT = 3


class _Budget(Exception):
    """Raised by the chunk callback once this call's chunk budget is spent
    (after the checkpoint is saved)."""


def load_checkpoint(path: str):
    """(accumulator [H, W, 3] f64, passes done, meta dict), or None when
    there is no file.  ``meta`` carries ``chunk_accum`` ([3, H*W] f32 or
    None) and ``chunk_y0`` for a checkpoint taken mid-pass."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        fmt = int(z["format"])
        if fmt not in (1, 2, _FORMAT):
            raise ValueError(f"unsupported checkpoint format {z['format']}")
        meta = dict(width=int(z["width"]), height=int(z["height"]),
                    samples=int(z["samples"]), seed=int(z["seed"]),
                    passes=int(z["passes"]), chunk_accum=None, chunk_y0=0)
        if fmt >= 2 and z["chunk_accum"].size:
            meta["chunk_accum"] = np.asarray(z["chunk_accum"], np.float32)
            meta["chunk_y0"] = int(z["chunk_y0"])
        if fmt >= 3:
            meta["rays_per_chunk"] = int(z["rays_per_chunk"])
            meta["lanes_per_pixel"] = int(z["lanes_per_pixel"])
        return np.asarray(z["accum"], np.float64), int(z["passes_done"]), meta


def _save(path: str, accum: np.ndarray, passes_done: int,
          cfg: RenderConfig, passes: int,
          chunk_accum: Optional[np.ndarray] = None,
          chunk_y0: int = 0) -> None:
    tmp = path + ".tmp.npz"  # ends in .npz, so np.savez keeps the name
    np.savez(tmp, format=_FORMAT, accum=accum, passes_done=passes_done,
             width=cfg.width, height=cfg.height, samples=cfg.samples,
             seed=cfg.seed, passes=passes,
             rays_per_chunk=cfg.rays_per_chunk,
             lanes_per_pixel=cfg.lanes_per_pixel,
             chunk_accum=(np.zeros(0, np.float32) if chunk_accum is None
                          else chunk_accum),
             chunk_y0=chunk_y0)
    os.replace(tmp, path)


def render_with_checkpoints(
    scene,
    cam,
    cfg: RenderConfig,
    checkpoint_path: str,
    passes: int = 10,
    hit_fn=None,
    max_passes_per_run: Optional[int] = None,
    chunk_checkpoints: bool = False,
    max_chunks_per_run: Optional[int] = None,
    mesh=None,
    *,
    device=None,
) -> Optional[np.ndarray]:
    """Render ``cfg.samples`` spp in ``passes`` resumable passes on
    ``device`` (None: the CUDA card, as ``api.render``).

    ``cfg.scheduler`` is resolved on each pass's spp, as ``render.render``
    resolves it.  Returns the u8 image once every pass is done, else None
    (call again to resume): ``max_passes_per_run`` bounds the passes this
    call renders; ``chunk_checkpoints`` also saves after each row chunk on
    the persistent scheduler, and ``max_chunks_per_run`` bounds the chunks
    of this call (and implies ``chunk_checkpoints``).  ``hit_fn`` is a
    column hit function, run on the persistent scheduler through
    ``ops/rows.hit_rows_adapter``.

    ``mesh`` (parallel/shard.make_mesh): every rank calls this; each pass
    renders through the persistent scheduler over the mesh, checkpointed
    at pass level only (the sharded render has no row-chunk cut points);
    rank 0 of the mesh writes the file, and every rank waits for it before
    going on.  Pass seeds are those of one card."""
    from ..api import mesh_device
    from ..render import render_image, tonemap
    from ..scene.camera import default_camera

    if cfg.samples % passes:
        raise ValueError(f"samples ({cfg.samples}) must divide into "
                         f"passes ({passes})")
    if max_chunks_per_run is not None:
        chunk_checkpoints = True
    spp_pass = cfg.samples // passes
    scheduler = resolve_scheduler(cfg, spp_pass)
    if mesh is not None:
        if scheduler != "persistent":
            raise ValueError(
                "mesh checkpointing runs through the sharded persistent "
                f"scheduler; got scheduler {scheduler!r} (per-pass spp "
                f"{spp_pass} resolves wavefront under 8: use more samples "
                "or fewer passes)")
        if chunk_checkpoints:
            raise ValueError(
                "chunk_checkpoints is single-card only (the sharded scheduler "
                "has no row-chunk cut points); mesh renders checkpoint at "
                "pass granularity")
    elif chunk_checkpoints and scheduler != "persistent":
        raise ValueError(
            "chunk_checkpoints/max_chunks_per_run need the persistent "
            f"scheduler; per-pass spp {spp_pass} resolves "
            f"{scheduler!r} — use more samples, fewer passes, or "
            "scheduler='persistent'")
    dev = mesh_device(mesh, device)
    if hasattr(scene, "to"):
        scene = scene.to(dev)
    cam = (default_camera(cfg.width, cfg.height, device=dev) if cam is None
           else cam.to(dev))
    if hit_fn is not None and scheduler == "persistent":
        from ..ops.rows import hit_rows_adapter
        hit_fn = hit_rows_adapter(hit_fn)

    state = load_checkpoint(checkpoint_path)
    if state is not None:
        accum, done, meta = state
        if (meta["width"], meta["height"], meta["samples"], meta["seed"],
                meta["passes"]) != (cfg.width, cfg.height, cfg.samples,
                                    cfg.seed, passes):
            raise ValueError("checkpoint does not match this render config")
        if "rays_per_chunk" in meta and (
                (meta["rays_per_chunk"], meta["lanes_per_pixel"])
                != (cfg.rays_per_chunk, cfg.lanes_per_pixel)):
            # They fix the chunks and the lane encoding, which key the draws:
            # resuming with others would not be bit-exact.
            raise ValueError(
                "checkpoint was written with rays_per_chunk="
                f"{meta['rays_per_chunk']}, lanes_per_pixel="
                f"{meta['lanes_per_pixel']}; resuming with "
                f"({cfg.rays_per_chunk}, {cfg.lanes_per_pixel}) would "
                "not be bit-exact")
        chunk_accum, chunk_y0 = meta["chunk_accum"], meta["chunk_y0"]
    else:
        accum = np.zeros((cfg.height, cfg.width, 3), np.float64)
        done = 0
        chunk_accum, chunk_y0 = None, 0

    end = passes if max_passes_per_run is None else min(
        passes, done + max_passes_per_run)
    chunks_left = [max_chunks_per_run]

    for p in range(done, end):
        pass_cfg = cfg.replace(samples=spp_pass, seed=cfg.seed * 1000003 + p)
        if mesh is not None:
            from ..parallel.persistent_shard import (
                render_image_persistent_sharded)
            linear = render_image_persistent_sharded(scene, cam, pass_cfg,
                                                     mesh, hit_fn=hit_fn)
        elif scheduler == "persistent":
            from ..persistent import render_image_persistent
            resume_kw = {}
            if chunk_accum is not None:
                resume_kw = dict(resume_accum=chunk_accum, resume_y0=chunk_y0)
                chunk_accum, chunk_y0 = None, 0

            def on_chunk(acc, next_y0, _p=p):
                if next_y0 >= cfg.height:
                    return  # the last chunk: the pass's save follows
                _save(checkpoint_path, accum, _p, cfg, passes,
                      chunk_accum=acc.cpu().numpy().copy(),
                      chunk_y0=next_y0)
                if chunks_left[0] is not None:
                    chunks_left[0] -= 1
                    if chunks_left[0] <= 0:
                        raise _Budget()

            try:
                linear = render_image_persistent(
                    scene, cam, pass_cfg, hit_fn=hit_fn,
                    chunk_callback=on_chunk if chunk_checkpoints else None,
                    **resume_kw)
            except _Budget:
                return None  # the chunk budget is spent; the file is saved
        else:
            linear = render_image(scene, cam, pass_cfg, hit_fn=hit_fn)
        accum += linear.cpu().numpy().astype(np.float64) * spp_pass
        if is_writer(mesh):
            _save(checkpoint_path, accum, p + 1, cfg, passes)
        if mesh is not None:
            # Every rank reads the file on its next call: it must be there.
            barrier(mesh)
    if end < passes:
        return None  # the pass budget is spent; call again to resume

    mean = (accum / cfg.samples).astype(np.float32)
    return tonemap(torch.from_numpy(mean)).numpy()
