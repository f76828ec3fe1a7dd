"""Tile parallelism over a mesh of ranks (``win32_raytracer_tpu.parallel.shard``).

The reference scales with std::threads over interleaved 8-row image blocks
(win32-raytracer/RayTracer.cpp:971-999); the JAX package turns them into a
1-D device mesh driven from one controller.  Here the mesh is PyTorch's:
one process per device, a 1-D :class:`DeviceMesh` with the axis name
``"tiles"``, and every rank calls the render in SPMD fashion and returns
the whole image, as the JAX package returns a replicated array.  Rank 0
of the mesh is the rank that writes files.

* **row mode** (``mode="rows"``): superchunks of D interleaved row blocks,
  block b of a superchunk on rank b; the blocks are all-gathered into
  image order at the end.
* **sample mode** (``mode="spp"``): every rank renders the whole image at
  samples / D with its own keys; the images are all-gathered and averaged
  in rank order (the JAX package's ``pmean``).
* ``mode="persistent"``: the persistent scheduler over the mesh
  (persistent_shard.py).

Both wavefront modes run the wavefront's steps (``render.py``) on each
rank's rows: kernels G (spheres) and H (triangles) on a card, their plain
versions on the CPU.

Devices and backends: rank r works on ``cuda:(r % device_count)``, or on
the CPU when the mesh is made with ``device_type="cpu"``.  NCCL takes one
rank a card, so :func:`init_ranks` picks NCCL when every rank has a card
of its own and gloo when ranks share a card or run on the CPU.  Under
gloo every collective goes through an explicit copy to the host.  Every
reduce over ranks adds in rank order, so a sharded render repeats bit for
bit.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import RenderConfig
from ..core.rng import fold_in, prng_key
from ..persistent import _div
from ..render import (HitFn, _resolve_hit, accumulate_pixels, bounce_step,
                      make_primary_rays, tonemap)
from ..scene.camera import Camera, default_camera

AXIS = "tiles"


def pick_backend(world_size: int, device_type: str) -> tuple:
    """(backend, reason): NCCL when every rank has a card of its own, gloo
    when ranks share a card or run on the CPU."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: pass device_type='cpu' to run the "
                           "ranks on the CPU")
    if world_size <= cards:
        return "nccl", f"{world_size} rank(s) on {cards} card(s), one each"
    return "gloo", (f"{world_size} ranks share {cards} card(s) and NCCL takes "
                    "one rank a card; collectives through host copies")


def init_ranks(rank: int, world_size: int, *, store=None,
               init_method: Optional[str] = None,
               device_type: Optional[str] = None,
               backend: Optional[str] = None, verbose: bool = True) -> str:
    """Initialise this process's default process group as ``rank`` of
    ``world_size`` (through ``store`` or ``init_method``, e.g.
    ``tcp://localhost:<port>``), on the backend :func:`pick_backend` picks
    (``backend`` overrides it); sets the rank's card.  Rank 0 prints the
    choice to stderr.  Returns the backend."""
    device_type = _device_type(device_type)
    chosen, why = pick_backend(world_size, device_type)
    if backend is None:
        backend = chosen
    elif backend != chosen:
        why = f"asked for (the rule picks {chosen}: {why})"
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if init_method is None and store is None:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size)
    if verbose and rank == 0:
        print(f"torch.distributed: {world_size} rank(s), backend {backend} "
              f"({why})", file=sys.stderr, flush=True)
    return backend


def _device_type(device_type: Optional[str]) -> str:
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port renders on the card "
                               "by default; pass device_type='cpu'")
        return "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device_type {device_type!r} (cuda | cpu)")
    return device_type


def make_mesh(n_devices: Optional[int] = None,
              device_type: Optional[str] = None) -> Optional[DeviceMesh]:
    """1-D mesh (axis ``"tiles"``) over ranks 0..n-1 of the initialised
    default process group (all of them by default).  Every rank of the
    group must call it; a rank outside the mesh gets None.
    ``device_type`` None means the card (and raises without one)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.shard.init_ranks, or torchrun)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n_devices}) needs 1 <= n <= the world "
                         f"size {world}")
    mesh = DeviceMesh(_device_type(device_type), torch.arange(n),
                      mesh_dim_names=(AXIS,))
    return mesh if mesh.get_coordinate() is not None else None


def mesh_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(AXIS)


def is_writer(mesh: Optional[DeviceMesh]) -> bool:
    """Whether this process writes files: always without a mesh, rank 0
    of the mesh with one."""
    return mesh is None or mesh_rank(mesh) == 0


def barrier(mesh: DeviceMesh) -> None:
    """Wait for every rank of the mesh."""
    dist.barrier(group=mesh.get_group(AXIS))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the CPU, or ``cuda:(rank % device_count)``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def _on_host(mesh: DeviceMesh) -> bool:
    """Whether the mesh's collectives take host tensors (gloo)."""
    return dist.get_backend(mesh.get_group(AXIS)) != "nccl"


def all_gather(t: torch.Tensor, mesh: DeviceMesh) -> list:
    """Every rank's ``t`` (same shape and dtype everywhere), in rank order,
    on ``t``'s device.  Under gloo through a copy to the host."""
    group = mesh.get_group(AXIS)
    x = t.detach().contiguous()
    if _on_host(mesh):
        x = x.cpu()
    out = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(out, x, group=group)
    return [y.to(t.device) for y in out]


def gather_ints(values, mesh: DeviceMesh, gather=all_gather) -> np.ndarray:
    """[D, k] int64: every rank's ``values`` (k Python ints), rank order,
    through ``gather`` (an :func:`all_gather`, or a timed one)."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    if not _on_host(mesh):
        t = t.to(rank_device(mesh))
    return torch.stack(gather(t, mesh)).cpu().numpy()


def sum_in_rank_order(parts: list) -> torch.Tensor:
    """The ranks' tensors added one after another in rank order: the same
    f32 adds on every rank and every run (never an ``all_reduce``, whose
    order of adds is the backend's)."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def _wavefront_rows(scene, cam, cfg, y, keys, rows, spp, hit):
    """One rank's block of ``rows`` image rows from row ``y``: primary
    rays, ``max_depth + 1`` bounces, the mean over samples [rows, W, 3]."""
    hit_scene, hit_fn = hit
    cam_key, trc_key = keys
    w, h = cfg.width, cfg.height
    state = make_primary_rays(cam, y, cam_key, cfg=cfg, width=w, height=h,
                              spp=spp, rows=rows)
    for depth in range(cfg.max_depth + 1):
        state = bounce_step(hit_scene, state, trc_key, depth, cfg=cfg,
                            hit_fn=hit_fn)
    return accumulate_pixels(state.radiance, width=w, spp=spp, rows=rows)


def render_image_sharded(scene, cam: Optional[Camera], cfg: RenderConfig,
                         mesh: DeviceMesh, mode: str = "rows",
                         hit_fn: Optional[HitFn] = None) -> torch.Tensor:
    """Render the whole image over the mesh; every rank returns linear
    [H, W, 3] f32 on its device.

    ``mode="rows"``: interleaved row blocks (the reference's load
    balancing); ``"spp"``: sample-sharded, averaged over ranks;
    ``"persistent"``: the persistent scheduler over the mesh, where a
    caller's ``hit_fn`` takes the rows interface (ops/rows.py), unlike the
    column ``hit_fn`` of the two wavefront modes."""
    if mode == "persistent":
        from .persistent_shard import render_image_persistent_sharded
        return render_image_persistent_sharded(scene, cam, cfg, mesh,
                                               hit_fn=hit_fn)
    if mode not in ("rows", "spp"):
        raise ValueError(f"unknown mode {mode!r} (rows|spp|persistent)")
    dev = rank_device(mesh)
    scene = scene.to(dev)
    cam = (default_camera(cfg.width, cfg.height, device=dev) if cam is None
           else cam.to(dev))
    w, h, spp = cfg.width, cfg.height, cfg.samples
    d, b = mesh.size(), mesh_rank(mesh)
    key = prng_key(cfg.seed)
    cfg = cfg.replace(seed=0)   # the seed only feeds the key
    hit = _resolve_hit(scene, cfg, hit_fn)

    if mode == "spp":
        if spp % d:
            raise ValueError(f"spp mode needs samples % devices == 0 "
                             f"({spp} % {d})")
        spp_local = spp // d
        rows = max(1, min(h, cfg.rays_per_chunk // max(1, w * spp_local)))
        out = []
        for y0 in range(0, h, rows):
            # Same rows on every rank, the rank's own sample keys.
            base = fold_in(key, y0)
            keys = (fold_in(fold_in(base, 1), b), fold_in(fold_in(base, 2), b))
            block = _wavefront_rows(scene, cam, cfg, y0, keys, rows,
                                    spp_local, hit)
            out.append(block[:min(rows, h - y0)])
        total = sum_in_rank_order(all_gather(torch.cat(out), mesh))
        return _div(total, d)

    # Row mode: superchunks of D interleaved row blocks, one per rank.
    rows = max(1, min(-(-h // d), cfg.rays_per_chunk // max(1, w * spp)))
    super_rows = rows * d
    blocks = []
    for y_s in range(0, h, super_rows):
        base = fold_in(key, y_s)
        y = y_s + b * rows
        keys = (fold_in(fold_in(base, 1), y), fold_in(fold_in(base, 2), y))
        blocks.append(_wavefront_rows(scene, cam, cfg, y, keys, rows, spp,
                                      hit))
    # Rank b's block of superchunk s holds global rows s * super_rows +
    # b * rows onwards: stacking the gathered blocks superchunk-major puts
    # every row in image order (the imageParts stitch, Game.cpp:94-102).
    parts = all_gather(torch.stack(blocks), mesh)    # D x [S, rows, W, 3]
    return torch.stack(parts, 1).reshape(-1, w, 3)[:h]


def render_sharded(scene, cam: Optional[Camera] = None,
                   cfg: Optional[RenderConfig] = None,
                   mesh: Optional[DeviceMesh] = None, mode: str = "rows",
                   hit_fn: Optional[HitFn] = None) -> np.ndarray:
    """Multi-device render to u8 [H, W, 3] (every rank returns it)."""
    cfg = cfg or RenderConfig()
    mesh = mesh or make_mesh()
    linear = render_image_sharded(scene, cam, cfg, mesh, mode=mode,
                                  hit_fn=hit_fn)
    return tonemap(linear).cpu().numpy()
