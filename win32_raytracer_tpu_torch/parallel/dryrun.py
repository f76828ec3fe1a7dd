"""Ranks in fresh processes, and the multi-device dry run
(``__graft_entry__.dryrun_multichip``'s analogue).

:func:`spawn` starts n ranks with the ``spawn`` start method (so a worker
imports only what its function needs), joins them through a ``FileStore``
in a temporary directory (no port to collide on), runs ``fn(mesh, *args)``
on every rank and returns rank 0's result.  A rank that raises makes
:func:`spawn` raise (``torch.multiprocessing`` ends the other ranks).

:func:`dryrun_multichip` runs the reference's dry run on n gloo ranks on
the CPU: the sharded render in row, sample and persistent modes at tiny
shapes, the last one also above the compaction floor, with the reference's
shape and finiteness checks.

    python -m win32_raytracer_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
from typing import Optional

import numpy as np


def _rank_main(rank: int, n: int, tmp: str, device_type: str,
               backend: Optional[str], fn, args) -> None:
    import torch.distributed as dist

    from .shard import init_ranks, make_mesh

    store = dist.FileStore(os.path.join(tmp, "store"), n)
    init_ranks(rank, n, store=store, device_type=device_type,
               backend=backend)
    try:
        out = fn(make_mesh(n, device_type), *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(n: int, fn, *args, device_type: str = "cpu",
          backend: Optional[str] = None):
    """``fn(mesh, *args)`` on ``n`` fresh ranks (a mesh over all of them);
    returns rank 0's result.  ``fn`` and ``args`` must pickle (a function
    defined at the top of a module).  ``backend`` None takes
    shard.pick_backend's choice."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(n, tmp, device_type, backend,
                                             fn, args),
                           nprocs=n, join=True, start_method="spawn")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _dryrun_ranks(mesh, n: int) -> list:
    from .. import persistent as P
    from ..config import RenderConfig
    from ..scene.builders import test_scene
    from .shard import render_sharded

    scene = test_scene()
    shapes = []

    def check(img, shape):
        if img.shape != shape or not np.isfinite(img.astype(np.float32)).all():
            raise AssertionError(f"dry run image {img.shape}, want {shape}")
        shapes.append(img.shape)

    # Interleaved row blocks, the whole bounce pipeline at tiny shapes.
    cfg = RenderConfig(width=32, height=8 * n, samples=2, seed=1, max_depth=3)
    check(render_sharded(scene, cfg=cfg, mesh=mesh, mode="rows"),
          (8 * n, 32, 3))
    # Sample sharding, averaged over the ranks.
    cfg = RenderConfig(width=32, height=8, samples=n, seed=1, max_depth=3)
    check(render_sharded(scene, cfg=cfg, mesh=mesh, mode="spp"), (8, 32, 3))
    # The persistent scheduler over the mesh.
    cfg = RenderConfig(width=32, height=8 * n, samples=16, seed=1,
                       max_depth=3)
    check(render_sharded(scene, cfg=cfg, mesh=mesh, mode="persistent"),
          (8 * n, 32, 3))
    # The same above the compaction floor (floor lowered): the lockstep
    # compactions and the below-floor tail run, not only the one shot.
    saved = P._COMPACT_FLOOR
    P._COMPACT_FLOOR = 2048
    try:
        cfg = RenderConfig(width=64, height=8 * n, samples=16, seed=2,
                           max_depth=3, one_shot="off")
        check(render_sharded(scene, cfg=cfg, mesh=mesh, mode="persistent"),
              (8 * n, 64, 3))
    finally:
        P._COMPACT_FLOOR = saved
    return shapes


def dryrun_multichip(n_devices: int) -> list:
    """The sharded renders of the reference's dry run on ``n_devices``
    gloo ranks on the CPU; returns the image shapes checked."""
    return spawn(n_devices, _dryrun_ranks, n_devices, device_type="cpu")


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2))
