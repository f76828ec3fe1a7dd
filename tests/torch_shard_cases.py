"""Rank-side cases of the port's multi-device tests
(tests/test_torch_parallel.py, tests/test_torch_persistent_shard.py).

The tests start groups of gloo ranks on the CPU with
``parallel.dryrun.spawn(d, run_cases, cases)``; every rank runs the same
list of cases and rank 0's results come back to the test process.  This
module imports torch and the port only, so the ranks never import jax.
Module patches (``persistent._COMPACT_FLOOR``) reach the ranks as case
arguments."""

from __future__ import annotations

import contextlib
import os

import torch

from win32_raytracer_tpu_torch import persistent as P
from win32_raytracer_tpu_torch.config import RenderConfig
from win32_raytracer_tpu_torch.parallel import shard as S
from win32_raytracer_tpu_torch.parallel.persistent_shard import (
    _MIN_LANES, render_image_persistent_sharded)
from win32_raytracer_tpu_torch.scene.builders import get_scene, mesh_scene
from win32_raytracer_tpu_torch.scene.camera import make_camera

# A camera looking straight up: every pixel is sky, in [0.5, 1].
SKY_CAM = ((0, 50, 0), (0, 51, 0), (1, 0, 0), 60.0, 2.0, 0.0, 1.0)


def scene_of(name: str):
    """A scene by name; "mesh3" is mesh_scene(subdivisions=3)."""
    return mesh_scene(subdivisions=3) if name == "mesh3" else get_scene(name)


def camera_of(spec):
    """None, "sky", or ("orbit", orbit_path kwargs)."""
    if spec is None:
        return None
    if spec == "sky":
        return make_camera(*SKY_CAM)
    from win32_raytracer_tpu_torch.animation import orbit_path
    return orbit_path(**spec[1])


@contextlib.contextmanager
def patched(patches):
    saved = {k: getattr(P, k) for k in patches}
    for k, v in patches.items():
        setattr(P, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(P, k, v)


def persistent(mesh, scene, cam=None, patches=None, **cfg):
    """The sharded persistent render's linear image (numpy)."""
    with patched(patches or {}):
        out = render_image_persistent_sharded(
            scene_of(scene), camera_of(cam), RenderConfig(**cfg), mesh)
    return out.numpy()


def traced(mesh, scene, patches=None, **cfg):
    """The sharded persistent render with the recorder off, then on
    (``recording()``): whether the two images are bit-equal, the image,
    and this rank's log."""
    from win32_raytracer_tpu_torch.utils import profiling
    off = persistent(mesh, scene, patches=patches, **cfg)
    with profiling.recording():
        on = persistent(mesh, scene, patches=patches, **cfg)
    return dict(equal=bool((off == on).all()), image=on, log=profiling.log())


def calls(mesh, scene, patches=None, **cfg):
    """The sharded persistent render with the recorder on and kernels B and
    B-multi (their plain versions here) spied: the image, this rank's
    counters, the per-rank floor, and each kernel call as (width, bounces,
    the innermost open span)."""
    from win32_raytracer_tpu_torch.kernels import bounce as B
    from win32_raytracer_tpu_torch.utils import profiling
    rec = profiling._REC
    got = []

    def spy(fn):
        def wrapped(scene, cam_rows, st, *a, **k):
            inner = rec.spans[rec.stack[-1]][0] if rec.stack else None
            got.append((st.pixel.shape[1], k.get("k", 1), inner))
            return fn(scene, cam_rows, st, *a, **k)
        return wrapped
    real = B.bounce, B.bounce_multi
    B.bounce, B.bounce_multi = spy(B.bounce), spy(B.bounce_multi)
    try:
        with profiling.recording():
            image = persistent(mesh, scene, patches=patches, **cfg)
    finally:
        B.bounce, B.bounce_multi = real
    (counters,) = profiling.log()["counters"].values()
    with patched(patches or {}):
        floor = max(P._COMPACT_FLOOR // mesh.size(), _MIN_LANES)
    return dict(image=image, counters=counters, calls=got, floor=floor)


def sharded(mesh, scene, mode, **cfg):
    """render_image_sharded's linear image (numpy) in ``mode``."""
    return S.render_image_sharded(scene_of(scene), None, RenderConfig(**cfg),
                                  mesh, mode=mode).numpy()


def raises(mesh, case, **kw):
    """(exception type, message) of ``CASES[case](mesh, **kw)``, or None."""
    try:
        CASES[case](mesh, **kw)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def meshes(mesh):
    """make_mesh on the group: the world mesh's size, whether each rank
    is in make_mesh(2) (gathered), and make_mesh(world + 1)'s error."""
    world = torch.distributed.get_world_size()
    sub = S.make_mesh(2, "cpu")
    inside = S.gather_ints([sub is not None], mesh)[:, 0].tolist()
    try:
        S.make_mesh(world + 1, "cpu")
        err = None
    except ValueError as e:
        err = str(e)
    return dict(size=mesh.size(), names=mesh.mesh_dim_names, inside=inside,
                err=err, backend=torch.distributed.get_backend())


def api_render(mesh, scene, shard_mode, **cfg):
    """api.render(mesh=) beside render_sharded of the same arguments."""
    from win32_raytracer_tpu_torch.api import render
    res = render(scene, cfg=RenderConfig(**cfg), mesh=mesh,
                 shard_mode=shard_mode)
    direct = S.render_sharded(get_scene(scene), cfg=RenderConfig(**cfg),
                              mesh=mesh, mode=shard_mode)
    return dict(image=res.image, direct=direct, device=res.device)


def animation(mesh, scene, cams, out_dir, shard_mode, batch_frames, **cfg):
    """render_animation(mesh=): frames, the callback's calls, the files in
    ``out_dir`` after every rank is done, and (batched) batch_frames=1
    frames of the same cameras."""
    from win32_raytracer_tpu_torch.animation import render_animation
    got = []
    pattern = os.path.join(out_dir, "fly_%04d.png")
    c = RenderConfig(**cfg)
    cams = camera_of(("orbit", cams))
    frames = render_animation(
        get_scene(scene), cams, c, out_pattern=pattern, mesh=mesh,
        shard_mode=shard_mode, batch_frames=batch_frames,
        frame_callback=lambda i, img, ms: got.append((i, img.shape, ms > 0)))
    S.barrier(mesh)
    files = sorted(os.listdir(out_dir))
    singles = None
    if batch_frames > 1:
        singles = render_animation(get_scene(scene), cams, c, mesh=mesh,
                                   shard_mode=shard_mode, batch_frames=1)
    return dict(frames=frames, got=got, files=files, singles=singles)


def checkpoint(mesh, out_dir, **cfg):
    """render_with_checkpoints(mesh=): an uninterrupted 2-pass render, one
    stopped after a pass and resumed, and the chunk-level refusal."""
    from win32_raytracer_tpu_torch.utils.checkpoint import (
        load_checkpoint, render_with_checkpoints)
    scene = get_scene("test")
    c = RenderConfig(**cfg)
    full = render_with_checkpoints(scene, None, c,
                                   os.path.join(out_dir, "full.npz"),
                                   passes=2, mesh=mesh)
    part_path = os.path.join(out_dir, "part.npz")
    part = render_with_checkpoints(scene, None, c, part_path, passes=2,
                                   max_passes_per_run=1, mesh=mesh)
    mid = load_checkpoint(part_path)[1]
    resumed = render_with_checkpoints(scene, None, c, part_path, passes=2,
                                      mesh=mesh)
    try:
        render_with_checkpoints(scene, None, c, part_path, passes=2,
                                mesh=mesh, chunk_checkpoints=True)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return dict(full=full, part=part, mid=mid, resumed=resumed,
                refusal=refusal)


@contextlib.contextmanager
def one_rank(tmp_dir):
    """A one-rank gloo group in this process and a mesh over it (the
    entry points' mesh path without starting processes)."""
    store = torch.distributed.FileStore(os.path.join(str(tmp_dir), "store"),
                                        1)
    S.init_ranks(0, 1, store=store, device_type="cpu", verbose=False)
    try:
        yield S.make_mesh(1, "cpu")
    finally:
        torch.distributed.destroy_process_group()


CASES = dict(persistent=persistent, traced=traced, calls=calls,
             sharded=sharded, raises=raises, meshes=meshes,
             api_render=api_render, animation=animation,
             checkpoint=checkpoint)


def run_cases(mesh, cases) -> dict:
    """Every case of ``cases`` ((name, case, kwargs) triples) on this rank,
    one thread; rank 0's results are what spawn returns."""
    torch.set_num_threads(1)
    return {name: CASES[case](mesh, **kw) for name, case, kw in cases}
