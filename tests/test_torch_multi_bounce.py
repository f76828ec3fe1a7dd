"""PyTorch port: the plain k-bounce (kernel B-multi's reference) against k
plain bounces and against the JAX package.

Row 3 of the kernel table, ``p_bounce_multi_fused``: the reference never
pinned that kernel (ROADMAP Queue 3), so the port's plain version is held
exactly to k plain bounces, to f32 round-off against the reference's XLA
multi-step, and to a bounded flip rate against the Pallas kernel in
interpret mode.  Kernel B-multi itself (CUDA) is held against this plain
version and against four launches of kernel B on the card by
chip_smoke.py phase 10, exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bounce import _both, _close_shares, _state_np
from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.kernels.bounce_pallas import p_bounce_multi_fused
from win32_raytracer_tpu.kernels.hit_pallas_v7 import hit_coeffs
from win32_raytracer_tpu.ops.hit import hit_spheres as jax_hit
from win32_raytracer_tpu.ops.rows import hit_rows_adapter
from win32_raytracer_tpu.scene.builders import random_scene as jax_scene
from win32_raytracer_tpu.scene.camera import default_camera as jax_camera
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.animation import orbit_path
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.kernels import bounce as B
from win32_raytracer_tpu_torch.ops.hit import sphere_table
from win32_raytracer_tpu_torch.scene.builders import random_scene
from win32_raytracer_tpu_torch.scene.camera import default_camera

torch.set_num_threads(1)

W, H, SPP, KPP, RB, K = 64, 32, 8, 2, 256, 4
SALT = 0xABC123
ROULETTE = dict(russian_roulette=True, rr_start_depth=1, stratify=True)
# Close shares after four bounces against the reference's XLA multi-step
# (test_plain_multi_matches_reference_multi_step).
MULTI_SHARES = dict(origin=0.975, direction=0.85, time=0.99, throughput=0.99,
                    radiance_sum=0.99)


def _cam_rows(frames):
    if frames == 1:
        return B.pack_camera(default_camera(W, H))
    return B.pack_cameras(orbit_path(n_frames=frames, aspect_ratio=W / H))


@pytest.mark.parametrize("lean,frames", [(True, 1), (False, 1), (False, 3)])
def test_plain_multi_is_k_plain_bounces(lean, frames):
    """Bit for bit: no lane reads another's state and the draws key on
    (salt, step, lane), so k bounces in one call are k calls."""
    _, st = _both(_state_np(H * W * KPP, seed=41))
    cfg = TC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP,
             **({} if lean else ROULETTE))
    dims = TP.make_dims(cfg, W, H, SPP, KPP)
    tab, cam_rows = sphere_table(random_scene()), _cam_rows(frames)
    multi = B.bounce_multi_plain(tab, cam_rows, st, SALT, 7, dims, cfg=cfg,
                                 k=K, lean=lean)
    for i in range(K):
        st = B.bounce_plain(tab, cam_rows, st, SALT, 7 + i, dims, cfg=cfg,
                            lean=lean)
    for f in TP.PathState._fields:
        assert torch.equal(getattr(multi, f), getattr(st, f)), f


def test_plain_multi_matches_reference_multi_step():
    """Against the reference's XLA arm, p_bounce_multi_step with the exact
    hit (itself equal to four of its p_bounce_step).  The alive, depth and
    sample bounds of test_torch_bounce.py hold at 1%.  The float rows
    compound: XLA's CPU rounds the ground sphere's ill-conditioned root
    otherwise (ROADMAP Queue 3), so lanes that start a bounce on the ground
    leave with origins off in the fourth digit and unnormalised Lambertian
    directions beyond rtol 1e-4.  Measured after four bounces (seed 42):
    origin 0.9875, direction 0.906 (0.996 after one bounce), the rest >=
    0.9975; the bounds are MULTI_SHARES."""
    kw = dict(width=W, height=H, samples=SPP, lanes_per_pixel=KPP, **ROULETTE)
    st_j, st_t = _both(_state_np(H * W * KPP, seed=42))
    ref = JP.p_bounce_multi_step(
        jax_scene(), jax_camera(W, H), st_j, np.uint32(SALT), jnp.int32(3),
        JP.make_dims(JC(**kw), W, H, SPP, KPP), cfg=JP.step_cfg(JC(**kw)),
        hit_fn=hit_rows_adapter(jax_hit), k=K)
    cfg = TC(**kw)
    ours = B.bounce_multi_plain(sphere_table(random_scene()), _cam_rows(1),
                                st_t, SALT, 3,
                                TP.make_dims(cfg, W, H, SPP, KPP), cfg=cfg,
                                k=K, lean=False)
    for f, share in _close_shares(ours, ref).items():
        assert share > MULTI_SHARES[f], (f, share)


def test_plain_multi_matches_fused_multi_kernel_interpret():
    """Against the TPU k-bounce kernel itself (interpret mode), which the
    reference never pinned.  Its split-bf16 hit flips winners at ~1e-4;
    measured over four bounces (seed 43): every float row of the lanes
    that agree >= 0.995 close; bound 0.98, with the alive/depth/sample
    bounds of test_torch_bounce.py."""
    kw = dict(width=W, height=H, samples=SPP, lanes_per_pixel=KPP)
    n = 1024
    st_j, st_t = _both(_state_np(n, seed=43))
    ref = p_bounce_multi_fused(
        hit_coeffs(jax_scene()), jax_camera(W, H), st_j, np.uint32(SALT),
        jnp.int32(3), JP.make_dims(JC(**kw), W, H, SPP, KPP),
        cfg=JP.step_cfg(JC(**kw)), k=K, ray_block=RB, interpret=True)
    cfg = TC(**kw)
    ours = B.bounce_multi_plain(sphere_table(random_scene()), _cam_rows(1),
                                st_t, SALT, 3,
                                TP.make_dims(cfg, W, H, SPP, KPP), cfg=cfg,
                                k=K, lean=True)
    for f, share in _close_shares(ours, ref).items():
        assert share > 0.98, (f, share)


def test_bounce_multi_wrapper_on_cpu_is_the_plain_version():
    _, st = _both(_state_np(1024, seed=44))
    cfg = TC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP)
    args = (sphere_table(random_scene()), _cam_rows(3), st, SALT, 2,
            TP.make_dims(cfg, W, H, SPP, KPP))
    before = (B.LAUNCHES, B.MULTI_LAUNCHES)
    a = B.bounce_multi(*args, cfg=cfg, k=3, lean=True)
    b = B.bounce_multi_plain(*args, cfg=cfg, k=3, lean=True)
    assert (B.LAUNCHES, B.MULTI_LAUNCHES) == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="k must be"):
        B.bounce_multi(*args, cfg=cfg, k=0)
    meta = st._replace(origin=st.origin.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        B.bounce_multi(args[0], args[1], meta, *args[3:], cfg=cfg)
