"""PyTorch port: kernel B's counters (``persistent.BOUNCE_STATS``), on the
CPU.  Kernels B and B-multi add into an int64 [2] buffer on the card; their
plain versions and the torch chain (``p_bounce_step``, ``_scatter_core``)
add the same from their masks.  Here: the plain B and B-multi buffers equal
the lanes alive at each bounce's start and the paths the roulette ended,
counted apart from the chain's masks; no kill without the roulette; a
render's ``persistent.live_lanes`` is at most the lanes it swept, and its
image is the same with the recorder on and off, which is off: no buffer is
made or handed to the kernels; nor is one for a lean render or a route
without kernel B.  Kernel B's counts against this plain
version on the card: ``chip_smoke.py`` phase 3.  This file imports no
JAX."""

from __future__ import annotations

import pytest
import torch

from port_bench import cells
from win32_raytracer_tpu_torch import persistent as P
from win32_raytracer_tpu_torch.config import RenderConfig
from win32_raytracer_tpu_torch.kernels import bounce as B
from win32_raytracer_tpu_torch.kernels.hit import hit_spheres_rows_plain
from win32_raytracer_tpu_torch.ops.hit import sphere_table
from win32_raytracer_tpu_torch.scene.builders import get_scene, mesh_scene
from win32_raytracer_tpu_torch.scene.camera import default_camera
from win32_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H, SPP = 24, 16, 25
SALT = 0x5EED26
# The roulette from the first scatter on, so that a few bounces kill paths.
ROULETTE = dict(stratify=True, russian_roulette=True, rr_start_depth=1)


def _batch(cfg):
    """(table, camera rows, dims, state) of a fresh batch of the final
    scene, one lane a pixel, after the first respawn."""
    dims = P.make_dims(cfg, W, H, SPP, 1)
    cam = default_camera(W, H)
    i32 = dict(dtype=torch.int32)
    n = W * H
    st = P.fresh_state(torch.arange(n, **i32)[None], torch.zeros((1, n), **i32),
                       torch.full((1, n), SPP, **i32))
    st = P.p_respawn_step(cam, st, SALT, 0, dims, cfg=cfg)
    return sphere_table(get_scene("final")), B.pack_camera(cam), dims, st


def _chain_counts(tab, st, step, dims, cfg):
    """(lanes alive at the bounce's start, paths the roulette ended), from
    the torch chain's masks: the kills are the lanes the scatter keeps alive
    without the roulette (``lean``) and loses with it."""
    rec, mid = P.p_hit_step(tab, st, cfg=cfg, hit_fn=hit_spheres_rows_plain)
    kept = P._scatter_core(mid, rec, SALT, step, dims, cfg=cfg, lean=True)
    played = P._scatter_core(mid, rec, SALT, step, dims, cfg=cfg, lean=False)
    kills = kept.path_alive & ~played.path_alive
    return int(st.path_alive.sum()), int(kills.sum())


def test_plain_bounce_stats_are_the_chains_masks():
    """Six plain bounces, each with its own buffer: [live, kills] equal the
    chain's masks, and the state equals the bounce's without a buffer, bit
    for bit; the k-bounce's one buffer over the same bounces is their sum."""
    cfg = RenderConfig(width=W, height=H, samples=SPP, **ROULETTE)
    tab, cam_rows, dims, st0 = _batch(cfg)
    st, total = st0, torch.zeros(2, dtype=torch.int64)
    for step in range(1, 7):
        want = _chain_counts(tab, st, step, dims, cfg)
        stats = torch.zeros(2, dtype=torch.int64)
        new = B.bounce_plain(tab, cam_rows, st, SALT, step, dims, cfg=cfg,
                             stats=stats)
        bare = B.bounce_plain(tab, cam_rows, st, SALT, step, dims, cfg=cfg)
        for f in P.PathState._fields:
            assert torch.equal(getattr(new, f), getattr(bare, f)), f
        assert stats.tolist() == list(want), step
        total += stats
        st = new
    assert total[1] > 0
    multi = torch.zeros(2, dtype=torch.int64)
    out = B.bounce_multi_plain(tab, cam_rows, st0, SALT, 1, dims, cfg=cfg,
                               k=6, stats=multi)
    assert torch.equal(multi, total)
    for f in P.PathState._fields:
        assert torch.equal(getattr(out, f), getattr(st, f)), f


@pytest.mark.parametrize("lean", [True, False])
def test_no_kills_without_the_roulette(lean):
    """Roulette off (stratified, so the non-lean steps also run): the kill
    count stays 0 and the live count is the alive lanes."""
    cfg = RenderConfig(width=W, height=H, samples=SPP, stratify=not lean)
    tab, cam_rows, dims, st = _batch(cfg)
    stats = torch.zeros(2, dtype=torch.int64)
    alive = int(st.path_alive.sum())
    B.bounce_multi_plain(tab, cam_rows, st, SALT, 1, dims, cfg=cfg, k=4,
                         lean=lean, stats=stats)
    assert stats[1] == 0
    assert alive <= stats[0] <= 4 * W * H


# A batch of 24x16 at 25 spp, one lane a pixel (384 lanes, padded to 512):
# above the lowered floor it runs kernel B's route and compacts, then the
# fused tail (kernels B-multi and B) below it.
RENDER = dict(width=W, height=H, samples=SPP, seed=9, one_shot="off")


def _render(**kw):
    return P.render_image_persistent(get_scene("test"), None,
                                     RenderConfig(**RENDER, **kw))


@pytest.fixture
def small_floor(monkeypatch):
    monkeypatch.setattr(P, "_COMPACT_FLOOR", 256)
    monkeypatch.setattr(P, "_MIN_LANES", 64)


@pytest.mark.parametrize("roulette", [True, False])
def test_render_counts_live_lanes_and_kills(roulette, small_floor, monkeypatch):
    """Recorded, a render counts its live lanes (at most its swept lanes,
    the fused tail's included) and its kills (none without the roulette),
    through one buffer handed to every kernel B and B-multi call; the
    benchmark's reader gives their share.  The image equals the unrecorded
    render's, whose calls get no buffer."""
    seen = []

    def spy(fn):
        def wrapped(*a, **k):
            seen.append(k.get("stats"))
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(B, "bounce_plain", spy(B.bounce_plain))
    monkeypatch.setattr(B, "bounce_multi_plain", spy(B.bounce_multi_plain))
    kw = ROULETTE if roulette else dict(stratify=True)
    bare = _render(**kw)
    assert seen and all(s is None for s in seen)
    seen.clear()
    with profiling.recording():
        got = _render(**kw)
    assert torch.equal(got, bare)
    assert seen and all(s is seen[0] for s in seen) and seen[0] is not None
    log = profiling.log()
    (c,) = log["counters"].values()
    swept = (c.get("persistent.lanes_kernel", 0) + c.get("persistent.lanes_tail", 0)
             + c["persistent.lanes_tail_fused"])
    assert c["persistent.lanes_kernel"] > 0
    assert 0 < c["persistent.live_lanes"] < swept
    assert (c["persistent.rr_kills"] > 0) == roulette
    share = cells.metric("live_lane_share.progressive")({"trace": None})
    assert share == c["persistent.live_lanes"] / swept


@pytest.mark.parametrize("case", ["mesh", "lean"])
def test_renders_that_make_no_buffer(case, small_floor, monkeypatch):
    """A mesh has no kernel B, and a lean render (neither strata nor the
    roulette) kills no path: recorded, neither loop makes a buffer, so no
    kernel B call gets one and neither counter appears."""
    seen = []
    monkeypatch.setattr(profiling, "device_counters",
                        lambda slots, size, device: seen.append(slots)
                        or torch.zeros(size, dtype=torch.int64))
    with profiling.recording():
        if case == "mesh":
            P.render_image_persistent(mesh_scene(subdivisions=1), None,
                                      RenderConfig(width=16, height=8,
                                                   samples=4, **ROULETTE))
        else:
            _render()
    (c,) = profiling.log()["counters"].values()
    assert c.get("persistent.lanes_kernel", 0) + c.get(
        "persistent.lanes_tail_fused", 0) + c.get("persistent.lanes_tail", 0) > 0
    assert P.BOUNCE_STATS not in seen
    assert "persistent.live_lanes" not in c
    assert "persistent.rr_kills" not in c
