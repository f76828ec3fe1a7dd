"""PyTorch port: the sphere grid's spans and counters
(``kernels/dispatch._sphere_grid_pass``, ``accel.build_grid_accel``) and
the benchmark's readers of them (``port_bench/metrics/``:
``sphere_grid_roofline.finished``, ``sphere_grid_ms_per_mray``,
``launches_per_render.grid``).

On the CPU: under ``profiling.recording()`` a grid render counts pass A's
pair tests as the lanes of each hit call times the active globals, hands
kernel I one ``stats`` tensor for the render, and logs the spans
``sphere_grid.hit`` and ``accel.grid_build``; off, it makes no counter
tensor and renders the same bits.  On a card (``card``, skipped here):
kernel I's own counters over a render against the counts that
``accel.block_schedule`` gives on the same rays.  This file imports no
JAX, so the card test runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_sphere_grid_tracing.py
"""

import numpy as np
import pytest
import torch

from port_bench import cells
from win32_raytracer_tpu_torch import accel
from win32_raytracer_tpu_torch import persistent as P
from win32_raytracer_tpu_torch.accel import DEFAULT_RAY_BLOCK_GRID
from win32_raytracer_tpu_torch.config import MIN_HIT_T, RenderConfig
from win32_raytracer_tpu_torch.kernels import dispatch
from win32_raytracer_tpu_torch.kernels import hit_grid as KI
from win32_raytracer_tpu_torch.ops.hit import _A_RADIUS
from win32_raytracer_tpu_torch.scene.builders import get_scene
from win32_raytracer_tpu_torch.utils import profiling

CFG = RenderConfig(width=32, height=16, samples=8, seed=4, accel="grid")


@pytest.fixture
def hit_calls(monkeypatch):
    """Each call of the sphere grid's hit function (kernel I's wrapper; its
    plain version on the CPU) as (lanes, the grid, stats), the stats
    tensor gaining a stand-in's [2, 7] a call (the plain version counts
    nothing)."""
    calls = []
    real = dispatch.hit_spheres_grid_rows

    def spy(gscene, o, d, t, stats=None, **k):
        calls.append((o.shape[1], gscene, stats))
        if stats is not None:
            stats += torch.tensor([2, 7], dtype=torch.int64, device=o.device)
        return real(gscene, o, d, t, **k)
    monkeypatch.setattr(dispatch, "hit_spheres_grid_rows", spy)
    return calls


def _render(scene=None, cfg=CFG):
    return P.render_image_persistent(scene or get_scene("final"), None, cfg)


def test_pass_a_tests_are_lanes_times_active_globals(hit_calls):
    """``sphere_grid.pass_a_tests`` is the sum over the render's hit calls
    of lanes x the globals with r != 0; kernel I's counters come from one
    tensor for the render, read once at its end."""
    with profiling.recording():
        _render()
    (c,) = profiling.log()["counters"].values()
    assert hit_calls
    g = hit_calls[0][1]
    active = int((g.glob_attrs[:, _A_RADIUS] != 0).sum())
    assert g.glob_active == active == 4
    assert g.glob_attrs.shape[0] == 8        # padded: the shape is not it
    assert c["sphere_grid.pass_a_tests"] == sum(n for n, _, _ in hit_calls) * 4
    stats = hit_calls[0][2]
    assert stats is not None and all(s is stats for _, _, s in hit_calls)
    assert c["sphere_grid.cta_tiles"] == 2 * len(hit_calls)
    assert c["sphere_grid.pair_tests"] == 7 * len(hit_calls)


def test_spans_of_the_grid(hit_calls, monkeypatch):
    """Each hit call is a span ``sphere_grid.hit`` inside the render; a
    grid built for the render is span ``accel.grid_build``, a cached one
    is not."""
    monkeypatch.setattr(accel, "_SGRID_CACHE", {})
    scene = get_scene("final")
    with profiling.recording():
        _render(scene)
    spans = profiling.log()["spans"]
    names = [s["name"] for s in spans]
    assert names.count("sphere_grid.hit") == len(hit_calls)
    assert names.count("accel.grid_build") == 1
    for s in spans:
        if s["name"] in ("sphere_grid.hit", "accel.grid_build"):
            p = s
            while p["parent"] is not None:
                p = spans[p["parent"]]
            assert p["name"] == "persistent.render"
            assert s["end_ns"] >= s["start_ns"]
    with profiling.recording():
        _render(scene)
    assert "accel.grid_build" not in [s["name"] for s in
                                      profiling.log()["spans"]]


def test_recorder_off_adds_nothing(hit_calls):
    """Off, kernel I is handed no stats tensor, nothing is logged, and the
    image equals a recorded render's bit for bit."""
    with profiling.recording():
        on = _render().numpy()
    before = profiling.log()
    n_on = len(hit_calls)
    off = _render().numpy()
    assert all(s is None for _, _, s in hit_calls[n_on:])
    assert len(hit_calls) == 2 * n_on
    assert profiling.log() == before
    np.testing.assert_array_equal(on, off)


@pytest.mark.card
def test_kernel_i_counters_equal_the_schedule(monkeypatch):
    """On a card: over a recorded grid render through the normal path,
    kernel I's ``sphere_grid.pair_tests`` equal, call by call summed, the
    live lanes of each ray block x the rows with r != 0 of its scheduled
    tiles, and ``sphere_grid.cta_tiles`` the scheduled tiles x the sweep's
    CTAs a block; the schedule is ``accel.block_schedule`` (through
    ``hit_grid.schedule_plain``) on the same rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rb = DEFAULT_RAY_BLOCK_GRID
    per_block = -(-rb // KI.SWEEP_LANES_PER_CTA)
    want = {"pairs": 0, "tiles": 0, "calls": 0}
    real = dispatch.hit_spheres_grid_rows

    def spy(gscene, o, d, t, min_t=MIN_HIT_T, **k):
        n = o.shape[1]
        _, _, sched = KI.schedule_plain(gscene, o, d, t, min_t, rb, False)
        rows = (gscene.tile_attrs[:, _A_RADIUS] != 0).view(
            gscene.n_tiles, gscene.tile_rows).sum(1)
        count = sched[:, 0].long()
        taken = (torch.arange(gscene.n_tiles, device=o.device)[None]
                 < count[:, None])
        block_rows = (rows[sched[:, 1:].long()] * taken).sum(1)
        live = (n - torch.arange(sched.shape[0], device=o.device) * rb
                ).clamp(max=rb)
        want["pairs"] += int((live * block_rows).sum())
        want["tiles"] += int(count.sum()) * per_block
        want["calls"] += 1
        return real(gscene, o, d, t, min_t=min_t, **k)
    monkeypatch.setattr(dispatch, "hit_spheres_grid_rows", spy)
    cfg = RenderConfig(width=96, height=64, samples=16, seed=9, accel="grid")
    with profiling.recording():
        P.render_image_persistent(get_scene("final", device=dev), None, cfg)
    (c,) = profiling.log()["counters"].values()
    assert want["calls"] > 1 and want["pairs"] > 0
    assert c["sphere_grid.pair_tests"] == want["pairs"]
    assert c["sphere_grid.cta_tiles"] == want["tiles"]


# --- the readers, against planted logs -------------------------------------

PLANTED = {"spans": [dict(name="api.render", parent=None, render=0, rank=0,
                          start_ns=0, end_ns=10)],
           "counters": {0: {"sphere_grid.pair_tests": 10 ** 9,
                            "sphere_grid.pass_a_tests": 5 * 10 ** 8}},
           "tables": []}
TRACE = {"calls": 2, "launches": {"a": 100, "b": 60},
         "device_ms": {"kernel I (sphere grid)": 90.0,
                       "kernel I schedule (sphere grid)": 10.0,
                       "kernel B (fused bounce)": 500.0}}


def test_sphere_grid_readers(monkeypatch):
    """(1e9 + 5e8) tests x 24 operations at 67 TFLOP/s over 100 ms of
    kernel I and its schedule; those 100 ms over 2 calls of 1,000 primary
    rays; 160 launches over 2 calls."""
    from port_bench import spans
    monkeypatch.setattr(spans, "port_log", lambda: PLANTED)
    s = {"trace": TRACE, "rays_per_call": 1000}
    roof = cells.metric("sphere_grid_roofline.finished")
    assert roof(s) == pytest.approx(100 * 1.5e9 * 24 / 67e12 / 0.1)
    assert cells.metric("sphere_grid_ms_per_mray")(s) == pytest.approx(
        100.0 / (2 * 1000 / 1e6))
    assert cells.metric("launches_per_render.grid")(s) == 80.0


@pytest.mark.parametrize("case", ["no_recorder", "no_counters", "no_trace",
                                  "no_kernel_i"])
def test_sphere_grid_readers_find_nothing(case, monkeypatch):
    """The parent's case (no counters), no trace, or a trace without
    kernel I: the readers give None and raise nothing."""
    from port_bench import spans
    log = PLANTED
    trace = TRACE
    if case == "no_recorder":
        monkeypatch.delattr(profiling, "log")
    elif case == "no_counters":
        log = dict(PLANTED, counters={0: {"persistent.alive_at_reads": 3}})
    elif case == "no_trace":
        trace = None
    else:
        trace = dict(TRACE, device_ms={"kernel B (fused bounce)": 5.0})
    if case != "no_recorder":
        monkeypatch.setattr(spans, "port_log", lambda: log)
    s = {"trace": trace, "rays_per_call": 1000}
    assert cells.metric("sphere_grid_roofline.finished")(s) is None
    if case in ("no_trace", "no_kernel_i"):
        assert cells.metric("sphere_grid_ms_per_mray")(s) is None
    if case == "no_trace":
        assert cells.metric("launches_per_render.grid")(s) is None
