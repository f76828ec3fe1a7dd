"""PyTorch port: the recorder of ``utils/profiling.py`` (spans and counters
inside the schedulers) and the benchmark's readers of it
(``port_bench/spans.py``, ``port_bench/metrics/``).

On the CPU: the recorder off records nothing; on, under ``torch.profiler``
or ``recording()``, its spans nest as the scheduler runs and stand among
the profiler's host events, its counters equal the steps and lanes the
scheduler ran, and images are bit-equal either way.  The readers are held
to planted logs.  The two-rank lockstep table is in
tests/test_torch_persistent_shard.py."""

import numpy as np
import pytest
import torch

from port_bench import cells, spans
from win32_raytracer_tpu_torch import persistent as P
from win32_raytracer_tpu_torch.animation import orbit_path, render_animation
from win32_raytracer_tpu_torch.api import render
from win32_raytracer_tpu_torch.config import RenderConfig
from win32_raytracer_tpu_torch.kernels import bounce as B
from win32_raytracer_tpu_torch.kernels import dispatch
from win32_raytracer_tpu_torch.scene.builders import get_scene, mesh_scene
from win32_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

# 48x32 at 16 spp, 4 lanes a pixel: 6,144 lanes.  With the floor at 4,096
# the first steps run above it (kernel B's route) and the rest in the torch
# tail; one_shot="off" keeps the tail in the checked host loop.
CFG = dict(width=48, height=32, samples=16, seed=5, one_shot="off")
FLOOR = 4096


def _render(cfg=CFG, scene="test"):
    return P.render_image_persistent(get_scene(scene), None,
                                     RenderConfig(**cfg))


def _names(log):
    return [s["name"] for s in log["spans"]]


def test_recorder_off_records_nothing(monkeypatch):
    """Outside a profiler and ``recording()`` a render leaves the log as it
    was, every span is the one shared no-op and the kernel counters are
    never made."""
    monkeypatch.setattr(P, "_COMPACT_FLOOR", FLOOR)
    with profiling.recording():
        _render()
    before = profiling.log()
    seen = []
    real = P._alive_count

    def spy(alive):
        seen.append((profiling.on(), profiling.span("a"), profiling.span("b"),
                     profiling.device_counters({0: "x"}, 1, "cpu")))
        return real(alive)
    monkeypatch.setattr(P, "_alive_count", spy)
    _render()
    assert seen and all(on is False and a is b and c is None
                        for on, a, b, c in seen)
    assert profiling.log() == before
    assert not profiling.on()


def test_spans_nest_and_stand_in_the_profiler(monkeypatch):
    """A render under ``torch.profiler`` (the CPU) records: one root, the
    chunk under it, the scheduler's phases under the chunk, each span's
    name among the profiler's host events; the log restarts with it."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(P, "_COMPACT_FLOOR", FLOOR)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render()
    log = profiling.log()
    s = log["spans"]
    roots = [x for x in s if x["parent"] is None]
    assert [x["name"] for x in roots] == ["persistent.render"]
    by_name = {}
    for i, x in enumerate(s):
        by_name.setdefault(x["name"], []).append(i)
        assert x["end_ns"] >= x["start_ns"]
        assert x["rank"] == 0 and x["render"] == roots[0]["render"]
    chunk = by_name["persistent.chunk"][0]
    assert s[chunk]["parent"] == 0
    for name in ("persistent.respawn", "persistent.bounce_kernel",
                 "persistent.bounce_tail", "persistent.count_read",
                 "persistent.compact", "persistent.flush"):
        assert name in by_name, name
        assert all(s[i]["parent"] == chunk for i in by_name[name]), name
    # Kernel steps run before the first tail step; spans nest in time.
    assert (s[by_name["persistent.bounce_kernel"][0]]["start_ns"]
            < s[by_name["persistent.bounce_tail"][0]]["start_ns"])
    for x in s:
        if x["parent"] is not None:
            p = s[x["parent"]]
            assert p["start_ns"] <= x["start_ns"] <= x["end_ns"] <= p["end_ns"]
    host = {e.name for e in prof.events()}
    assert set(by_name) <= host
    # Function ranges, not user annotations: the profiler would project an
    # annotation onto the card's timeline, where a device trace counts it.
    assert not any(e.is_user_annotation for e in prof.events()
                   if e.name in by_name)
    # Recorded renders back to back share a stretch of the log; a recorded
    # render after an unrecorded one starts a new stretch.
    with profile(activities=[ProfilerActivity.CPU]):
        _render()
    assert _names(profiling.log()).count("persistent.render") == 2
    _render()
    with profile(activities=[ProfilerActivity.CPU]):
        _render()
    assert _names(profiling.log()).count("persistent.render") == 1


def test_counters_equal_the_steps_and_lanes(monkeypatch):
    """The counters against the bounces that ran, with the tail on the
    torch chain (``multi_backend="xla"``): kernel B's calls (its plain
    version on the CPU) and the torch tail's ``p_bounce_step`` calls, with
    their widths; compactions against ``_compact``'s calls; the count
    reads' alive lanes within their widths."""
    monkeypatch.setattr(P, "_COMPACT_FLOOR", FLOOR)
    got = {"kernel": [], "tail": [], "compact": 0}
    real_b, real_tail, real_compact = B.bounce, P.p_bounce_step, P._compact

    def kernel_b(scene, cam_rows, st, *a, **k):
        got["kernel"].append(st.pixel.shape[1])
        return real_b(scene, cam_rows, st, *a, **k)

    def tail(scene, cam, st, *a, **k):
        got["tail"].append(st.pixel.shape[1])
        return real_tail(scene, cam, st, *a, **k)

    def compact(*a, **k):
        got["compact"] += 1
        return real_compact(*a, **k)
    monkeypatch.setattr(B, "bounce", kernel_b)
    monkeypatch.setattr(P, "p_bounce_step", tail)
    monkeypatch.setattr(P, "_compact", compact)
    with profiling.recording():
        _render(dict(CFG, multi_backend="xla"))
    log = profiling.log()
    (c,) = log["counters"].values()
    assert got["kernel"] and got["tail"] and got["compact"]
    assert "persistent.steps_tail_fused" not in c
    assert c["persistent.steps_kernel"] == len(got["kernel"])
    assert c["persistent.lanes_kernel"] == sum(got["kernel"])
    assert c["persistent.steps_tail"] == len(got["tail"])
    assert c["persistent.lanes_tail"] == sum(got["tail"])
    assert c["persistent.compactions"] == got["compact"]
    assert _names(log).count("persistent.compact") == got["compact"]
    reads = _names(log).count("persistent.count_read")
    assert reads >= 2
    assert 0 < c["persistent.alive_at_reads"] <= c["persistent.width_at_reads"]
    assert c["persistent.width_at_reads"] <= reads * 6144
    share = spans.tail_share(log)
    assert 0.0 < share < 1.0
    assert spans.lane_occupancy(log) == pytest.approx(
        c["persistent.alive_at_reads"] / c["persistent.width_at_reads"])


def test_one_shot_chunks_count_as_tail():
    """A chunk at or below the floor runs whole as one shot: all of it is
    tail, its steps counted as such (the torch chain's under
    ``multi_backend="xla"``)."""
    cfg = dict(CFG, one_shot="auto", multi_backend="xla")
    with profiling.recording():
        _render(cfg)
    log = profiling.log()
    (c,) = log["counters"].values()
    assert "persistent.one_shot" in _names(log)
    assert c["persistent.steps_tail"] > 0
    assert "persistent.steps_kernel" not in c
    assert "persistent.steps_tail_fused" not in c
    assert 0.9 < spans.tail_share(log) <= 1.0
    assert spans.lane_occupancy(log) is None


def _kernel_spies(monkeypatch):
    """Record each call of kernel B and B-multi (plain versions here) as
    (width, bounces, the innermost open span)."""
    calls = []
    rec = profiling._REC

    def spy(fn):
        def wrapped(scene, cam_rows, st, *a, **k):
            inner = rec.spans[rec.stack[-1]][0] if rec.stack else None
            calls.append((st.pixel.shape[1], k.get("k", 1), inner))
            return fn(scene, cam_rows, st, *a, **k)
        return wrapped
    monkeypatch.setattr(B, "bounce", spy(B.bounce))
    monkeypatch.setattr(B, "bounce_multi", spy(B.bounce_multi))
    return calls


@pytest.mark.parametrize("one_shot", ["off", "auto", "on", "staged"])
def test_default_tail_counts_as_fused(one_shot, monkeypatch):
    """Under the default route every bounce at or below the floor runs on
    kernel B-multi or B inside the tail's spans, and
    ``persistent.steps_tail_fused`` counts them; the torch chain's
    counters stay absent, above-floor bounces count as "kernel", and the
    tail's share of the render is read as before."""
    monkeypatch.setattr(P, "_COMPACT_FLOOR", FLOOR)
    calls = _kernel_spies(monkeypatch)
    with profiling.recording():
        _render(dict(CFG, one_shot=one_shot))
    log = profiling.log()
    (c,) = log["counters"].values()
    below = [(n, inner) for w, n, inner in calls if w <= FLOOR]
    above = [(w, inner) for w, n, inner in calls if w > FLOOR]
    assert below and above
    assert c["persistent.steps_tail_fused"] == sum(n for n, _ in below)
    assert "persistent.steps_tail" not in c
    assert "persistent.lanes_tail" not in c
    assert c["persistent.steps_kernel"] == len(above)
    assert c["persistent.lanes_kernel"] == sum(w for w, _ in above)
    tail_spans = {"persistent.bounce_tail", "persistent.one_shot",
                  "persistent.staged"}
    assert all(inner in tail_spans for _, inner in below)
    assert all(inner == "persistent.bounce_kernel" for _, inner in above)
    assert 0.0 < spans.tail_share(log) < 1.0


def test_mesh_counts_no_fused_tail(monkeypatch):
    """A mesh has no kernel B: below the floor its bounces are the split
    bounce, whose scatter + respawn is kernel F (its plain version here),
    counted by ``persistent.steps_tail`` and, like every split bounce,
    ``persistent.scatter_kernel``; no ``persistent.steps_tail_fused`` and
    no ``persistent.scatter_torch``."""
    monkeypatch.setattr(P, "_COMPACT_FLOOR", FLOOR)
    calls = _kernel_spies(monkeypatch)
    with profiling.recording():
        P.render_image_persistent(mesh_scene(subdivisions=3), None,
                                  RenderConfig(**dict(CFG, width=32,
                                                      height=16)))
    (c,) = profiling.log()["counters"].values()
    assert not calls
    assert c["persistent.steps_tail"] > 0
    assert "persistent.steps_tail_fused" not in c
    assert c["persistent.scatter_kernel"] == (
        c["persistent.steps_tail"] + c.get("persistent.steps_kernel", 0))
    assert "persistent.scatter_torch" not in c


@pytest.mark.parametrize("entry", ["persistent", "wavefront", "api",
                                   "animation", "mesh_grid"])
def test_images_bit_equal_on_and_off(entry):
    """Every entry point renders the same bits with the recorder on and
    off, and roots its spans where the render entered."""
    scene = get_scene("test")
    cfg = RenderConfig(width=32, height=16, samples=8, seed=3)

    def run():
        if entry == "persistent":
            return P.render_image_persistent(scene, None, cfg).numpy()
        if entry == "wavefront":
            from win32_raytracer_tpu_torch.render import render_image
            return render_image(scene, None, cfg.replace(samples=4)).numpy()
        if entry == "api":
            return render(scene, None, cfg, device="cpu").image
        if entry == "animation":
            cams = orbit_path(n_frames=2, aspect_ratio=2.0)
            return np.stack(render_animation(scene, cams, cfg,
                                             device="cpu"))
        return P.render_image_persistent(mesh_scene(subdivisions=3), None,
                                         cfg.replace(samples=4)).numpy()
    off = run()
    with profiling.recording():
        on = run()
    np.testing.assert_array_equal(on, off)
    root = {"persistent": "persistent.render", "wavefront": "wavefront.render",
            "api": "api.render", "animation": "animation.render_animation",
            "mesh_grid": "persistent.render"}[entry]
    names = _names(profiling.log())
    assert names[0] == root and names.count(root) == 1


def test_kernel_d_counters_reach_the_grid_pass(monkeypatch):
    """While a render records, the triangle grid's pass hands kernel D one
    int64 [4] stats tensor for the render, read once at its end into the
    pair-test and any-touch counters (the plain sweep on the CPU counts
    nothing, so a stand-in adds to it); off, no tensor is passed."""
    real = dispatch.hit_triangles_grid_rows
    seen = []

    def counting(*a, stats=None, **k):
        seen.append(stats)
        if stats is not None:
            stats += torch.tensor([1, 5, 3, 2], dtype=torch.int64)
        return real(*a, **k)
    monkeypatch.setattr(dispatch, "hit_triangles_grid_rows", counting)
    cfg = RenderConfig(width=32, height=16, samples=4, seed=2)
    scene = mesh_scene(subdivisions=3)
    P.render_image_persistent(scene, None, cfg)
    assert seen and all(s is None for s in seen)
    seen.clear()
    with profiling.recording():
        P.render_image_persistent(scene, None, cfg)
    assert seen and all(s is seen[0] for s in seen)
    (c,) = profiling.log()["counters"].values()
    assert c["tri_grid.pair_tests"] == 5 * len(seen)
    assert c["tri_grid.touch_tests"] == 3 * len(seen)


# --- the readers, against planted logs -------------------------------------

def _span(name, parent, start, end, render=0, rank=0):
    return dict(name=name, parent=parent, render=render, rank=rank,
                start_ns=start, end_ns=end)


def _log(span_list=(), counters=None, tables=()):
    return {"spans": list(span_list), "counters": counters or {},
            "tables": list(tables)}


PLANTED = _log(
    [_span("api.render", None, 0, 1000),
     _span("persistent.render", 0, 0, 1000),
     _span("persistent.chunk", 1, 0, 1000),
     _span("persistent.bounce_kernel", 2, 0, 100),
     _span("persistent.count_read", 2, 100, 110),     # above the floor
     _span("persistent.compact", 2, 110, 150),        # above the floor
     _span("persistent.bounce_tail", 2, 150, 500),
     _span("persistent.count_read", 2, 500, 520),
     _span("persistent.compact", 2, 520, 600),
     _span("persistent.staged", 2, 600, 900),
     _span("persistent.compact", 9, 650, 700),        # inside staged
     _span("persistent.flush", 2, 900, 1000)],
    counters={0: {"persistent.alive_at_reads": 30,
                  "persistent.width_at_reads": 120,
                  "tri_grid.pair_tests": 10 ** 9,
                  "tri_grid.touch_tests": 2 * 10 ** 9}},
    tables=[{"name": "shard.lockstep_ms", "render": 0, "rank": 0,
             "rows": [[5.0, 1.0], [2.0, 1.0]]}])


@pytest.fixture
def planted(monkeypatch):
    monkeypatch.setattr(spans, "port_log", lambda: PLANTED)


def test_tail_share_reader(planted):
    """Tail from the first tail span on: 350 + 20 + 80 + 300 of 1000 ns;
    the compaction inside staged is not counted twice."""
    assert spans.tail_share(PLANTED) == pytest.approx(0.75)
    assert cells.metric("tail_share.persistent")({}) == pytest.approx(0.75)


def test_lane_occupancy_reader(planted):
    assert cells.metric("lane_occupancy.persistent")({}) == pytest.approx(0.25)


def test_tri_grid_roofline_reader(planted):
    """(1e9 x 52 + 2e9 x 27) operations at 67 TFLOP/s over 100 ms of
    kernel D and its schedule kernel."""
    trace = {"calls": 1, "device_ms": {"kernel D (triangle grid)": 90.0,
                                       "kernel D schedule (triangle grid)":
                                       10.0}}
    want = 100 * (52e9 + 54e9) / 67e12 / 0.1
    read = cells.metric("tri_grid_roofline.finished")
    assert read({"trace": trace}) == pytest.approx(want)
    assert read({"trace": None}) is None


def test_lockstep_readers(planted):
    """Ranks [[5, 1], [2, 1]] ms over two collectives: the least rank's
    time per collective, 2 + 1, is transfer; each rank's excess, 3 and 0,
    averages to a wait of 1.5; one call."""
    assert spans.calls(PLANTED) == 1
    assert cells.metric("collective_transfer_ms_per_call")({}) == 3.0
    assert cells.metric("lockstep_wait_ms_per_call")({}) == 1.5


def test_readers_find_nothing(monkeypatch):
    """An empty log, and a program with no recorder (no ``log``), give no
    value and raise nothing."""
    names = ("tail_share.persistent", "lane_occupancy.persistent",
             "tri_grid_roofline.finished", "lockstep_wait_ms_per_call",
             "collective_transfer_ms_per_call")
    s = {"trace": {"calls": 1, "device_ms": {"kernel D (triangle grid)": 1.0}}}
    monkeypatch.setattr(profiling, "log", lambda: _log())
    assert all(cells.metric(n)(s) is None for n in names)
    monkeypatch.delattr(profiling, "log")
    assert spans.port_log() is None
    assert all(cells.metric(n)(s) is None for n in names)
    assert spans.lockstep_ms(_log([_span("api.render", None, 0, 1)])) is None
