"""PyTorch port: the brute triangle sweep's span and counter
(``kernels/dispatch._tri_brute_pass``) and the benchmark's readers of
them and of kernel C's device time (``port_bench/metrics/``:
``tri_brute_roofline.finished``, ``tri_brute_lanes_per_segment``,
``launches_per_render.brute``).

On the CPU: under ``profiling.recording()`` a render of the ``mesh`` scene
(332 triangles, below the grid threshold) logs one span ``tri_brute.hit``
a brute pass and counts the lanes each pass swept in ``tri_brute.lanes``;
off, it makes no counter and renders the same bits.  On a card (``card``,
skipped here): the counted lanes against the lanes kernel C was launched
on.  This file imports no JAX, so the card test runs on a machine without
it:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_tri_brute_tracing.py
"""

import numpy as np
import pytest
import torch

from port_bench import cells
from win32_raytracer_tpu_torch import persistent as P
from win32_raytracer_tpu_torch.config import RenderConfig
from win32_raytracer_tpu_torch.kernels import dispatch
from win32_raytracer_tpu_torch.kernels import tri as KC
from win32_raytracer_tpu_torch.scene.builders import get_scene
from win32_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

# 48x32 at 16 spp: 6,144 lanes.  With the floor at 4,096 the first bounces
# take the split route above it and the rest the torch tail, so both call
# the brute pass; one_shot="off" keeps the tail in the checked host loop.
CFG = RenderConfig(width=48, height=32, samples=16, seed=5, one_shot="off")
FLOOR = 4096


@pytest.fixture
def tri_calls(monkeypatch):
    """The lanes of each call of the brute sweep's hit function (kernel C's
    wrapper; its plain version on the CPU)."""
    calls = []
    real = dispatch.hit_triangles_rows

    def spy(tris, o, d, t, **k):
        calls.append(o.shape[1])
        return real(tris, o, d, t, **k)
    monkeypatch.setattr(dispatch, "hit_triangles_rows", spy)
    monkeypatch.setattr(P, "_COMPACT_FLOOR", FLOOR)
    return calls


def _render(device="cpu"):
    return P.render_image_persistent(get_scene("mesh", device=device), None,
                                     CFG)


def test_brute_passes_are_spans_and_their_lanes_are_counted(tri_calls):
    """One span ``tri_brute.hit`` a call of kernel C's entry, each inside
    the render; ``tri_brute.lanes`` is the sum of the calls' lanes."""
    with profiling.recording():
        _render()
    log = profiling.log()
    spans = log["spans"]
    (c,) = log["counters"].values()
    assert len(tri_calls) > 2
    hits = [s for s in spans if s["name"] == "tri_brute.hit"]
    assert len(hits) == len(tri_calls)
    for s in hits:
        p = s
        while p["parent"] is not None:
            p = spans[p["parent"]]
        assert p["name"] == "persistent.render"
        assert s["end_ns"] >= s["start_ns"]
    assert c["tri_brute.lanes"] == sum(tri_calls)
    # Both routes swept: the split route above the floor, the tail below.
    assert c["persistent.steps_kernel"] > 0 and c["persistent.steps_tail"] > 0


def test_recorder_off_adds_nothing(tri_calls):
    """Off, nothing is logged and no counter is made, and the linear image
    equals a recorded render's bit for bit."""
    with profiling.recording():
        on = _render()
    before = profiling.log()
    n_on = len(tri_calls)
    off = _render()
    assert len(tri_calls) == 2 * n_on
    assert profiling.log() == before
    assert torch.equal(on, off)


@pytest.mark.card
def test_counted_lanes_are_kernel_c_launch_lanes(tri_calls):
    """On a card: over a recorded ``mesh`` render through the normal path,
    every brute pass with lanes launched kernel C once, and
    ``tri_brute.lanes`` equals the lanes of those launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    launches = KC.LAUNCHES
    with profiling.recording():
        _render(torch.device("cuda"))
    (c,) = profiling.log()["counters"].values()
    assert KC.LAUNCHES - launches == sum(1 for n in tri_calls if n) > 2
    assert c["tri_brute.lanes"] == sum(tri_calls)


# --- the readers, against planted logs and traces --------------------------

SEG = {"mean": 2.0}
TRIS = {"active": np.arange(384) < 332}
PLANTED = {"spans": [dict(name="api.render", parent=None, render=r, rank=0,
                          start_ns=0, end_ns=10) for r in (0, 1)],
           "counters": {0: {"tri_brute.lanes": 5 * 10 ** 6},
                        1: {"tri_brute.lanes": 3 * 10 ** 6}},
           "tables": []}
TRACE = {"calls": 2, "launches": {"a": 100, "b": 60},
         "device_ms": {"kernel C (triangle brute)": 40.0,
                       "kernel A (sphere hit)": 5.0}}


def _summary(trace=TRACE, seg=SEG):
    cell = {} if seg is None else {"segments_per_primary": seg}
    return {"trace": trace, "rays_per_call": 10 ** 6, "cell": cell,
            "arrays": {"triangles": TRIS}}


def test_tri_brute_readers(monkeypatch):
    """2e6 primary rays x 2 segments x 332 triangles x 52 operations at
    67 TFLOP/s over 40 ms of kernel C; 8e6 lanes over 4e6 segments; 160
    launches over 2 calls."""
    from port_bench import spans
    monkeypatch.setattr(spans, "port_log", lambda: PLANTED)
    s = _summary()
    roof = cells.metric("tri_brute_roofline.finished")
    assert roof(s) == pytest.approx(100 * 4e6 * 332 * 52 / 67e12 / 0.04)
    assert cells.metric("tri_brute_lanes_per_segment")(s) == 2.0
    assert cells.metric("launches_per_render.brute")(s) == 80.0


@pytest.mark.parametrize("case", ["no_recorder", "no_counter", "zero_counter",
                                  "no_trace", "no_kernel_c", "no_constant",
                                  "zero_constant"])
def test_tri_brute_readers_find_nothing(case, monkeypatch):
    """The parent's case (no counter), no trace, a trace without kernel C,
    or a cell without ``segments_per_primary``: the readers give None and
    raise nothing."""
    from port_bench import spans
    log, trace, seg = PLANTED, TRACE, SEG
    if case == "no_recorder":
        monkeypatch.delattr(profiling, "log")
    elif case == "no_counter":
        log = dict(PLANTED, counters={0: {"persistent.alive_at_reads": 3}})
    elif case == "zero_counter":
        log = dict(PLANTED, counters={0: {"tri_brute.lanes": 0}})
    elif case == "no_trace":
        trace = None
    elif case == "no_kernel_c":
        trace = dict(TRACE, device_ms={"kernel A (sphere hit)": 5.0})
    elif case == "no_constant":
        seg = None
    else:
        seg = {"mean": 0.0}
    if case != "no_recorder":
        monkeypatch.setattr(spans, "port_log", lambda: log)
    s = _summary(trace, seg)
    roof = cells.metric("tri_brute_roofline.finished")(s)
    lanes = cells.metric("tri_brute_lanes_per_segment")(s)
    launches = cells.metric("launches_per_render.brute")(s)
    if case in ("no_trace", "no_kernel_c", "no_constant", "zero_constant"):
        assert roof is None
    else:
        assert roof is not None
    if case in ("no_recorder", "no_counter", "zero_counter", "no_constant",
                "zero_constant"):
        assert lanes is None
    else:
        assert lanes == 2.0
    assert (launches is None) == (case == "no_trace")
