"""PyTorch port: rendering over a mesh of ranks (``parallel/shard.py``,
the entry points with ``mesh=``, the CLI's ``devices``, the dry run and
``utils/profiling.py``) against the JAX package.

The port runs D = 2 and D = 4 gloo ranks on the CPU, one group per D for
the whole module (``torch_shard_cases.run_cases``); JAX renders on a mesh
of D virtual CPU devices (tests/conftest.py).  The wavefront's row and
sample modes draw jax.random's threefry bits on both sides, so their
images agree nearly pixel for pixel; each bound is about twice the value
measured, both written beside it."""

import os

import numpy as np
import pytest
import torch

from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.parallel.shard import make_mesh as jax_mesh
from win32_raytracer_tpu.parallel.shard import render_sharded as jax_sharded
from win32_raytracer_tpu.scene.builders import test_scene as jax_test_scene
from win32_raytracer_tpu_torch import cli
from win32_raytracer_tpu_torch.io.image import read_image
from win32_raytracer_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
from win32_raytracer_tpu_torch.render import tonemap

import torch_shard_cases as C

torch.set_num_threads(1)

ROWS = dict(width=64, height=48, samples=2, seed=11)
ROWS_ODD = dict(width=32, height=23, samples=2, seed=3)
SPP = dict(width=64, height=32, samples=16, seed=7)
CLI_CFG = dict(width=16, height=8, samples=8, seed=0)
FLY = dict(look_to=(0, 0, 0), radius=14.0, height=2.0, n_frames=3,
           aspect_ratio=2.0)
FLY_BATCHED = dict(look_to=(0, 0.5, 0), radius=12.0, height=2.0, n_frames=3,
                   aspect_ratio=1.5)


def _cases(d, out):
    cases = [
        ("rows", "sharded", dict(scene="test", mode="rows", **ROWS)),
        ("spp", "sharded", dict(scene="test", mode="spp", **SPP)),
        ("meshes", "meshes", {}),
        ("spp-indivisible", "raises", dict(case="sharded", scene="test",
                                           mode="spp", width=16, height=8,
                                           samples=3 if d == 2 else 6)),
        ("bogus", "raises", dict(case="sharded", scene="test", mode="bogus",
                                 width=8, height=8, samples=1)),
    ]
    if d == 2:
        cases += [
            ("rows-odd", "sharded", dict(scene="test", mode="rows",
                                         **ROWS_ODD)),
            ("api-rows", "api_render", dict(scene="test", shard_mode="rows",
                                            **CLI_CFG)),
            ("api-persistent", "api_render", dict(
                scene="test", shard_mode="persistent", **CLI_CFG)),
            ("fly-spp", "animation", dict(
                scene="test", cams=FLY, out_dir=os.path.join(out, "fly2"),
                shard_mode="spp", batch_frames=0, width=32, height=16,
                samples=8, seed=2)),
            ("checkpoint", "checkpoint", dict(
                out_dir=out, width=24, height=12, samples=32, seed=6,
                scheduler="persistent")),
        ]
    else:
        cases += [
            ("fly-batched", "animation", dict(
                scene="test", cams=FLY_BATCHED,
                out_dir=os.path.join(out, "fly4"), shard_mode="rows",
                batch_frames=3, width=24, height=16, samples=16, seed=7,
                scheduler="persistent")),
            ("fly-spp-batched", "raises", dict(
                case="animation", scene="test", cams=FLY_BATCHED,
                out_dir=os.path.join(out, "unused"), shard_mode="spp",
                batch_frames=2, width=24, height=16, samples=16, seed=7)),
        ]
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of each group: {d: {case name: result}}."""
    out = {}
    for d in (2, 4):
        tmp = str(tmp_path_factory.mktemp(f"ranks{d}"))
        for sub in ("fly2", "fly4", "unused"):
            os.makedirs(os.path.join(tmp, sub))
        out[d] = spawn(d, C.run_cases, _cases(d, tmp))
    return out


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


def _u8(lin):
    return tonemap(torch.from_numpy(np.asarray(lin, np.float32))).numpy()


# (mode, d) -> (config, max mean |diff| of u8, min pearson r), about twice
# the values measured (in the comments: mean |diff|, r).
BOUNDS = {
    ("rows", 2): (ROWS, 0.01, 0.99999),       # 0.0, 1.0
    ("rows", 4): (ROWS, 0.01, 0.99999),       # 0.0, 1.0
    ("rows-odd", 2): (ROWS_ODD, 0.01, 0.99999),   # 0.0, 1.0
    ("spp", 2): (SPP, 0.01, 0.99999),         # 0.00033, 1.0
    ("spp", 4): (SPP, 0.01, 0.99999),         # 0.0, 1.0
}


@pytest.mark.parametrize("mode,d", sorted(BOUNDS))
def test_wavefront_modes_match_reference(ranks, mode, d):
    """Row mode (superchunks of D interleaved row blocks, the blocks
    gathered into image order; 23 rows do not divide) and sample mode
    (samples / D a rank, averaged in rank order) against the JAX package's
    shard_map render on a mesh of the same size."""
    cfg, max_d, min_r = BOUNDS[(mode, d)]
    got = _u8(ranks[d][mode])
    want = jax_sharded(jax_test_scene(), cfg=JC(backend="jnp", **cfg),
                       mesh=jax_mesh(d), mode=mode.split("-")[0])
    assert got.shape == want.shape == (cfg["height"], cfg["width"], 3)
    assert got[0, 0, 2] > 200                       # sky at the top
    assert (got.reshape(cfg["height"], -1).max(1) > 0).all()   # no black bands
    dd, r = _stats(got, want)
    assert dd <= max_d and r >= min_r, (dd, r)


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_construction(ranks, d):
    """A 1-D mesh named ("tiles",) over all ranks; make_mesh(2) covers
    ranks 0 and 1 (the rest get None); more ranks than the world raises."""
    m = ranks[d]["meshes"]
    assert m["size"] == d and m["names"] == ("tiles",)
    assert m["backend"] == "gloo"
    assert m["inside"] == [1, 1] + [0] * (d - 2)
    assert "world size" in m["err"]


@pytest.mark.parametrize("d", [2, 4])
def test_mode_refusals(ranks, d):
    """samples % devices != 0 in spp mode, and an unknown mode, raise
    ValueError (test_parallel.py's twins)."""
    kind, msg = ranks[d]["spp-indivisible"]
    assert kind == "ValueError" and "samples % devices" in msg
    kind, msg = ranks[d]["bogus"]
    assert kind == "ValueError" and "unknown mode" in msg


@pytest.mark.parametrize("mode", ["rows", "persistent"])
def test_api_render_on_mesh(ranks, mode):
    """api.render(mesh=) is render_sharded of the same arguments."""
    res = ranks[2][f"api-{mode}"]
    assert res["image"].shape == (8, 16, 3) and res["device"] == "cpu"
    np.testing.assert_array_equal(res["image"], res["direct"])


def test_flythrough_on_mesh(ranks):
    """render_animation(mesh=, shard_mode="spp"): frames one by one through
    api.render, the callback per frame, files from rank 0 only."""
    res = ranks[2]["fly-spp"]
    frames = res["frames"]
    assert len(frames) == 3 and all(f.shape == (16, 32, 3) for f in frames)
    assert res["got"] == [(i, (16, 32, 3), True) for i in range(3)]
    assert res["files"] == [f"fly_{i:04d}.png" for i in range(3)]
    assert np.abs(frames[0].astype(int) - frames[1].astype(int)).mean() > 1.0


def test_flythrough_mesh_batched(ranks, tmp_path_factory):
    """Batches of frames through the persistent scheduler over the mesh
    (shard_mode "rows"), written by rank 0; spp mode cannot batch; the
    batched frames match per-frame mesh renders statistically."""
    res = ranks[4]["fly-batched"]
    frames = res["frames"]
    assert len(frames) == 3 and [g[0] for g in res["got"]] == [0, 1, 2]
    assert all(f.shape == (16, 24, 3) for f in frames)
    assert res["files"] == [f"fly_{i:04d}.png" for i in range(3)]
    for a, b in zip(frames, res["singles"]):
        assert np.abs(a.astype(float) - b.astype(float)).mean() < 6.0
    kind, msg = ranks[4]["fly-spp-batched"]
    assert kind == "ValueError" and "shard_mode" in msg


def test_checkpoint_resume_on_mesh(ranks):
    """A sharded render stopped after one pass and resumed gives the bytes
    of the uninterrupted one; chunk checkpoints are refused on a mesh."""
    res = ranks[2]["checkpoint"]
    assert res["full"] is not None and res["full"].shape == (12, 24, 3)
    assert res["part"] is None and res["mid"] == 1
    np.testing.assert_array_equal(res["resumed"], res["full"])
    assert "chunk_checkpoints" in res["refusal"]


def test_cli_devices_on_cpu(ranks, tmp_path):
    """`... 16 8 8 2 --platform cpu` starts 2 ranks itself; rank 0 writes
    the image, which is api.render(mesh=) of the same arguments in the
    CLI's default shard mode ("persistent")."""
    out = tmp_path / "cli.bmp"
    rc = cli.main(["16", "8", "8", "2", "--scene", "test", "--platform",
                   "cpu", "--quiet", "--out", str(out)])
    assert rc == 0
    np.testing.assert_array_equal(read_image(str(out)),
                                  ranks[2]["api-persistent"]["image"])


def test_dryrun_multichip():
    """The dry run's renders in row, sample and persistent modes (the last
    also above a lowered compaction floor) on 2 gloo ranks."""
    assert dryrun_multichip(2) == [(16, 32, 3), (8, 32, 3), (16, 32, 3),
                                   (16, 64, 3)]


def test_phase_timer_and_trace(tmp_path):
    """utils/profiling.py: the recorder's span and counter calls are no-ops
    outside a recorded render and record inside one (``recording()``), the
    torch.profiler trace written as a Chrome trace holds the render's
    spans, and mrays.  (The name is the test's from before the recorder
    replaced ``PhaseTimer``.)"""
    import json

    from win32_raytracer_tpu_torch.config import RenderConfig
    from win32_raytracer_tpu_torch.persistent import render_image_persistent
    from win32_raytracer_tpu_torch.scene.builders import get_scene
    from win32_raytracer_tpu_torch.utils.profiling import (count, log, mrays,
                                                           recording, span,
                                                           trace)
    assert span("a") is span("b")
    with span("a"):
        count("a", 3)
    cfg = RenderConfig(width=16, height=8, samples=8, seed=1)
    scene = get_scene("test")
    with recording():
        render_image_persistent(scene, None, cfg)
    got = log()
    assert [s["name"] for s in got["spans"] if s["parent"] is None] == [
        "persistent.render"]
    assert all("a" not in c for c in got["counters"].values())
    assert abs(mrays(2_000_000, 2.0) - 1.0) < 1e-9
    with trace(str(tmp_path), "t") as prof:
        render_image_persistent(scene, None, cfg)
    assert prof.key_averages()
    with open(tmp_path / "t.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"persistent.render", "persistent.chunk"} <= names
