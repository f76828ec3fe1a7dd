"""PyTorch port: the command-line interface (cli.py) against the JAX
package's parser, and its render, perf and flythrough modes on the CPU."""

import argparse
import json

import numpy as np
import pytest
import torch

from win32_raytracer_tpu.api import render as jax_render
from win32_raytracer_tpu.cli import build_parser as jax_build_parser
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu_torch import cli
from win32_raytracer_tpu_torch.api import render
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.io.image import read_image

torch.set_num_threads(1)


def _actions(parser):
    """Every argument's (flags or dest, nargs, default, choices, type,
    action kind), help texts aside."""
    return [(tuple(a.option_strings) or a.dest, a.dest, a.nargs, a.default,
             a.choices, a.type, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)]


def test_parser_matches_reference():
    """The same positionals (width height samples devices perf), flags,
    defaults and choices as win32_raytracer_tpu.cli."""
    ours, ref = _actions(cli.build_parser()), _actions(jax_build_parser())
    assert ours == ref
    assert [a[0] for a in ours[:5]] == ["width", "height", "samples",
                                        "devices", "perf"]
    args = cli.build_parser().parse_args(["320", "200", "8", "0", "perfTest"])
    assert (args.width, args.height, args.samples, args.perf) == (320, 200, 8,
                                                                 "perfTest")


def test_main_writes_bmp_on_the_cpu(tmp_path, capsys):
    """``cli 48 32 4 --scene test --platform cpu`` renders what api.render
    renders (the wavefront scheduler, below 8 spp) and writes a BMP that
    reads back; it matches the reference's render of the same config."""
    out = tmp_path / "cli.bmp"
    rc = cli.main(["48", "32", "4", "--scene", "test", "--seed", "3",
                   "--platform", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_image(str(out))
    want = render("test", cfg=TC(width=48, height=32, samples=4, seed=3),
                  device="cpu").image
    np.testing.assert_array_equal(img, want)
    ref = jax_render("test", cfg=JC(width=48, height=32, samples=4, seed=3)).image
    assert np.abs(img.astype(float) - ref.astype(float)).mean() < 0.05
    err = capsys.readouterr().err
    assert "scene=test 48x32 spp=4 depth=10 seed=3 backend=auto" in err
    assert f"wrote {out}" in err


def test_perf_mode_writes_the_perf_file(tmp_path, capsys):
    perf = tmp_path / "perf.txt"
    rc = cli.main(["32", "24", "2", "0", "perfTest", "--scene", "test",
                   "--platform", "cpu", "--perf-file", str(perf), "--quiet"])
    assert rc == 0
    ms = int(perf.read_text().strip())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "Mrays/sec primary" and line["unit"] == "Mrays/s"
    assert line["value"] > 0 and abs(line["wall_ms"] - ms) <= 1
    assert line["config"] == "32x24@2spp scene=test"
    assert not (tmp_path / "out.bmp").exists()


def test_animate_writes_frames(tmp_path):
    pattern = str(tmp_path / "fly.png")
    rc = cli.main(["24", "16", "2", "--scene", "test", "--animate", "2",
                   "--platform", "cpu", "--out", pattern, "--quiet"])
    assert rc == 0
    for i in range(2):
        assert read_image(str(tmp_path / f"fly_{i:04d}.png")).shape == (16, 24, 3)


def test_refusals(tmp_path):
    """More than one device: ``devices`` 2 on the CPU starts two ranks,
    and rank 0 writes an image that agrees with the one-device render in
    its statistics (other draws); --animate with --checkpoint exits 2 as
    in the reference; an unknown
    --platform raises; with no platform the card is required, as
    api.resolve_device requires it.  --checkpoint renders and resumes:
    a checkpoint left after one of two passes, resumed by the CLI, gives
    the bytes of an uninterrupted CLI run."""
    from win32_raytracer_tpu_torch.scene.builders import get_scene
    from win32_raytracer_tpu_torch.utils.checkpoint import (
        load_checkpoint, render_with_checkpoints)
    base = ["16", "8", "2", "--scene", "test", "--quiet"]
    two, one = tmp_path / "two.bmp", tmp_path / "one.bmp"
    for n, out in (("2", two), ("0", one)):
        assert cli.main(["16", "8", "8", n, "--scene", "test", "--platform",
                         "cpu", "--quiet", "--out", str(out)]) == 0
    a, b = read_image(str(two)), read_image(str(one))
    assert a.shape == b.shape == (8, 16, 3)
    assert np.abs(a.astype(float) - b.astype(float)).mean() < 6.0
    assert cli.main(base + ["--platform", "cpu", "--animate", "2",
                            "--checkpoint", "x.npz"]) == 2
    with pytest.raises(ValueError, match="platform"):
        cli.main(base + ["--platform", "tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base)

    ck = ["16", "8", "16", "--scene", "test", "--seed", "5", "--passes", "2",
          "--platform", "cpu", "--quiet"]
    full, half = tmp_path / "full.npz", tmp_path / "half.npz"
    out_full, out_half = tmp_path / "full.bmp", tmp_path / "half.bmp"
    assert cli.main(ck + ["--checkpoint", str(full), "--out",
                          str(out_full)]) == 0
    assert load_checkpoint(str(full))[1] == 2
    # The CLI's config (8 spp a pass: the persistent scheduler).
    cfg = TC(width=16, height=8, samples=16, seed=5, stratify=False)
    assert render_with_checkpoints(get_scene("test"), None, cfg, str(half),
                                   passes=2, max_passes_per_run=1,
                                   device="cpu") is None
    assert load_checkpoint(str(half))[1] == 1
    assert cli.main(ck + ["--checkpoint", str(half), "--out",
                          str(out_half)]) == 0
    assert out_half.read_bytes() == out_full.read_bytes()
    assert load_checkpoint(str(half))[1] == 2
