"""Every file the benchmark finds by name loads and agrees with
BENCHMARK.json; adding a cell, a config and a metric takes new files and
entries only."""

from __future__ import annotations

import json
import os

import pytest

from port_bench import cells

from .conftest import BENCH, ROOT, run_cpu, tiny_variant, write_json

BENCHMARK = cells.benchmark()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_file_matches_benchmark(name):
    cell = cells.workload(name)
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == name)
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key], key
    config = cells.config(cell["config"])
    assert os.path.exists(os.path.join(BENCH, "scenes", config["scene"] + ".py"))
    assert set(cell["compare"]["limits"]) == {"z_max", "noise_excess"}
    assert cell["params"]["entry"] in ("render", "animation")


@pytest.mark.parametrize("name", [c["name"] for c in BENCHMARK["configs"]])
def test_config_file(name):
    entry = next(c for c in BENCHMARK["configs"] if c["name"] == name)
    assert entry["file"] == f"port_bench/configs/{name}.json"
    config = cells.config(name)
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert config["why"] == entry["why"]
    for key in ("scene", "width", "height", "spp", "max_depth", "ranks"):
        assert key in config, key
    assert any(w["config"] == name for w in BENCHMARK["workloads"])
    # Its render settings pass the harness's rule, and its reference has
    # the interface every call goes through.
    settings = cells.render_settings(config)
    ref = cells.reference(config)
    assert isinstance(ref.FOLLOWS, tuple)
    assert callable(ref.render) and callable(ref.RefScene)
    assert set(cells.followed(config)) == set(settings) & set(ref.FOLLOWS)


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_exists(name):
    assert callable(cells.metric(name))


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_what_the_contract_asks(name):
    e2e = [m for m, _ in cells.metrics_of(name, False)]
    layer = [m for m, _ in cells.metrics_of(name, True)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    moved = {m["name"]: m["moves"] for m in BENCHMARK["per_layer"]}
    for m in layer:
        assert moved[m] in e2e, (m, moved[m])


def test_metric_workloads_exist():
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS, (m["name"], w)


def test_added_cell_config_and_metric_run(bench_copy):
    """A throwaway config, cell and per-layer metric, added as new files
    and BENCHMARK.json entries in a copy, run without touching a file
    that was there."""
    before = {p: open(p, "rb").read() for p in _files(bench_copy / "port_bench")}
    (bench_copy / "port_bench" / "metrics" / "calls_traced.py").write_text(
        "def read(s):\n    return s['trace']['calls'] if s['trace'] else None\n")
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "calls_traced", "unit": "calls", "better": "higher",
        "source": "device_trace", "layer": "device", "moves": "mrays_per_s",
        "workloads": ["tiny.finished"]})
    write_json(bench_copy / "BENCHMARK.json", bench)
    rc, out, err = run_cpu(bench_copy, "tiny.finished", trace=1)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True
    assert out["metrics"]["calls_traced"]["value"] == 1
    after = {p: open(p, "rb").read() for p in before}
    assert before == after


def test_added_config_with_render_settings_runs(bench_copy):
    """A config ``tiny_grid``, ``tiny`` with ``"render": {"accel": "grid"}``,
    and its cell, added as new files and entries in a copy: the port builds
    the sphere grid and sweeps it in the window, and the run is correct."""
    from .probes import SPHERE_GRID
    before = {p: open(p, "rb").read() for p in _files(bench_copy / "port_bench")}
    cell = tiny_variant(bench_copy, "tiny_grid", render={"accel": "grid"})
    rc, out, err = run_cpu(bench_copy, cell,
                           plant="port_bench.tests.probes:sphere_grid")
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, out["checks"]
    marks = (bench_copy / SPHERE_GRID).read_text().split("\n")
    assert "build GridScene" in marks
    assert marks.count("sweep") >= 2 * 10
    after = {p: open(p, "rb").read() for p in before}
    assert before == after


# A reference added as a new file: the float32 reference with its normal
# offset set from the port's ``epsilon``, which it therefore follows; each
# call leaves the value it was handed in a file of the run's directory.
FOLLOWING_REFERENCE = """
import json

from port_bench.reference import render as base

RefScene = base.RefScene
FOLLOWS = ("epsilon",)


def render(scene, cams, width, height, spp, max_depth, seed, *, epsilon,
           **kw):
    with open("followed.jsonl", "a") as f:
        f.write(json.dumps({"epsilon": epsilon}) + "\\n")
    eps, base.EPS = base.EPS, epsilon
    try:
        return base.render(scene, cams, width, height, spp, max_depth, seed,
                           **kw)
    finally:
        base.EPS = eps
"""


def test_added_reference_follows_its_setting(bench_copy):
    """A config names a reference added as a new file, whose ``FOLLOWS``
    holds ``epsilon``, and sets ``epsilon`` (which the default reference
    does not follow): the run checks with that module, which is handed the
    setting on every call, and is correct."""
    (bench_copy / "port_bench" / "reference" / "follows_epsilon.py").write_text(
        FOLLOWING_REFERENCE)
    cell = tiny_variant(bench_copy, "tiny_eps", render={"epsilon": 2e-5},
                        reference="follows_epsilon")
    rc, out, err = run_cpu(bench_copy, cell)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, out["checks"]
    calls = [json.loads(ln) for ln in
             (bench_copy / "followed.jsonl").read_text().splitlines()]
    # Two reference images for each call compared.
    assert calls == [{"epsilon": 2e-5}] * 2


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and port_bench/, a
    run exits with an error and prints no result."""
    import shutil
    import subprocess
    import sys
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; from port_bench import run; sys.exit(run.main(["
            "'--workload', 'final.finished', '--seed', '1', '--seconds', '1',"
            " '--trace', '0'], device_type='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def _files(root):
    for dirpath, _, names in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for n in names:
            yield os.path.join(dirpath, n)
