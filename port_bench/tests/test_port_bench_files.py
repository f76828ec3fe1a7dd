"""Every file the benchmark finds by name loads and agrees with
BENCHMARK.json; adding a cell, a config and a metric takes new files and
entries only."""

from __future__ import annotations

import json
import os

import pytest

from port_bench import cells

from .conftest import BENCH, ROOT, run_cpu, write_json

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
