"""The ``card`` marker, and a throwaway copy of the benchmark with a tiny
cell, in which a run drives the port on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# A tiny cell of the final scene, and a four-rank tiny flythrough; limits
# from readings at these sizes (sound ~0-3 / +-0.06, half the samples
# +0.5, the bfloat16 reference in the thousands).
TINY_LIMITS = {"z_max": 15.0, "noise_excess": 0.25}
TINY = {
    "tiny": {"source": "test", "scene": "final", "width": 96, "height": 64,
             "spp": 8, "max_depth": 10, "ranks": 1, "assumed": [],
             "reduced": []},
    "tiny4": {"source": "test", "scene": "final", "width": 16, "height": 32,
              "spp": 8, "max_depth": 4, "ranks": 4, "shard_mode": "rows",
              "frames": 2, "assumed": [], "reduced": []},
}
TINY_CELLS = {
    "tiny.finished": {"config": "tiny", "traffic": "finished", "chips": 1,
                      "why": "test",
                      "params": {"entry": "render", "camera": {"path": "fixed"},
                                 "frames": 1, "scheduler": "persistent"},
                      "compare": {"calls": 1, "limits": TINY_LIMITS},
                      "trace": {"skip": 1, "calls": 1}},
    "tiny4.flythrough": {"config": "tiny4", "traffic": "flythrough", "chips": 4,
                         "why": "test",
                         "params": {"entry": "animation",
                                    "camera": {"path": "orbit", "radius": 16.0,
                                               "height": 2.0, "step_deg": 7.0,
                                               "frame_step_deg": 45.0},
                                    "frames": 2, "scheduler": "persistent"},
                         "compare": {"calls": 1, "limits": {"z_max": 15.0,
                                                            "noise_excess": 1.0}},
                         "trace": {"skip": 1, "calls": 1}},
}


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_config(checkout, name, config):
    """``configs/<name>.json`` in a copy, a new file."""
    write_json(checkout / "port_bench" / "configs" / f"{name}.json", config)


def add_cell(checkout, name, cell):
    """``workloads/<name>.json`` and its BENCHMARK.json entry in a copy."""
    write_json(checkout / "port_bench" / "workloads" / f"{name}.json", cell)
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({k: cell[k] for k in
                               ("config", "traffic", "chips", "why")}
                              | {"name": name})
    write_json(checkout / "BENCHMARK.json", bench)


def tiny_variant(checkout, name, **keys):
    """A config ``name``: ``tiny`` with ``keys`` added, and its cell
    ``<name>.finished``: ``tiny.finished`` on it.  Returns the cell."""
    add_config(checkout, name, TINY["tiny"] | keys)
    add_cell(checkout, f"{name}.finished",
             TINY_CELLS["tiny.finished"] | {"config": name})
    return f"{name}.finished"


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and port_bench/ with the tiny cells added
    as new files and entries only."""
    dst = tmp_path / "checkout"
    shutil.copytree(BENCH, dst / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")
    for name, cfg in TINY.items():
        add_config(dst, name, cfg)
    for name, cell in TINY_CELLS.items():
        add_cell(dst, name, cell)
    return dst


def run_cpu(checkout, cell, seed=2200000017, seconds=0.5, trace=0,
            plant=None, timeout=900):
    """One run of ``cell`` in ``checkout`` on the CPU, in a fresh process
    (the port from this repo): (exit code, last JSON line or None, stderr)."""
    code = ("import sys; from port_bench import run; sys.exit(run.main("
            f"['--workload', {cell!r}, '--seed', '{seed}', '--seconds', "
            f"'{seconds}', '--trace', '{trace}'], device_type='cpu', "
            f"plant={plant!r}))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(checkout), ROOT]),
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1]) if lines else None
    return proc.returncode, out, proc.stderr
