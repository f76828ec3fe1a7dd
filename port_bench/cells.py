"""What ``BENCHMARK.json`` and the files under ``port_bench/`` say about a
cell, found by name:

* ``workloads/<cell>.json``: the cell (its config, traffic, chips, why,
  and what the harness needs: ``traffic`` parameters, ``compare``,
  ``trace`` and measured constants such as ``segments_per_primary``);
* ``configs/<config>.json``: the deployment (scene, size, spp, ranks);
* ``scenes/<scene>.py``: the scene's arrays;
* ``metrics/<metric>.py``: one metric's ``read(summary)``.

Adding a cell, a config, a scene or a metric adds files; nothing here
changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def workload(name: str) -> dict:
    cell = _json(HERE, "workloads", f"{name}.json")
    cell["name"] = name
    return cell


def config(name: str) -> dict:
    return _json(HERE, "configs", f"{name}.json")


def scene(name: str) -> dict:
    """The arrays of scene ``name`` (``scenes/<name>.py``'s ``build()``)."""
    return importlib.import_module(f"port_bench.scenes.{name}").build()


def metric(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(cell: str, trace: bool, bench: dict = None) -> list:
    """(name, unit) of the metrics a run of ``cell`` reports: the
    end-to-end ones without a trace, the per-layer ones with one; a metric
    with ``workloads`` only in the cells it lists."""
    bench = bench or benchmark()
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if cell in m.get("workloads", [cell]):
            out.append((m["name"], m["unit"]))
    return out
