"""What ``BENCHMARK.json`` and the files under ``port_bench/`` say about a
cell, found by name:

* ``workloads/<cell>.json``: the cell (its config, traffic, chips, why,
  and what the harness needs: ``traffic`` parameters, ``compare``,
  ``trace`` and measured constants such as ``segments_per_primary``);
* ``configs/<config>.json``: the deployment (scene, size, spp, ranks,
  and optionally ``render``, the port's render settings, and
  ``reference``, the plain reference it is held to);
* ``scenes/<scene>.py``: the scene's arrays;
* ``reference/<reference>.py``: a plain reference (``RefScene``,
  ``render``, ``FOLLOWS``);
* ``metrics/<metric>.py``: one metric's ``read(summary)``.

Adding a cell, a config, a scene, a reference or a metric adds files;
nothing here changes."""

from __future__ import annotations

import dataclasses
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


# A configuration's own keys set these fields of the port's RenderConfig
# (``spp`` sets ``samples``; the seed is the traffic's, one a call), so its
# ``render`` map may not.
OWN_KEYS = ("width", "height", "samples", "max_depth", "seed")

# Fields of the port's RenderConfig that a configuration's ``render`` map
# may name although its reference does not follow them: each picks a
# route, an accelerator, a kernel or a flush, and changes no image's
# distribution.  Beside each, the port's tests that hold it to the default
# path, bit for bit or to round-off.  A field that moves lanes, and with
# them the lane-keyed draws, renders only statistically alike and is left
# out; README.md lists every field left out and why.
NEUTRAL = {
    # The sphere grid's render equals the brute render bit for bit (one-shot
    # tail and the split route above the floor); the triangle grid's records
    # equal the brute sweep's.
    "accel": ("tests/test_torch_grid_render.py::test_grid_render_equals_brute",
              "tests/test_torch_tri_hit.py::test_plain_grid_matches_jnp_twin"),
    # Each route's render within mean |diff| 0.06 (u8) and Pearson r 0.9999
    # of the JAX package's default render, on the same draws.
    "fuse_bounce": ("tests/test_torch_routes.py::test_route_renders_and_matches_reference",),
    "scatter_backend": ("tests/test_torch_routes.py::test_route_renders_and_matches_reference",),
    "hit_kernel": ("tests/test_torch_routes.py::test_route_renders_and_matches_reference",),
    # "xla" equals the default bit for bit; "fused" as the routes above.
    "multi_backend": ("tests/test_torch_routes.py::test_default_tail_is_the_torch_chain_bit_for_bit",
                      "tests/test_torch_routes.py::test_route_renders_and_matches_reference"),
    # Bounces grouped k to a launch: kernel B-multi's k bounces equal k
    # single bounces bit for bit, and the alive checks keep their steps.
    "multi_k": ("tests/test_torch_multi_bounce.py::test_plain_multi_is_k_plain_bounces",),
    # On and off, the grid sweep's records against the reference's exact
    # grid kernel with the same knobs.
    "tri_early_exit": ("tests/test_torch_tri_hit.py::test_plain_grid_matches_exact_kernel_interpret",),
    "tri_any_skip": ("tests/test_torch_tri_hit.py::test_plain_grid_matches_exact_kernel_interpret",),
    # "on" renders the rebin-off image bit for bit; "dda" (any tri_dda_k)
    # gives the direct pass's records, t within 2e-5.
    "tri_rebin": ("tests/test_torch_tri_rebin.py::test_rebin_render_equals_off",
                  "tests/test_torch_tri_rebin.py::test_dda_tri_pass_matches_direct"),
    "tri_dda_k": ("tests/test_torch_tri_rebin.py::test_dda_tri_pass_matches_direct",),
    # The default render to f32 summation order (rtol 2e-5, atol 2e-6).
    "compactor": ("tests/test_torch_compact.py::test_knob_render_matches_default_and_reference",),
    "flush_mode": ("tests/test_torch_compact.py::test_knob_render_matches_default_and_reference",),
}


class SettingRefused(ValueError):
    """A configuration names a render setting the harness cannot hold to
    its reference."""


def reference(config: dict):
    """The plain reference a configuration is held to:
    ``reference/<config's "reference", default "render">.py``, which has
    ``RefScene``, ``render`` and ``FOLLOWS``, the RenderConfig fields its
    ``render`` reproduces."""
    name = config.get("reference", "render")
    if not isinstance(name, str) or not name.isidentifier():
        raise SettingRefused(f"reference {name!r}: not a module name under "
                             "port_bench/reference/")
    return importlib.import_module(f"port_bench.reference.{name}")


def render_settings(config: dict) -> dict:
    """The configuration's ``render`` map (absent: none), each key checked:
    a field of the port's RenderConfig, none of ``OWN_KEYS``, and in
    ``NEUTRAL`` or in its reference's ``FOLLOWS``.  Raises
    ``SettingRefused`` naming the key and the rule it broke."""
    from win32_raytracer_tpu_torch.config import RenderConfig

    settings = config.get("render", {})
    if not isinstance(settings, dict):
        raise SettingRefused(f"render {settings!r}: not a map of RenderConfig "
                             "fields to values")
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    ref = reference(config)
    for key in settings:
        if key not in fields:
            raise SettingRefused(f"render setting {key!r}: not a field of the "
                                 "port's RenderConfig")
        if key in OWN_KEYS:
            raise SettingRefused(f"render setting {key!r}: set by the "
                                 "configuration's own keys (width, height, "
                                 "spp, max_depth) or the traffic (seed)")
        if key not in NEUTRAL and key not in ref.FOLLOWS:
            raise SettingRefused(
                f"render setting {key!r}: neither in the harness's NEUTRAL "
                f"list nor in FOLLOWS of reference {ref.__name__}, so the "
                "reference would judge the port against another distribution")
    return dict(settings)


def followed(config: dict) -> dict:
    """The configuration's render settings that its reference follows: the
    keyword arguments of every call of its ``render``."""
    follows = reference(config).FOLLOWS
    return {k: v for k, v in render_settings(config).items() if k in follows}


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
