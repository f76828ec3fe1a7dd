"""A configuration's render settings: which the harness takes, which it
refuses before a run starts, and that a configuration without any hands
the port the RenderConfig it always had."""

from __future__ import annotations

import dataclasses
import os
import re

import pytest

from port_bench import cells

from .conftest import ROOT, run_cpu, tiny_variant

BENCHMARK = cells.benchmark()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]

# Fields that are never neutral: the reference's quirks and numerics, what
# is sampled and how much a pixel, and fields the port accepts and ignores.
NEVER_NEUTRAL = (
    "refract_discriminant_bias", "schlick_uses_ni_over_nt", "reflect_thres",
    "epsilon", "min_hit_t", "deterministic", "russian_roulette",
    "rr_start_depth", "stratify", "adaptive_alloc", "adaptive_pool",
    "kpp_max", "hit_terms", "pallas_interpret")


def _fields():
    from win32_raytracer_tpu_torch.config import RenderConfig
    return {f.name for f in dataclasses.fields(RenderConfig)}


def test_neutral_names_fields_that_change_no_distribution():
    assert set(cells.NEUTRAL) <= _fields() - set(cells.OWN_KEYS)
    assert not set(cells.NEUTRAL) & set(NEVER_NEUTRAL)
    assert set(NEVER_NEUTRAL) <= _fields()


def test_each_neutral_entry_names_a_port_test_that_exists():
    for key, tests in cells.NEUTRAL.items():
        assert tests, key
        for t in tests:
            path, name = t.split("::")
            src = open(os.path.join(ROOT, path)).read()
            assert re.search(rf"^def {name}\(", src, re.M), (key, t)


def test_render_settings_take_neutral_and_followed_keys():
    tiny = {"scene": "final"}
    assert cells.render_settings(tiny) == {}
    assert cells.followed(tiny) == {}
    grid = tiny | {"render": {"accel": "grid", "compactor": "route"}}
    assert cells.render_settings(grid) == {"accel": "grid",
                                           "compactor": "route"}
    assert cells.followed(grid) == {}
    assert cells.reference(tiny).FOLLOWS == ()


@pytest.mark.parametrize("key", NEVER_NEUTRAL)
def test_render_settings_refuse_what_the_reference_does_not_follow(key):
    from win32_raytracer_tpu_torch.config import RenderConfig
    value = getattr(RenderConfig(), key)
    with pytest.raises(cells.SettingRefused, match=repr(key)):
        cells.render_settings({"render": {key: value}})


def test_render_settings_refuse_a_bad_reference_name():
    with pytest.raises(cells.SettingRefused, match="reference"):
        cells.reference({"reference": "../render"})


def _refused(bench_copy, name, render):
    """A run of a tiny config with ``render``: exits with neither 0 nor 2
    (no card), prints no result, and names the key on standard error."""
    cell = tiny_variant(bench_copy, name, render=render)
    rc, out, err = run_cpu(bench_copy, cell, timeout=300)
    (key,) = render
    assert rc not in (0, 2), (rc, err[-2000:])
    assert out is None
    assert repr(key) in err.strip().splitlines()[-1], err[-2000:]
    return err


def test_run_refuses_roulette_under_the_default_reference(bench_copy):
    err = _refused(bench_copy, "tiny_rr", {"russian_roulette": True})
    assert "FOLLOWS" in err


def test_run_refuses_a_misspelled_setting(bench_copy):
    err = _refused(bench_copy, "tiny_acel", {"acel": "grid"})
    assert "not a field" in err


def test_run_refuses_a_setting_with_its_own_key(bench_copy):
    err = _refused(bench_copy, "tiny_samples", {"samples": 4})
    assert "own keys" in err


@pytest.mark.parametrize("name", CELLS)
def test_accepted_cells_hand_the_port_the_parents_config(name):
    """Each accepted cell's RenderConfig, call by call, is the one built
    from width, height, spp, max_depth and the call's seed alone, field for
    field."""
    import torch

    from win32_raytracer_tpu_torch.config import RenderConfig

    from port_bench.run import Program
    from port_bench.traffic import Traffic

    cell = cells.workload(name)
    config = cells.config(cell["config"])
    assert "render" not in config and "reference" not in config
    t = Traffic(cell["params"], config, 2200000017)
    prog = Program(cell, config, t, torch.device("cpu"), None)
    for i in (-1, 0, 1, 7):
        want = RenderConfig(width=t.width, height=t.height, samples=t.spp,
                            max_depth=t.max_depth, seed=t.seed(i))
        assert prog.render_config(i) == want
