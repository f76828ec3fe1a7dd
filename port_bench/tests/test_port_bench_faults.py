"""Runs on the CPU (no look for a card) with the port broken underneath:
each fault the cells can have makes ``correct`` come out false, and a
sound run comes out true."""

from __future__ import annotations

import pytest

from .conftest import run_cpu

FAULTS = "port_bench.tests.faults:"


def test_sound_run_is_correct(bench_copy):
    rc, out, err = run_cpu(bench_copy, "tiny.finished")
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check noise_excess")


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fault_is_not_correct(bench_copy, fault):
    rc, out, err = run_cpu(bench_copy, "tiny.finished", plant=FAULTS + fault)
    assert rc == 0, err[-3000:]
    assert out["correct"] is False, (fault, out["checks"])
    assert out["failed"] >= 1


def test_exchange_left_out_is_not_correct(bench_copy):
    """Four gloo ranks on the CPU; the image reduce keeps one rank's rows."""
    rc, out, err = run_cpu(bench_copy, "tiny4.flythrough",
                           plant=FAULTS + "exchange_left_out")
    assert rc == 0, err[-3000:]
    assert out["correct"] is False, out["checks"]
