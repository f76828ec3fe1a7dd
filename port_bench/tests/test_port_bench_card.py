"""On a CUDA card: one short run of each one-card cell through the whole
harness (the kernels build on first use).  Skips without a card.

    python -m pytest port_bench/tests -m card
"""

from __future__ import annotations

import pytest

from port_bench import cells


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in cells.benchmark()["workloads"]
                                  if w["chips"] == 1])
def test_short_run_is_correct(card, cell, capsys):
    import json

    from port_bench import run
    rc = run.main(["--workload", cell, "--seed", "2200000099",
                   "--seconds", "2", "--trace", "0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
