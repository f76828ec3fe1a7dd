"""Structured progress reporting (``win32_raytracer_tpu.utils.progress``).

Replaces the reference's imgui status text ("Reticulating splines..." /
"Done!" / "Render duration: N ms", Game.cpp:216-250) with log-line
callbacks: rows done, elapsed, and primary-ray throughput so far.  The
wavefront scheduler emits one "chunk" event per row chunk and one "done"
event at the end.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

ProgressFn = Callable[[dict], None]


def stderr_progress(event: dict) -> None:
    if event["kind"] == "chunk":
        print(f"[wrt] rows {event['rows_done']}/{event['rows_total']} "
              f"({100.0 * event['rows_done'] / event['rows_total']:.0f}%) "
              f"elapsed {event['elapsed_s']:.1f}s "
              f"~{event['mrays_per_sec']:.2f} Mrays/s",
              file=sys.stderr, flush=True)
    elif event["kind"] == "done":
        print(f"[wrt] done in {event['elapsed_s']:.1f}s "
              f"({event['mrays_per_sec']:.2f} Mrays/s primary)",
              file=sys.stderr, flush=True)


class ProgressTracker:
    """Accumulates render progress and emits events to a callback."""

    def __init__(self, rows_total: int, rays_per_row: int,
                 fn: Optional[ProgressFn]):
        self.rows_total = rows_total
        self.rays_per_row = rays_per_row
        self.fn = fn
        self.rows_done = 0
        self.t0 = time.perf_counter()

    def chunk_done(self, rows: int) -> None:
        self.rows_done = min(self.rows_total, self.rows_done + rows)
        if self.fn is None:
            return
        elapsed = max(time.perf_counter() - self.t0, 1e-9)
        self.fn({
            "kind": "chunk",
            "rows_done": self.rows_done,
            "rows_total": self.rows_total,
            "elapsed_s": elapsed,
            "mrays_per_sec": self.rows_done * self.rays_per_row / elapsed / 1e6,
        })

    def done(self) -> None:
        if self.fn is None:
            return
        elapsed = max(time.perf_counter() - self.t0, 1e-9)
        self.fn({
            "kind": "done",
            "elapsed_s": elapsed,
            "mrays_per_sec": self.rows_total * self.rays_per_row / elapsed / 1e6,
        })
