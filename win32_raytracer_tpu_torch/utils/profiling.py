"""Tracing and profiling helpers (``win32_raytracer_tpu.utils.profiling``).

The reference's observability is wall clock only (high_resolution_clock
around the render, win32-raytracer/RayTracer.cpp:967/1006-1007, plus PIX
GPU markers, Game.cpp:207/265).  Here:

* :class:`PhaseTimer`: named wall-clock phases whose ends wait for the
  card (``torch.cuda.synchronize``), so each phase owns its device work;
  on the CPU nothing is waited for;
* :func:`trace`: a ``torch.profiler`` trace of the CPU and the card,
  written as a Chrome trace (``chrome://tracing``, Perfetto or
  TensorBoard's profiler view);
* :func:`mrays`: throughput from a ray count and seconds.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Wall clock per named phase; with ``sync`` each phase ends by
    waiting for ``device`` (None: the current card, when there is one)."""

    def __init__(self, sync: bool = True, device=None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._sync = sync
        self._device = device

    def _wait(self) -> None:
        dev = self._device
        if dev is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            return
        dev = torch.device(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                self._wait()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        lines = [
            f"{name:>16s}: {t:8.3f}s ({100 * t / total:5.1f}%)"
            f" x{self.counts[name]}"
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str, name: Optional[str] = None):
    """``torch.profiler`` over the block (the CPU, and the card when there
    is one); writes ``log_dir/<name or trace>.json``, a Chrome trace.
    Yields the profiler (``key_averages()`` for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name or 'trace'}.json"))


def mrays(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6
