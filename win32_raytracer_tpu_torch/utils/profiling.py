"""Tracing and profiling helpers (``win32_raytracer_tpu.utils.profiling``).

The reference's observability is wall clock only (high_resolution_clock
around the render, win32-raytracer/RayTracer.cpp:967/1006-1007, plus PIX
GPU markers, Game.cpp:207/265).  Here:

* the recorder: spans (:func:`span`) and counters (:func:`count`) inside
  the port's schedulers, on while a ``torch.profiler`` records or inside
  :func:`recording`, read back by :func:`log`;
* :func:`trace`: a ``torch.profiler`` trace of the CPU and the card,
  written as a Chrome trace (``chrome://tracing``, Perfetto or
  TensorBoard's profiler view), with the recorder's spans in it;
* :func:`mrays`: throughput from a ray count and seconds.

The recorder decides once per render, at the outermost render entry
(:func:`render_entry`), whether it is on.  Off, :func:`span` returns one
shared no-op context and :func:`count` returns at once: no timestamps, no
device work, no syncs.  On, each span is also a host range of the
profiler (``torch._C._profiler._RecordFunctionFast``, a function range:
``torch.profiler.record_function``'s user annotation would also be
projected onto the card's timeline as a device event), so it stands in
the profiler's host timeline on the clock of the device operations; and
the in-memory log keeps, per span, its name, parent, render index, rank
and start and end (``time.perf_counter_ns``), and per render its counters
and tables.
The log holds the latest recorded stretch: a recorded render that follows
an unrecorded one starts a new log.  Spans record the thread that runs
the render; one render records at a time.  Nothing is written to a file.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Optional

import torch


class _Noop:
    """The span of a render that does not record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Recorder:
    """The process's recorder: what renders record, and whether the
    render under way records."""

    def __init__(self):
        self.on = False         # the open render records
        self.forced = 0         # depth of recording()
        self.depth = 0          # render entries open
        self.last_on = False    # whether the last outermost render recorded
        self.render = -1        # index of the newest recorded render
        self.rank = 0
        self.pending = []       # (device tensor, {slot: counter name})
        self.clear()

    def clear(self):
        self.spans = []         # [name, parent, render, rank, start, end]
        self.stack = []         # indices of the open spans
        self.counters: Dict[int, Dict[str, int]] = {}
        self.tables = []


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "index", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.index = len(rec.spans)
        rec.spans.append([self.name, rec.stack[-1] if rec.stack else None,
                          rec.render, rec.rank, time.perf_counter_ns(), None])
        rec.stack.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = _REC
        rec.spans[self.index][5] = time.perf_counter_ns()
        rec.stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context that records ``name`` (letters, digits, ``.`` and ``_``)
    while the render under way records; otherwise a shared no-op."""
    return _Span(name) if _REC.on else _NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the render's counter ``name`` while it records."""
    rec = _REC
    if rec.on:
        c = rec.counters.setdefault(rec.render, {})
        c[name] = c.get(name, 0) + int(n)


def on() -> bool:
    """Whether the render under way records."""
    return _REC.on


def device_counters(slots: Dict[int, str], size: int, device):
    """While the render records: a zeroed int64 [size] tensor on
    ``device`` for a kernel to add into, read with one copy at the end of
    the outermost render into the counters ``slots`` names ({index:
    name}); None otherwise."""
    rec = _REC
    if not rec.on:
        return None
    t = torch.zeros(size, dtype=torch.int64, device=device)
    rec.pending.append((t, dict(slots)))
    return t


def table(name: str, rows) -> None:
    """Keep ``rows`` (a list of lists of numbers) under ``name`` for the
    render under way, while it records."""
    rec = _REC
    if rec.on:
        rec.tables.append({"name": name, "render": rec.render,
                           "rank": rec.rank, "rows": rows})


def _profiler_on() -> bool:
    return bool(torch._C._autograd._profiler_enabled())


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _begin(name: str):
    """Open a render entry; the outermost decides whether it records."""
    rec = _REC
    if rec.depth == 0:
        rec.on = rec.forced > 0 or _profiler_on()
        if rec.on:
            if not rec.last_on:
                rec.clear()
            rec.render += 1
            rec.rank = _rank()
        rec.last_on = rec.on
    rec.depth += 1
    return span(name)


def _read_pending():
    """The device counters of the outermost render, one copy each."""
    rec = _REC
    pending, rec.pending = rec.pending, []
    for t, slots in pending:
        vals = t.tolist()
        for i, name in slots.items():
            count(name, vals[i])


def _end():
    rec = _REC
    rec.depth -= 1
    if rec.depth == 0:
        rec.pending = []
        rec.on = False


def render_entry(name: str):
    """Decorator of a render entry point: the call is span ``name``; at
    the outermost entry the recorder decides, once, whether this render
    records (a ``torch.profiler`` recording, or :func:`recording`)."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            s = _begin(name)
            try:
                with s:
                    out = fn(*args, **kwargs)
                    if _REC.depth == 1 and _REC.on:
                        _read_pending()
                    return out
            finally:
                _end()
        return entry
    return wrap


@contextlib.contextmanager
def recording():
    """Renders inside the block record, with or without a profiler; the
    block starts a new stretch of the log."""
    if _REC.forced == 0:
        _REC.last_on = False
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def log() -> dict:
    """What the latest recorded stretch holds: ``spans`` (dicts of name,
    parent index or None, render, rank, start_ns, end_ns), ``counters``
    ({render: {name: n}}) and ``tables`` (dicts of name, render, rank,
    rows)."""
    rec = _REC
    keys = ("name", "parent", "render", "rank", "start_ns", "end_ns")
    return {"spans": [dict(zip(keys, s)) for s in rec.spans],
            "counters": {r: dict(c) for r, c in rec.counters.items()},
            "tables": [dict(t) for t in rec.tables]}


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
