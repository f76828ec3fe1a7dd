"""What the per-layer metrics of the port's own spans and counters read:
the recorder's log (``win32_raytracer_tpu_torch.utils.profiling.log()``)
in this process, rank 0's in a run of several cards.  In a ``--trace 1``
run the log holds exactly the traced calls: the recorder is on while
``torch.profiler`` records, and the warm-up and the calls before the
traced ones run without it.

Every function returns None where there is nothing to read: a program
without the recorder, or a log with no spans.
"""

from __future__ import annotations

from port_bench import metric_lib, roofline

# f32 operations of kernel D's tests (csrc/common.cuh tri_pair_geom and
# the any-touch test of csrc/tri_grid.cu; PERF.md's kernel table, row 10).
OPS_TRI_PAIR = 52
OPS_TRI_TOUCH = 27

# Spans of the torch tail below the floor, wherever they run; and spans
# that count as tail once their chunk has reached the tail.
TAIL = ("persistent.bounce_tail", "persistent.one_shot", "persistent.staged")
TAIL_AFTER = ("persistent.count_read", "persistent.compact")
LOCKSTEP = "shard.lockstep_ms"


def port_log():
    """The port's log, or None (no recorder, or nothing recorded)."""
    from win32_raytracer_tpu_torch.utils import profiling
    read = getattr(profiling, "log", None)
    if read is None:
        return None
    log = read()
    return log if log["spans"] else None


def calls(log) -> int:
    """Calls recorded: root spans (one a call of the port's entry point)."""
    return sum(1 for s in log["spans"] if s["parent"] is None)


def counter(log, name: str) -> int:
    return sum(c.get(name, 0) for c in log["counters"].values())


def _ns(s) -> int:
    return s["end_ns"] - s["start_ns"]


def tail_share(log):
    """Host time in the torch tail's spans over ``persistent.render``'s.

    A chunk's batch only shrinks, so once a chunk has run a tail span it
    stays below the floor: its count reads and compactions from then on
    are tail too.  A span inside a counted span is not counted again."""
    spans = log["spans"]
    render_ns = sum(_ns(s) for s in spans if s["name"] == "persistent.render")
    if render_ns <= 0:
        return None
    kids = {}
    for i, s in enumerate(spans):
        kids.setdefault(s["parent"], []).append(i)
    tail_ns = 0
    for c, chunk in enumerate(spans):
        if chunk["name"] != "persistent.chunk":
            continue
        inside, todo = [], list(kids.get(c, []))
        while todo:
            i = todo.pop()
            inside.append(i)
            todo.extend(kids.get(i, []))
        starts = [spans[i]["start_ns"] for i in inside
                  if spans[i]["name"] in TAIL]
        if not starts:
            continue
        first = min(starts)
        counted = {i for i in inside if spans[i]["name"] in TAIL
                   or (spans[i]["name"] in TAIL_AFTER
                       and spans[i]["start_ns"] >= first)}
        for i in counted:
            p = spans[i]["parent"]
            while p != c and p not in counted:
                p = spans[p]["parent"]
            if p == c:
                tail_ns += _ns(spans[i])
    return tail_ns / render_ns


def lane_occupancy(log):
    """The alive lanes over the batch width, summed over the count reads."""
    width = counter(log, "persistent.width_at_reads")
    if width <= 0:
        return None
    return counter(log, "persistent.alive_at_reads") / width


def tri_grid_roofline_pct(log, trace):
    """100 x the operation bound of kernel D's counted tests over the
    device time of kernel D and its schedule kernel in the traced calls."""
    ops = (counter(log, "tri_grid.pair_tests") * OPS_TRI_PAIR
           + counter(log, "tri_grid.touch_tests") * OPS_TRI_TOUCH)
    ms = metric_lib.device_ms(trace, metric_lib.TRI_GRID) if trace else 0.0
    if ops <= 0 or ms <= 0:
        return None
    return 100.0 * ops / roofline.PEAK_F32 / (ms / 1e3)


def lockstep_ms(log):
    """(transfer, wait) ms per call: over the lockstep collectives, the
    least rank's elapsed time summed (transfer), and each rank's excess
    over it summed and averaged over ranks (wait); or None."""
    tables = [t["rows"] for t in log["tables"] if t["name"] == LOCKSTEP]
    if not tables or not any(t and t[0] for t in tables):
        return None
    transfer = wait = 0.0
    for rows in tables:
        least = [min(col) for col in zip(*rows)]
        transfer += sum(least)
        wait += sum(sum(r) - sum(least) for r in rows) / len(rows)
    n = calls(log)
    return transfer / n, wait / n
