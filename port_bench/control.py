#!/usr/bin/env python3
"""The readings the limits of ``compare.py`` are set from, at a cell's own
size, in one process (its ranks for a several-card cell):

* ``program``: the port's calls on each of ``--seeds`` (each seed's
  first ``compare.calls`` calls, as a run compares them), against the
  plain reference; the largest of these is a number's lower reading;
* ``control``: the configuration's plain reference computed in bfloat16
  (the precision below the float32 the configuration states) put in the
  port's place, on each of ``--control-seeds``; the smallest is the upper
  reading;
* ``half_spp``: the port rendering half the samples a call asks for
  (half of the batch left out, the mean taken over the rest), on each of
  ``--control-seeds``;
* ``witness``: the float32 reference itself, with a third seed, in the
  port's place, on each of ``--witness-seeds``: how a sound image reads.

    python3 port_bench/control.py final.finished --seeds 1 2 3 4 5 6 7 8 9 10 11 12 \\
        --control-seeds 21 22 23 --out chiprun_out/control_final.finished.jsonl

One JSON line a reading.  Needs the cell's cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def session(rank, world, cell_name, device_type, store, jobs):
    """Set up the port once, then the calls of each (seed, calls, spp
    scale) job.  Rank 0 returns each job's images."""
    import torch

    from port_bench import cells
    from port_bench.run import Program
    from port_bench.traffic import Traffic

    cell = cells.workload(cell_name)
    config = cells.config(cell["config"])
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = None
    if world > 1:
        import torch.distributed as dist
        from win32_raytracer_tpu_torch.parallel.shard import init_ranks, make_mesh
        init_ranks(rank, world, store=dist.FileStore(store, world),
                   device_type=device.type)
        mesh = make_mesh(world, device.type)
    prog = Program(cell, config, Traffic(cell["params"], config, 0), device, mesh)
    prog.call(-1)
    out = []
    for seed, calls, scale in jobs:
        prog.traffic = Traffic(cell["params"], config, seed)
        prog.traffic.spp = max(1, int(prog.traffic.spp * scale))
        out.append([prog.call(i) for i in range(calls)])
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return out if rank == 0 else None


def _rank_entry(rank, world, cell_name, store, jobs):
    session(rank, world, cell_name, "cuda", store, jobs)


def readings(cell_name, seeds, control_seeds, witness_seeds=(),
             device_type="cuda"):
    """Yield one dict a reading (see the module's docstring)."""
    import torch

    from port_bench import cells, compare
    from port_bench.run import _mp_context, _watch
    from port_bench.traffic import Traffic

    cell = cells.workload(cell_name)
    config = cells.config(cell["config"])
    ref, kw = cells.reference(config), cells.followed(config)
    world = int(cell["chips"])
    calls = int(cell["compare"]["calls"])
    jobs = ([(s, calls, 1.0) for s in seeds]
            + [(s, calls, 0.5) for s in control_seeds])
    procs, tmp, store = [], None, None
    if world > 1:
        tmp = tempfile.mkdtemp(prefix="port_bench_")
        store = os.path.join(tmp, "store")
        ctx = _mp_context()
        for r in range(1, world):
            p = ctx.Process(target=_rank_entry,
                            args=(r, world, cell_name, store, jobs))
            p.start()
            procs.append(p)
        _watch(procs)
    t0 = time.perf_counter()
    images = session(0, world, cell_name, device_type, store, jobs)
    for p in procs:
        p.join(timeout=120)
    print(f"port: {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    if device_type == "cuda":
        torch.cuda.empty_cache()
    device = torch.device(device_type)
    arrays = cells.scene(config["scene"])
    f32 = ref.RefScene(arrays, device)
    bf16 = ref.RefScene(arrays, device, torch.bfloat16)

    def refs(t, i):
        size = (t.width, t.height, t.spp, t.max_depth)
        cams = t.cameras(i)
        return (cams, size,
                ref.render(f32, cams, *size, seed=t.seed(i) * 2 + 1, **kw),
                ref.render(f32, cams, *size, seed=t.seed(i) * 2 + 2, **kw))

    kinds = ["program"] * len(seeds) + ["half_spp"] * len(control_seeds)
    for kind, (seed, n, _), got in zip(kinds, jobs, images):
        t = Traffic(cell["params"], config, seed)
        per = []
        for i in range(n):
            _, _, r1, r2 = refs(t, i)
            per.append(compare.worst(compare.image_numbers(p, a, b)
                                     for p, a, b in zip(got[i], r1, r2)))
        yield {"cell": cell_name, "kind": kind, "seed": seed,
               "numbers": compare.worst(per)}
    for kind, scene, chosen in (("control", bf16, control_seeds),
                                ("witness", f32, witness_seeds)):
        for seed in chosen:
            t = Traffic(cell["params"], config, seed)
            per = []
            for i in range(calls):
                cams, size, r1, r2 = refs(t, i)
                alt = ref.render(scene, cams, *size, seed=t.seed(i) * 2 + 3,
                                 **kw)
                per.append(compare.worst(compare.image_numbers(p, a, b)
                                         for p, a, b in zip(alt, r1, r2)))
            yield {"cell": cell_name, "kind": kind, "seed": seed,
                   "numbers": compare.worst(per)}
    if tmp is not None:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from win32_raytracer_tpu_torch.kernels import _build
    _build.build()
    sink = open(args.out, "w") if args.out else None
    try:
        for r in readings(args.cell, args.seeds, args.control_seeds,
                              args.witness_seeds):
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
