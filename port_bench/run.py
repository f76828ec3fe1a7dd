#!/usr/bin/env python3
"""The benchmark of win32_raytracer_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port.  A run:

1. set-up (``setup_s``, from the process's start): imports torch and the
   port, loads (on a checkout's first run, builds) the port's kernel
   library, makes the cell's scene and hands it to the port, starts the
   ranks of a several-card cell, and makes one warm-up call of the cell's
   own shape with a seed the window does not use;
2. the window: calls back to back, each with its own render seed and
   cameras (``traffic.py``), until ``--seconds`` have passed; every call
   that started finishes.  With ``--trace 1`` a few whole calls inside it
   run under ``torch.profiler`` (``tracing.py``);
3. the check: a sample of the window's calls, drawn from the seed, is
   compared with the configuration's plain reference (``reference/``,
   ``compare.py``);
4. one JSON line, the last of standard output: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer ones), ``device``, ``breakdown``
   (traced runs) and ``checks``, each number compared with its limit.

A run needs as many CUDA cards as the cell's ``chips``; it exits with 2
and prints no result without them.  A configuration whose ``render`` map
names a setting the harness cannot hold to its reference
(``cells.render_settings``) ends the run first, with 5 and no result.  A
four-card cell runs one process a card: this process is rank 0 and starts
ranks 1-3, which join through a file store under ``TMPDIR``; NCCL between
them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Whole top-level module names that may not be loaded: the JAX package
# and JAX itself.  The port's name starts with the JAX package's, so names
# are compared whole, never by prefix.
FORBIDDEN = ("jax", "jaxlib", "flax", "win32_raytracer_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Program:
    """The system under test on one rank: the port's scene and the calls
    the window makes."""

    def __init__(self, cell, config, traffic, device, mesh):
        import types

        from win32_raytracer_tpu_torch import animation, api
        from win32_raytracer_tpu_torch.config import RenderConfig, resolve_scheduler
        from win32_raytracer_tpu_torch.scene.camera import camera_from_numpy
        from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

        from port_bench import cells
        from port_bench.scenes.camera import as_object

        self.api, self.animation = api, animation
        self.RenderConfig, self.as_object = RenderConfig, as_object
        self.camera_from_numpy = camera_from_numpy
        self.cell, self.config, self.traffic = cell, config, traffic
        self.device, self.mesh = device, mesh
        self.arrays = cells.scene(config["scene"])
        sp = types.SimpleNamespace(**self.arrays["spheres"])
        if self.arrays["triangles"] is None:
            src = sp
        else:
            src = types.SimpleNamespace(
                spheres=sp, triangles=types.SimpleNamespace(**self.arrays["triangles"]))
        self.scene = scene_from_numpy(src, device=device)
        self.settings = cells.render_settings(config)
        want = cell["params"]["scheduler"]
        got = resolve_scheduler(self.render_config(0))
        if got != want:
            raise RuntimeError(f"{cell['name']} expects the {want} scheduler; "
                               f"the port resolves {got}")

    def render_config(self, i):
        t = self.traffic
        return self.RenderConfig(width=t.width, height=t.height,
                                 samples=t.spp, max_depth=t.max_depth,
                                 seed=t.seed(i), **self.settings)

    def call(self, i) -> list:
        """Call ``i`` of the window (``i = -1`` is the warm-up): its u8
        images, on the host."""
        t = self.traffic
        cams = [self.camera_from_numpy(self.as_object(c), device=self.device)
                for c in t.cameras(i)]
        cfg = self.render_config(i)
        mode = self.config.get("shard_mode", "rows")
        if t.entry == "render":
            res = self.api.render(self.scene, cams[0], cfg, device=self.device,
                                  mesh=self.mesh, shard_mode=mode)
            return [res.image]
        if t.entry == "animation":
            return list(self.animation.render_animation(
                self.scene, cams, cfg, mesh=self.mesh, shard_mode=mode,
                device=self.device))
        raise ValueError(f"unknown entry {t.entry!r}")

    def host_reads(self) -> int:
        from win32_raytracer_tpu_torch import persistent
        return persistent.HOST_READS


def run_rank(rank, world, args, device_type, store_path, t0, plant=None):
    """Set-up, window and what the run keeps, on one rank.  Returns rank
    0's record (None on other ranks).  ``plant`` ("module:function", tests
    only) is called first, to break the program underneath."""
    import torch

    if plant:
        import importlib
        mod, fn = plant.split(":")
        getattr(importlib.import_module(mod), fn)()

    from port_bench import cells, tracing
    from port_bench.traffic import Traffic

    cell = cells.workload(args.workload)
    config = cells.config(cell["config"])
    traffic = Traffic(cell["params"], config, args.seed)
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        from win32_raytracer_tpu_torch.kernels import _build
        _build.load()
    mesh = None
    if world > 1:
        import torch.distributed as dist
        from win32_raytracer_tpu_torch.parallel.shard import init_ranks, make_mesh
        init_ranks(rank, world, store=dist.FileStore(store_path, world),
                   device_type=device.type)
        mesh = make_mesh(world, device.type)

    prog = Program(cell, config, traffic, device, mesh)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prog.call(-1)
    if on_card:
        torch.cuda.synchronize(device)
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
    setup_s = time.perf_counter() - t0

    # The window.
    tr = cell.get("trace", {"skip": 1, "calls": 1})
    skip, n_tr = int(tr["skip"]), int(tr["calls"])
    slice_ = tracing.Slice(on_card) if args.trace else None
    reads0 = prog.host_reads()
    walls, kept = [], []
    i = 0
    w0 = time.perf_counter()
    while True:
        if slice_ is not None and i == skip:
            slice_.start()
        a = time.perf_counter()
        out = prog.call(i)
        b = time.perf_counter()
        walls.append((a - w0, b - w0))
        if rank == 0:
            kept.append(out)
        i += 1
        if slice_ is not None and i == skip + n_tr:
            slice_.stop()
        stop = b - w0 >= args.seconds and (slice_ is None or i >= skip + n_tr)
        if world > 1:
            stop = _agree(stop, device)
        if stop:
            break
    reads = prog.host_reads() - reads0
    if on_card:
        torch.cuda.synchronize(device)
    mine = {
        "peak_alloc": torch.cuda.max_memory_allocated(device) if on_card else 0,
        "peak_reserved": torch.cuda.max_memory_reserved(device) if on_card else 0,
        "trace": slice_.summary(n_tr) if slice_ is not None else None,
        "forbidden": forbidden_modules(),
    }
    ranks = [mine]
    if world > 1:
        import torch.distributed as dist
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        dist.destroy_process_group()
    scene_arrays = prog.arrays
    del prog, mesh
    if on_card:
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    return {
        "cell": cell, "config": config, "traffic": traffic, "device": device,
        "setup_s": setup_s, "walls": walls, "images": kept,
        "host_reads": reads, "ranks": ranks, "arrays": scene_arrays,
    }


def _agree(stop: bool, device) -> bool:
    """Rank 0's decision, on every rank (the ranks stay in lockstep)."""
    import torch
    import torch.distributed as dist
    flag = torch.tensor([1 if stop else 0], device=device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def check(rec, seed, device):
    """Numbers of the sampled calls against the plain reference: (numbers,
    limits, calls compared, calls failed)."""
    import numpy as np

    from port_bench import cells, compare

    cell, traffic = rec["cell"], rec["traffic"]
    ref, kw = cells.reference(rec["config"]), cells.followed(rec["config"])
    spec = cell["compare"]
    n = len(rec["images"])
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 0xC0FFEE])
    pick = sorted(rng.choice(n, size=min(n, int(spec["calls"])), replace=False))
    scene = ref.RefScene(rec["arrays"], device)
    readings, failed = [], 0
    for i in pick:
        cams = traffic.cameras(int(i))
        size = (traffic.width, traffic.height, traffic.spp, traffic.max_depth)
        r1 = ref.render(scene, cams, *size, seed=traffic.seed(int(i)) * 2 + 1,
                        **kw)
        r2 = ref.render(scene, cams, *size, seed=traffic.seed(int(i)) * 2 + 2,
                        **kw)
        got = rec["images"][int(i)]
        if len(got) == len(cams):
            per = compare.worst(compare.image_numbers(p, a, b)
                                for p, a, b in zip(got, r1, r2))
        else:
            per = {k: float("inf") for k in compare.NUMBERS}
        failed += not compare.judge(per, spec["limits"])
        readings.append(per)
    return compare.worst(readings), spec["limits"], len(pick), failed


def result(rec, args, numbers, limits, failed) -> dict:
    """The run's JSON line."""
    import subprocess

    import torch

    from port_bench import cells, compare, tracing

    bench = cells.benchmark()
    cell = rec["cell"]
    ranks = rec["ranks"]
    summary = {
        "walls": rec["walls"],
        "rays_per_call": rec["traffic"].rays_per_call,
        "setup_s": rec["setup_s"],
        "peak_alloc_bytes": max(r["peak_alloc"] for r in ranks),
        "host_reads": rec["host_reads"],
        "cell": cell,
        "arrays": rec["arrays"],
        "trace": None,
    }
    out = {"correct": compare.judge(numbers, limits),
           "attempted": len(rec["walls"]), "failed": failed}
    if args.trace:
        summary["trace"] = tracing.merge_ranks([r["trace"] for r in ranks])
    metrics = {}
    for name, unit in cells.metrics_of(cell["name"], bool(args.trace), bench):
        value = cells.metric(name)(summary)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    out["metrics"] = metrics
    dev = rec["device"]
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": len(ranks),
              "memory_peak_bytes": max(r["peak_reserved"] for r in ranks)}
    if dev.type == "cuda":
        try:
            device["power_limit_w"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                 "-i", str(dev.index or 0)],
                capture_output=True, text=True, timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            device["power_limit_w"] = "not read"
    if args.trace:
        t = summary["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["wall_s"]
        out["breakdown"] = tracing.breakdown(t)
    out["device"] = device
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in compare.NUMBERS}
    return out


def call_walls(rec) -> dict:
    """The calls' walls (s) in order, and in a traced run the mean wall of
    a traced and of an untraced call: what the profiler costs."""
    from port_bench import metric_lib

    walls = [b - a for a, b in rec["walls"]]
    out = {"call_s": [round(w, 5) for w in walls]}
    if rec["ranks"][0]["trace"] is not None:
        tr = rec["cell"].get("trace", {"skip": 1, "calls": 1})
        skip, n = int(tr["skip"]), int(tr["calls"])
        out["traced_call_s"] = sum(walls[skip:skip + n]) / n
        out["untraced_call_s"] = metric_lib.untraced_call_s(
            {"walls": rec["walls"], "cell": rec["cell"]})
    return out


def _rank_entry(rank, world, argv, store_path, device_type, plant):
    args = parse(argv)
    run_rank(rank, world, args, device_type, store_path, time.perf_counter(),
             plant)


def main(argv=None, device_type="cuda", plant=None) -> int:
    """One run.  Tests only: ``device_type="cpu"`` runs the ranks on the
    CPU without looking for a card, and ``plant`` breaks the program
    (``run_rank``)."""
    args = parse(argv if argv is not None else sys.argv[1:])
    argv = [f"--workload={args.workload}", f"--seed={args.seed}",
            f"--seconds={args.seconds}", f"--trace={args.trace}"]
    from port_bench import cells
    cell = cells.workload(args.workload)
    world = int(cell["chips"])
    try:
        cells.render_settings(cells.config(cell["config"]))
    except cells.SettingRefused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 5
    import torch
    if device_type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card: torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < world:
            print(f"{args.workload} needs {world} cards; "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    build_s = 0.0
    if device_type == "cuda":
        # Built once here, before any rank starts (a checkout's first run).
        from win32_raytracer_tpu_torch.kernels import _build
        _build.build()
        build_s = _build.build_seconds
        print(f"kernel library: built in {build_s:.3f} s" if build_s
              else "kernel library: found built", file=sys.stderr, flush=True)
    procs, tmp = [], None
    try:
        store = None
        if world > 1:
            tmp = tempfile.mkdtemp(prefix="port_bench_")
            store = os.path.join(tmp, "store")
            ctx = _mp_context()
            for r in range(1, world):
                p = ctx.Process(target=_rank_entry,
                                args=(r, world, argv, store, device_type, plant))
                p.start()
                procs.append(p)
            _watch(procs)
        rec = run_rank(0, world, args, device_type, store, T0, plant)
        for p in procs:
            p.join(timeout=120)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            print(f"a rank ended with exit codes {bad}", file=sys.stderr)
            return 3
        found = sorted({m for r in rec["ranks"] for m in r["forbidden"]})
        if found:
            print(f"forbidden modules loaded: {found}", file=sys.stderr)
            return 4
        t_check = time.perf_counter()
        numbers, limits, compared, failed = check(rec, args.seed, rec["device"])
        print(f"reference check: {compared} call(s) in "
              f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr, flush=True)
        out = result(rec, args, numbers, limits, failed)
        found = forbidden_modules()
        if found:
            print(f"forbidden modules loaded: {found}", file=sys.stderr)
            return 4
        print(json.dumps({"setup_s": rec["setup_s"], "build_s": build_s,
                          "calls": len(rec["walls"]), "compared": compared}
                         | call_walls(rec)),
              flush=True)
        for k, v in out["checks"].items():
            print(f"check {k} {v['value']!r} limit {v['limit']!r}",
                  file=sys.stderr, flush=True)
        print(json.dumps(out), flush=True)
        return 0
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
        if tmp is not None:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)


def _mp_context():
    import multiprocessing
    return multiprocessing.get_context("spawn")


def _watch(procs):
    """End this process when a rank dies, so a collective never waits for
    it forever."""
    import threading

    def watch():
        while True:
            time.sleep(1.0)
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead:
                print(f"rank process ended with {dead[0].exitcode}",
                      file=sys.stderr, flush=True)
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                os._exit(3)
            if all(p.exitcode == 0 for p in procs):
                return

    threading.Thread(target=watch, daemon=True).start()


if __name__ == "__main__":
    sys.exit(main())
