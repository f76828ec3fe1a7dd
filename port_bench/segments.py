#!/usr/bin/env python3
"""Mean segments per primary ray of a cell, by its plain reference: rays
traced (primary ones included) over primary rays, at the cell's size and
cameras, one render per seed.  The sphere-sweep rooflines count their work
from it (``roofline.py``); it is a property of the scene, the materials,
``max_depth`` and the cameras, not of the scheduler.

    python3 port_bench/segments.py final.finished --seeds 1 2 3 [--out FILE]

Prints one JSON object: the mean, the spread (max - min over seeds, as a
share of the mean) and each seed's value; that object is what the cell
file keeps under ``segments_per_primary``.  Needs a CUDA card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(cell_name: str, seeds, device: str) -> dict:
    from port_bench import cells
    from port_bench.traffic import Traffic

    cell = cells.workload(cell_name)
    config = cells.config(cell["config"])
    ref, kw = cells.reference(config), cells.followed(config)
    scene = ref.RefScene(cells.scene(config["scene"]), device)
    values = []
    for s in seeds:
        t = Traffic(cell["params"], config, s)
        stats = {}
        ref.render(scene, t.cameras(0), t.width, t.height, t.spp, t.max_depth,
                   seed=t.seed(0), stats=stats, **kw)
        values.append(stats["segments"] / stats["primary"])
    mean = sum(values) / len(values)
    return {"mean": mean, "spread": (max(values) - min(values)) / mean,
            "seeds": list(seeds), "values": values,
            "how": f"python3 port_bench/segments.py {cell_name} --seeds "
                   + " ".join(str(s) for s in seeds)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card (pass --device cpu)", file=sys.stderr)
        return 2
    out = measure(args.cell, args.seeds, args.device)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
