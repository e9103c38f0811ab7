"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --control_seeds 4,5,6 [--seconds 5] [--out chiprun_out/readings.jsonl]

In one process, for every seed of ``--seeds`` a short run of the cell as the
benchmark makes it (set-up, a window of ``--seconds``, the comparison with
the plain reference) and for every seed of ``--control_seeds`` the control:
the reference computed in TF32 put in the program's place, at the cell's own
size. One JSON line per reading, on standard output and appended to
``--out``. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def emit(row: dict, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness
    from perfbench.reference.geometry import Prec
    from perfbench.scene.dslr import make_scene

    dev = torch.device("cuda")
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    driver = harness.load_driver(traffic["driver"])
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        run = harness.Run(cell["name"], config, traffic, seed, args.seconds, False, dev)
        st = driver.prepare(run)
        out = driver.window(run, st)
        driver.release(st)
        gc.collect()
        numbers = driver.check(run, st, Prec("float64"))
        emit(dict(cell=cell["name"], kind="program", seed=seed, numbers=numbers,
                  metrics=out["metrics"], notes=run.notes, seconds=time.perf_counter() - t0), args.out)
        del st, run
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        run = harness.Run(cell["name"], config, traffic, seed, args.seconds, False, dev)
        scene = make_scene(config["scene"], seed, dev, levels=traffic["driver"] == "register",
                           mesh=traffic.get("occlusion") == "mesh")
        numbers = driver.control(run, scene, Prec("tf32"))
        emit(dict(cell=cell["name"], kind="control_tf32", seed=seed, numbers=numbers,
                  seconds=time.perf_counter() - t0), args.out)
        del scene
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
