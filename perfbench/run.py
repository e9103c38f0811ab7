"""Run one cell of the benchmark of dataset_pipeline_tpu_torch on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix (found by name, see
``perfbench/harness.py``), sets it up from the seed, measures for
``--seconds``, checks what the measured window produced against the plain
reference, and prints one JSON line last: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled window. The numbers compared, each with its limit, are the last
lines of standard error and the last key of the JSON line.

Without a card (``torch.cuda.is_available()`` false, or fewer cards than
the cell asks for), or with JAX or the JAX package loaded (looked for at the
start, after the window, and just before the result line), it prints no
result and exits with 1. Every build and kernel cache lies under ``build/``
in the checkout.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions", "TRITON_CACHE_DIR": "build/triton_cache"}


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    t_start = harness.process_start_s()
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded at start: {', '.join(bad)}")
    import torch

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"torch.cuda.is_available() is {torch.cuda.is_available()}")
    return run_cell(bench, cell, args, t_start, torch.device("cuda"))


def run_cell(bench, cell, args, t_start, device, base=None) -> int:
    """Set up, measure, check and print; ``t_start`` is the process's start
    on the boot clock, ``base`` the folder of the configurations, traffic
    mixes and metric readers (this one's by default)."""
    import torch

    from perfbench import harness, trace
    from perfbench.reference.geometry import Prec

    base = harness.HERE if base is None else base
    config = harness.load_json("configs", cell["config"], base)
    traffic = harness.load_json("traffic", cell["traffic"], base)
    driver = harness.load_driver(traffic["driver"])
    kind = "per_layer" if args.trace else "end_to_end"
    wanted = harness.cell_metrics(bench, cell["name"], kind)
    run = harness.Run(cell["name"], config, traffic, args.seed, args.seconds, bool(args.trace), device)
    run.record["per_layer"] = [m["name"] for m in harness.cell_metrics(bench, cell["name"], "per_layer")]
    cuda = device.type == "cuda"

    st = driver.prepare(run)
    if args.trace:
        run.profiler = trace.profiler()
        run.profiler.__enter__()
        run.window_span = trace.span("window", True)
        run.window_span.__enter__()
    setup_s = harness.boot_clock() - t_start
    out = driver.window(run, st)
    summary = None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded after the window: {', '.join(bad)}")
    if run.traced is not None:
        summary = trace.summarize(run.traced, getattr(driver, "KERNELS", ()))
        run.traced = None
        run.record["profile"] = summary
        driver.after_trace(run, st, summary)

    metrics = {}
    if args.trace:
        for m in wanted:
            v = harness.load_reader(m["name"], base)(run.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s, peak_mem_gib=peak / 2**30)
        for m in wanted:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    driver.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from perfbench.compare import verdict

    t_check = time.perf_counter()
    numbers = driver.check(run, st, Prec("float64"))
    run.notes.append(f"reference and comparison {time.perf_counter() - t_check:.3f} s")
    correct, rows = verdict(numbers, dict(config["limits"]["compared"], **traffic.get("limits", {})))
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    for line in run.notes:
        print(line, file=sys.stderr)
    print(f"setup_s {setup_s:.3f}, window {out['seconds']:.3f} s, peak {peak / 2**30:.3f} GiB, "
          f"power limit {power_limit()}", file=sys.stderr)
    for name, v, lim in rows:
        print(f"compared {name} {v:.6e} limit {lim:.6e} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    # the readers, the comparison and the reference have run since the last look
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded before the result: {', '.join(bad)}")
    print(harness.result_line(correct, out["attempted"], 0 if correct else 1, metrics, device_info,
                              rows, breakdown))
    return 0


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or ``unknown``."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "unknown"


if __name__ == "__main__":
    sys.exit(main())
