"""The harness: cells found by name, one run of a cell, its result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration is ``configs/<config>.json``; the traffic mix is
``traffic/<traffic>.json``, whose ``driver`` names the module
``drivers/<driver>.py`` that sets the cell up, runs its measured window and
checks its outputs; each per-layer metric is read by ``metrics/<metric>.py``.
A later cell is new files and entries: nothing here names a cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dataset_pipeline_tpu")
# seconds of a traced window under the profiler: its events take ~2.6 s each
# to reduce, so a whole 51-s window would not end within a run's limit
TRACE_S = 20.0


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def process_start_s() -> float:
    """This process's start on the boot clock (seconds)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    with open(base / kind / f"{name}.json") as f:
        return json.load(f)


def load_driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def load_reader(metric: str, base: Path = HERE):
    """``read(record)`` of ``metrics/<metric>.py`` (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``cell`` reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Run:
    """One run of a cell: what the driver is given and what it leaves."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    record: dict = field(default_factory=dict)  # what the per-layer readers read
    notes: list = field(default_factory=list)  # lines for standard error
    profiler: object = None  # the running profiler of a traced window's first part
    traced: object = None  # the stopped profiler, for the reduction
    window_span: object = None

    @property
    def tracing(self) -> bool:
        return self.profiler is not None

    def boundary(self, elapsed: float, snapshot: dict, last: bool) -> None:
        """After each episode or pass of the window: once the profiler has
        run ``TRACE_S`` seconds, or at the window's end, stop it and keep
        ``snapshot`` (the work and stage seconds so far) for the per-layer
        readers; the window goes on untraced."""
        if self.profiler is None or (elapsed < TRACE_S and not last):
            return
        sync(self.device)
        self.window_span.__exit__(None, None, None)
        self.profiler.__exit__(None, None, None)
        self.traced, self.profiler = self.profiler, None
        self.record.update(snapshot)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                numbers, breakdown=None) -> str:
    """The last line of standard output; the numbers compared come last,
    each with its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    return json.dumps(out)


def sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.synchronize(device)
