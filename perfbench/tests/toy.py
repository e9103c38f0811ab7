"""Toy cells for the CPU tests: the cells' configurations cut to a few
seconds on the CPU (2 images of 640x480, ~200,000 scan points), written as
new files into a folder laid out as ``perfbench/`` is, so that they are
found by name as a later PR's cell would be."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
from pathlib import Path

import torch

from perfbench import harness
from perfbench.run import run_cell

TOY_SCENE = dict(image_size=[640, 480], focal=583.33, images=2, scan_density=7500)


def toy_base(tmp: Path) -> Path:
    """A folder with the toy configurations and traffic mixes and a copy of
    every metric reader."""
    for sub in ("configs", "traffic", "metrics"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    reg = harness.load_json("configs", "eth3d_dslr_register")
    reg["scene"].update(TOY_SCENE, level_points=[20000, 6000, 1500])
    reg["registrator"]["scale_count"] = 3
    gt = harness.load_json("configs", "eth3d_dslr_gt")
    gt["scene"].update(TOY_SCENE, mesh_spacing=0.05)
    (tmp / "configs" / "toy_register.json").write_text(json.dumps(reg))
    (tmp / "configs" / "toy_gt.json").write_text(json.dumps(gt))
    traffic = {
        "toy_register": {"driver": "register", "scale": 0, "iterations": 2},
        "toy_gt_mesh": {"driver": "gt", "occlusion": "mesh"},
        "toy_gt_splats": {"driver": "gt", "occlusion": "splats"},
    }
    for name, t in traffic.items():
        (tmp / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for f in (harness.HERE / "metrics").glob("*.py"):
        shutil.copy(f, tmp / "metrics" / f.name)
    return tmp


def toy_bench(extra_metrics=()) -> dict:
    """BENCHMARK.json with the toy cells added as entries, every metric of
    the registrator or ground-truth cells also reported by their toy twin."""
    bench = harness.load_benchmark()
    twins = {"toy.register": ("toy_register", "toy_register", "dslr_register.scale0"),
             "toy.gt_mesh": ("toy_gt", "toy_gt_mesh", "dslr_gt.mesh"),
             "toy.gt_splats": ("toy_gt", "toy_gt_splats", "dslr_gt.splats")}
    for name, (config, traffic, twin) in twins.items():
        bench["workloads"].append(dict(name=name, config=config, traffic=traffic, chips=1, why="toy"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin in m.get("workloads", ()):
                m["workloads"].append(name)
    bench["per_layer"] += list(extra_metrics)
    return bench


def run_toy(base: Path, cell: str, seed: int = 3, trace: bool = False, seconds: float = 0.5,
            bench=None, device: str = "cpu") -> dict:
    """Run a toy cell in this process; returns its parsed result line."""
    bench = toy_bench() if bench is None else bench
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=int(trace))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_cell(bench, harness.find_cell(bench, cell), args, harness.process_start_s(),
                      torch.device(device), base=base)
    assert rc == 0, err.getvalue()
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1])
    result["stderr"] = err.getvalue()
    return result
