"""The harness on the CPU: the contract of BENCHMARK.json, the check for
JAX, a run without a card, and a cell added as new files only."""

from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.toy import run_toy, toy_base, toy_bench

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = harness.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    n = 24  # the most cells a later PR may bring
    assert (2 + 14 * n) * (b["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert set(c["reduced"]) == set(cfg["reduced"]), "every cut is listed with its reason"
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            assert m["moves"] in [x["name"] for x in harness.cell_metrics(b, cell, "end_to_end")]
    for w in b["workloads"]:
        reported = [m["name"] for m in harness.cell_metrics(b, w["name"], "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(b, w["name"], "per_layer")
    assert len(json.dumps(b)) <= 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules({"dataset_pipeline_tpu_torch.ops", "jaxtyping", "flaxen"}) == []
    assert harness.forbidden_modules({"jax.numpy", "dataset_pipeline_tpu.ops.splat"}) == [
        "dataset_pipeline_tpu", "jax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_and_yardstick_import_nothing_of_the_program():
    """The reference, the scene, the roofline and the comparison import
    neither JAX nor either package, in their sources and when loaded."""
    files = [p for d in ("reference", "scene", "roofline") for p in (harness.HERE / d).glob("*.py")]
    files.append(harness.HERE / "compare.py")
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in ("jax", "dataset_pipeline_tpu", "dataset_pipeline_tpu_torch"), (f, mod)
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference.eth3d_dslr_register, "
            "perfbench.reference.eth3d_dslr_gt, perfbench.scene.dslr, perfbench.roofline.pyramid_sample, "
            "perfbench.compare; print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    loaded = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                       check=True).stdout.replace("'", '"'))
    assert not {"jax", "dataset_pipeline_tpu", "dataset_pipeline_tpu_torch"} & set(loaded)


def test_a_run_loads_no_jax():
    """What run.py loads to run a cell (the program included) holds no
    module named jax, jaxlib, flax or dataset_pipeline_tpu."""
    code = ("import sys; sys.path.insert(0, %r); import perfbench.run, perfbench.drivers.register, "
            "perfbench.drivers.gt, dataset_pipeline_tpu_torch.tools.image_registrator, "
            "dataset_pipeline_tpu_torch.tools.ground_truth_creator; from perfbench import harness; "
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("where", ["repo", "only_the_benchmark"])
def test_a_run_without_a_card_prints_nothing_and_fails(tmp_path, where):
    """On this CPU-only machine, and in a folder that holds only
    BENCHMARK.json and perfbench/, a run exits non-zero with no result."""
    cwd = ROOT
    if where == "only_the_benchmark":
        import shutil

        shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        shutil.copytree(harness.HERE, tmp_path / "perfbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "dslr_register.scale0",
                        "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=cwd,
                       capture_output=True, text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_cell_added_as_new_files_is_found_and_run(tmp_path):
    """A toy configuration, traffic mix and per-layer metric, new files and
    entries only, are found by name and the cell runs to a correct result
    that reports the new metric."""
    base = toy_base(tmp_path)
    (base / "metrics" / "toy_iterations.register.py").write_text(
        "def read(record):\n    return float(record['iterations'])\n")
    extra = [dict(name="toy_iterations.register", unit="iterations", better="higher",
                  source="host_clock", layer="LM driver", moves="lm_iteration_s",
                  workloads=["toy.register"])]
    res = run_toy(base, "toy.register", trace=True, bench=toy_bench(extra))
    assert res["correct"] is True
    assert res["metrics"]["toy_iterations.register"]["value"] >= 2
    assert {"hb_accumulate_ms.register", "refresh_ms.register", "lm_ladder_ms.register"} <= set(res["metrics"])
    assert list(res)[-2] == "compared" and all(
        v["value"] <= v["limit"] for v in res["compared"].values())
    res = run_toy(base, "toy.register")
    assert set(res["metrics"]) == {"lm_iteration_s", "peak_mem_gib", "setup_s"}
    assert math.isfinite(res["metrics"]["lm_iteration_s"]["value"])


def test_jax_loaded_after_the_window_stops_the_result(tmp_path, monkeypatch):
    """A per-layer reader that loads a module named jax (a stub here) makes
    the run exit non-zero with nothing on standard output: the last look
    before the result line finds it."""
    import argparse
    import contextlib
    import io

    import torch

    from perfbench.run import run_cell

    assert "jax" not in sys.modules
    stubs = tmp_path / "stubs"
    (stubs / "jax").mkdir(parents=True)
    (stubs / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stubs))
    base = toy_base(tmp_path / "toy")
    (base / "metrics" / "toy_jax.register.py").write_text(
        "import jax\n\n\ndef read(record):\n    return 1.0\n")
    bench = toy_bench([dict(name="toy_jax.register", unit="s", better="lower", source="host_clock",
                            layer="LM driver", moves="lm_iteration_s", workloads=["toy.register"])])
    args = argparse.Namespace(workload="toy.register", seed=5, seconds=0.5, trace=1)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run_cell(bench, harness.find_cell(bench, "toy.register"), args,
                          harness.process_start_s(), torch.device("cpu"), base=base)
    finally:
        sys.modules.pop("jax", None)
    assert rc != 0 and out.getvalue().strip() == ""
    assert "loaded before the result: jax" in err.getvalue()
