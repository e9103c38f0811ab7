"""``utils/profiling.py``: ``device_trace`` writes a ``torch.profiler``
Chrome trace when ``DPT_TRACE_DIR`` (or its argument) names a directory and
nothing otherwise (the JAX package's ``device_trace`` contract, with
``jax.profiler`` swapped for ``torch.profiler``); ``StageTimer`` keeps the
JAX timer's stages and ``timing.json`` form; the registrator traces each
scale's optimisation under ``DPT_TRACE_DIR``, its stages and H,b spans
ranges in the trace.
"""

import json
import os

import torch

from dataset_pipeline_tpu_torch.utils import profiling
from dataset_pipeline_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(2)


def _work():
    x = torch.randn(64, 64)
    return (x @ x).sum()


def test_trace_written_when_the_env_names_a_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DPT_TRACE_DIR", str(tmp_path / "traces"))
    with profiling.device_trace():
        _work()
    files = os.listdir(tmp_path / "traces")
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.load(open(tmp_path / "traces" / files[0]))
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_trace_dir_argument_and_one_file_per_block(tmp_path, monkeypatch):
    monkeypatch.delenv("DPT_TRACE_DIR", raising=False)
    for _ in range(2):
        with profiling.device_trace(str(tmp_path)):
            _work()
    assert len(os.listdir(tmp_path)) == 2


def test_nothing_written_without_a_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("DPT_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.device_trace():
        _work()
    assert os.listdir(tmp_path) == []


def test_global_timer_stages(tmp_path):
    timer = StageTimer(torch.device("cpu"))
    with timer.stage("a"):
        _work()
    with timer.stage("a"):
        pass
    timer.dump_json(str(tmp_path / "timing.json"))
    got = json.load(open(tmp_path / "timing.json"))
    assert got["a"]["count"] == 2 and got["a"]["total_s"] >= 0


def test_registrator_traces_each_scale(tmp_path, monkeypatch):
    from dataset_pipeline_tpu_torch.tools import image_registrator
    from dataset_pipeline_tpu_torch.utils.synthetic import write_scene

    write_scene(str(tmp_path), 160, 120, 2800.0 * 160 / 3072, 2, 3000, seed=3, device="cpu")
    monkeypatch.setenv("DPT_TRACE_DIR", str(tmp_path / "traces"))
    assert image_registrator.main([
        "--scan_alignment_path", str(tmp_path / "scene.mlp"), "--image_base_path",
        str(tmp_path / "images"), "--state_path", str(tmp_path / "state"), "--output_folder_path",
        str(tmp_path / "out"), "--max_iterations", "1", "--device", "cpu"]) == 0
    scales = [k for k in json.load(open(tmp_path / "out" / "timing.json"))
              if k.startswith("optimize_scale_")]
    files = os.listdir(tmp_path / "traces")
    assert len(files) == len(scales) >= 1
    names = {ev.get("name") for ev in json.load(open(tmp_path / "traces" / files[0]))["traceEvents"]}
    assert {"hb_accumulate", "hb_accumulate.geometry", "hb_accumulate.sample",
            "hb_accumulate.gram", "hb_accumulate.assemble", "lm_ladder"} <= names
