"""Port vs JAX: the ICP measurement path's entry points on the CPU.

``tools/icp_bench.py`` (the counterpart of ``bench.py``'s ICP section) at a
small size through the kernels' plain versions, its problem generator
against ``bench.py``'s, ``entry()`` against ``__graft_entry__.entry()``, and
the rule that an entry point runs on the card unless the caller names the
CPU. Its times on the CPU are the host's and are only checked to be finite.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu_torch import entry as tentry
from dataset_pipeline_tpu_torch.icp import moments as tm
from dataset_pipeline_tpu_torch.tools import icp_bench

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_side_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_icp_bench_prints_one_json_line_with_every_key(capsys):
    results = {}
    assert icp_bench.main(["--device", "cpu", "--m", "98304", "--engine_ms", "98304"],
                          results=results) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out == results and out["device"] == "cpu"
    keys = {"m", "iters", "icp_lm_step_s", "icp_schedule_s", "icp_schedule_dispatch_s",
            "icp_schedule_final_cost", "icp_moment_accum_corr_per_s", "hbm_copy_gbps",
            "icp_moment_pass_event_s", "icp_moment_pass_bytes", "icp_engine_speedup_0m",
            "kernel_variants_ms", "device"}
    keys |= {f"{k}{s}" for k in ("icp_moment_pass_s", "icp_moment_pass_gbps",
                                 "icp_gn_corr_iters_per_s") for s in ("", "_min", "_max")}
    keys |= {f"icp_engine_{k}_{v}_0m" for k in ("moment", "direct", "device_lm") for v in ("s", "cost")}
    keys |= {"icp_engine_moment_pose_gap_0m", "icp_engine_device_lm_pose_gap_0m"}
    assert set(out) == keys  # no share of a card's peak from a CPU run
    assert set(out["kernel_variants_ms"]) == {"gn_fused", "gn_rows", "gn_rows_prep", "moment_gram",
                                              "moment_gram48", "moment_gram_thirds"}
    for k, v in _flat(out):
        if k != "device":
            assert math.isfinite(v) and v >= 0, (k, v)
    assert out["icp_moment_pass_bytes"] == 13 * 98304 * 4
    assert out["icp_schedule_s"] == out["icp_moment_pass_s"] + 20 * out["icp_lm_step_s"]
    # the three engines end at one pose
    assert out["icp_engine_moment_pose_gap_0m"] < 1e-5
    assert out["icp_engine_device_lm_pose_gap_0m"] < 1e-5


def test_icp_problem_is_bench_py_s():
    ref_groups, ref_pairs = _load("bench")._icp_problem(5000)
    groups, pairs = icp_bench._icp_problem(5000)
    assert pairs == ref_pairs and len(groups) == len(ref_groups) == 2
    for g, r in zip(groups, ref_groups):
        assert sorted(g) == sorted(r)
        for k in g:
            np.testing.assert_array_equal(g[k], r[k])


def test_wavy_correspondences_are_symmetric_and_on_the_surface():
    groups, pairs = icp_bench._wavy_correspondences(2000, torch.device("cpu"))
    assert pairs == [(0, 1), (1, 0)] and all(len(g["ps"]) == 1000 for g in groups)
    a, b = groups
    assert torch.equal(a["ps"], b["pt"]) and torch.equal(a["pt"], b["ps"])
    ps = a["ps"].numpy()
    np.testing.assert_allclose(ps[:, 2], 0.3 * np.sin(2 * ps[:, 0]) * np.cos(1.7 * ps[:, 1]), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(a["ns"].numpy(), axis=1), 1.0, atol=1e-6)
    assert 0.005 < float((a["pt"] - a["ps"]).abs().mean()) < 0.012  # 0.01 randn offsets


def test_entry_matches_graft_entry():
    fn_j, args_j = _load("__graft_entry__").entry()
    fn, args = tentry.entry(device="cpu")
    assert len(args) == len(args_j) == 9
    for a, b in zip(args, args_j):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    H, b, cost = fn(*args)
    Hj, bj, cj = fn_j(*args_j)
    assert H.shape == (12, 12) and b.shape == (12,)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-4, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-4 * np.abs(bj).max())
    np.testing.assert_allclose(float(cost), float(cj), rtol=1e-4)


def test_entry_points_default_to_the_card_and_raise_without_it(monkeypatch):
    """Nothing falls back to the CPU unasked: with no device named and no
    CUDA, every entry point raises; tensors keep their own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.RandomState(0)
    groups = [{k: rng.randn(50, 3).astype(np.float32) for k in ("ps", "ns", "pt", "nt")}]
    for call in (lambda: tm.pack_group_data(groups, 64),
                 lambda: tm.compute_group_moments(groups, 256),
                 lambda: tentry.entry(),
                 lambda: icp_bench.main([])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    tensors = [{k: torch.from_numpy(v) for k, v in groups[0].items()}]
    assert tm.pack_group_data(tensors, 64)[0].device.type == "cpu"
    assert tm.pack_group_data(groups, 64, device="cpu")[0].shape == (16, 64)
    assert len(tm.compute_group_moments(groups, 256, device="cpu")) == 1


def test_photometric_and_synthetic_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The functions that build tensors from numpy or from nothing (image
    and mask pyramids, point levels, the problem state, cameras, synthetic
    scenes) resolve no device to the card and raise without it; ``"cpu"``
    and tensors that already lie somewhere are taken as given."""
    from dataset_pipeline_tpu_torch import default_device
    from dataset_pipeline_tpu_torch.io.state import load_colmap_state
    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.photometric import masks, problem
    from dataset_pipeline_tpu_torch.photometric.multiscale import PointLevel
    from dataset_pipeline_tpu_torch.utils import synthetic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 255, (2, 16, 20)).astype(np.uint8)
    pts = rng.rand(40, 3).astype(np.float32)
    scans = np.zeros(40, np.uint8)
    inten = (255 * rng.rand(40)).astype(np.float32)
    level = PointLevel(pts, inten, scans, 0.01)
    params = [50.0, 50.0, 9.5, 7.5]
    lv = dict(points=pts, intensities=inten, scan_indices=scans,
              neighbors=np.zeros((40, 5), np.int64), fixed_descriptors=np.zeros((40, 5), np.float32),
              radius=0.01)
    synthetic.write_scene(str(tmp_path / "s"), 32, 24, 30.0, 1, 50, seed=0, device="cpu")
    calls = {
        "build_image_pyramid": lambda **kw: problem.build_image_pyramid(imgs, 2, **kw),
        "build_mask_pyramid": lambda **kw: masks.build_mask_pyramid(imgs, 2, **kw),
        "_neighbor_candidates": lambda **kw: problem._neighbor_candidates(pts, 5, **kw),
        "determine_point_neighbors": lambda **kw: problem.determine_point_neighbors(pts, scans, **kw),
        "build_photo_level": lambda **kw: problem.build_photo_level(
            level, apply_gradient_filter=False, **kw),
        "problem_from_numpy": lambda **kw: problem.problem_from_numpy([lv], [], pts, 0.01, 2, **kw),
        "make_camera": lambda **kw: cm.make_camera("PINHOLE", 20, 16, params, **kw),
        "load_colmap_state": lambda **kw: load_colmap_state(str(tmp_path / "s" / "state"), **kw),
        "true_poses": lambda **kw: synthetic.true_poses(2, 0.1, 0, **kw),
        "scan_points": lambda **kw: synthetic.scan_points(10, 1.0, 1.0, 5.0, 0, **kw),
        "write_scene": lambda **kw: synthetic.write_scene(
            str(tmp_path / "w"), 32, 24, 30.0, 1, 50, seed=0, **kw),
        "write_scene_at_density": lambda **kw: synthetic.write_scene_at_density(
            str(tmp_path / "d"), 32, 24, 30.0, 1, 0.1, 5.0, seed=0, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
        call(device="cpu")  # the CPU, when it is named
    with pytest.raises(RuntimeError, match="cuda"):
        default_device()
    assert default_device("cpu").type == "cpu" and default_device(torch.device("cpu")).type == "cpu"
    assert problem.build_image_pyramid(imgs, 2, device="cpu")[1].shape == (2, 8, 10)
    # a tensor keeps its own device; naming one moves it
    assert cm.make_camera("PINHOLE", 20, 16, torch.tensor(params)).params.device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        cm.make_camera("PINHOLE", 20, 16, torch.tensor(params), device="cuda")


def test_new_modules_import_no_jax():
    """A fresh interpreter imports the measurement path with jax and the
    JAX package made unimportable."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'dataset_pipeline_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import dataset_pipeline_tpu_torch.entry\n"
        "import dataset_pipeline_tpu_torch.ops.hbm\n"
        "import dataset_pipeline_tpu_torch.tools.icp_bench\n"
        "import dataset_pipeline_tpu_torch.tools.bench\n"
        "import dataset_pipeline_tpu_torch.refbench\n"
        "from dataset_pipeline_tpu_torch.utils.synthetic import joint_ba_test_scene\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dataset_pipeline_tpu')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
