"""Port vs JAX: the ImageRegistrator CLI end to end.

A two-image 640x480 scene (ray-cast textured height field, 8-bit PGM,
coloured scan PLY, COLMAP state with poses perturbed by
``SE3.exp(0.002 randn(6))``; 3 image scales, so two scale runs) through
``image_registrator.main(..., "--device", "cpu")`` and through the JAX tool,
``--max_iterations 3``. Both write ``scale_0.5_state`` and ``scale_1_state``
(cameras, images, metadata.txt) and ``timing.json``.

Tolerances (the card's CUDA-vs-CPU run in ``chip_smoke.py`` is held to the
same): qvec and tvec 5e-7 per entry, intrinsics 1e-3 px, optimum cost 1e-4
relative. Measured gaps on a CPU, port vs JAX: qvec 2.1e-9, tvec 1.4e-8,
intrinsics 6.1e-5 px, cost 4.5e-7; CUDA vs CPU on an H100: qvec 6.0e-8,
tvec 7e-10. With 60k scan points instead of 40k the cost gap was 4.2e-5
(float32 sums over ~10^5 residuals and the variable-descriptor means, in
another order), hence the cost's wider margin. Each scale run moves every
image's pose by at least 2.0e-5 (qvec) and 1.2e-4 (tvec) per largest entry,
and the test requires a motion of at least 20x the pose limits, so a run
that leaves the poses (nearly) unchanged cannot pass the comparison.
"""

import json
import os

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.io import colmap as jcio
from dataset_pipeline_tpu_torch.parallel import mesh as tmesh
from dataset_pipeline_tpu_torch.tools import image_registrator as treg
from dataset_pipeline_tpu_torch.utils.synthetic import write_scene

torch.set_num_threads(2)
Q_TOL, T_TOL, PARAM_TOL, COST_RTOL = 5e-7, 5e-7, 1e-3, 1e-4
MIN_MOTION = 20  # per-scale pose motion, in units of Q_TOL / T_TOL
W, H = 640, 480


def _args(root, out, extra=()):
    return ["--scan_alignment_path", str(root / "scene.mlp"),
            "--image_base_path", str(root / "images"), "--state_path", str(root / "state"),
            "--output_folder_path", str(root / out), "--max_iterations", "3", *extra]


def _meta(path):
    return dict(line.split(" ", 1) for line in open(path).read().splitlines())


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("registrator")
    truth = write_scene(str(root), W, H, 2800.0 * W / 3072, 2, 40_000, seed=3, device="cpu")
    return root, truth


def test_image_registrator_matches_jax_tool(scene):
    from dataset_pipeline_tpu.tools.image_registrator import main as jax_main

    root, (tq, tt) = scene
    assert jax_main(_args(root, "jax")) == 0
    timings, stats = {}, {}
    assert treg.main(_args(root, "port", ["--device", "cpu"]), timings=timings,
                     stats=stats) == 0
    scales = sorted(d for d in os.listdir(root / "jax") if d.startswith("scale_"))
    assert scales == ["scale_0.5_state", "scale_1_state"]
    assert scales == sorted(d for d in os.listdir(root / "port") if d.startswith("scale_"))
    for d in scales:
        assert sorted(os.listdir(root / "port" / d)) == sorted(os.listdir(root / "jax" / d))
        a, b = jcio.read_model(str(root / "jax" / d)), jcio.read_model(str(root / "port" / d))
        assert sorted(a.images) == sorted(b.images)
        for i in a.images:
            assert a.images[i].name == b.images[i].name
            np.testing.assert_allclose(b.images[i].qvec, a.images[i].qvec, rtol=0, atol=Q_TOL)
            np.testing.assert_allclose(b.images[i].tvec, a.images[i].tvec, rtol=0, atol=T_TOL)
        for c in a.cameras:
            assert (b.cameras[c].model, b.cameras[c].width, b.cameras[c].height) == (
                a.cameras[c].model, a.cameras[c].width, a.cameras[c].height)
            np.testing.assert_allclose(b.cameras[c].params, a.cameras[c].params, rtol=0,
                                       atol=PARAM_TOL)
        ma, mb = _meta(root / "jax" / d / "metadata.txt"), _meta(root / "port" / d / "metadata.txt")
        assert list(ma) == list(mb)
        assert {k: v for k, v in ma.items() if k != "optimum_cost"} == \
               {k: v for k, v in mb.items() if k != "optimum_cost"}
        np.testing.assert_allclose(float(mb["optimum_cost"]), float(ma["optimum_cost"]),
                                   rtol=COST_RTOL)
    expected = {"load_scans", "build_multiscale_cloud", "determine_point_neighbors",
                "optimize_scale_1", "optimize_scale_0"}
    port_timing = json.load(open(root / "port" / "timing.json"))
    assert set(port_timing) == expected
    assert expected <= set(json.load(open(root / "jax" / "timing.json")))
    assert all(v["count"] == 1 and v["total_s"] >= 0 for v in port_timing.values())
    assert {"occlusion", "visibility", "variable_descriptors", "hb_accumulate",
            "lm_ladder"} <= set(timings)
    # the run moved the poses toward the truth and lowered the cost
    init = jcio.read_model(str(root / "state"))
    prev = init
    for d in scales:
        m = jcio.read_model(str(root / "port" / d))
        for i in m.images:
            assert np.abs(m.images[i].qvec - prev.images[i].qvec).max() > MIN_MOTION * Q_TOL
            assert np.abs(m.images[i].tvec - prev.images[i].tvec).max() > MIN_MOTION * T_TOL
        prev = m
    final = jcio.read_model(str(root / "port" / "scale_1_state"))
    err = [np.mean([np.linalg.norm(m.images[i].tvec - tt[i - 1]) for i in m.images])
           for m in (init, final)]
    assert err[1] < err[0]
    for sc in stats["scales"]:
        assert sc["optimum_cost"] < sc["iteration_costs"][0]
        assert min(sc["observations"]) > 1000


@pytest.mark.parametrize("extra", [["--cache_observations"], ["--devices", "2"],
                                   ["--mesh", "1x2"], ["--write_debug_point_clouds"],
                                   ["--depth_residuals_weight", "1"],
                                   ["--multi_res_point_cloud_directory_path", "cache"],
                                   ["--occlusion_mesh_path", "mesh.ply"]])
def test_paths_not_ported_yet_raise(tmp_path, extra, monkeypatch):
    """No flag of the list raises any more: each is accepted
    (``tests/test_torch_cli_registrator_remainders.py`` holds each against
    the JAX tool), and more than one device (``--devices 2``, ``--mesh
    1x2``), ported since, makes the tool start two ranks itself
    (``tests/test_torch_cli_registrator_devices.py`` runs them)."""
    for k in ("DPT_COORDINATOR", "DPT_NUM_PROCESSES", "DPT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    args, _ = treg.parse_args(_args(tmp_path, "out", ["--device", "cpu", *extra]))
    n_ranks = tmesh.ranks_to_launch(args.devices, args.mesh, args.device)
    assert n_ranks == (2 if extra[0] in ("--devices", "--mesh") else 0)
    assert not hasattr(treg, "NotPortedError")


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so --device cuda is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        treg.main(_args(tmp_path, "out", ["--device", "cuda"]))
