"""Port vs JAX: the ImageRegistrator CLI's remaining flags.

Small scenes of ``synthetic.write_scene`` (320x240, two image scales, one
scale run of ``--max_iterations 2``; for the observations cache 480x320, three
image scales, so that the second scale run works on the cache's views) through
``image_registrator.main(..., "--device", "cpu")`` and through the JAX tool:

- ``rigs.json``: four images, two synchronised sets of a two-camera rig
  (``write_scene(rig=...)``; the state's ``rigs.json`` names the folders
  ``cam0`` and ``cam1``), written again beside every exported state;
- ``--depth_residuals_weight 1``: passed to the optimizer, which gets no
  depth maps from the CLI (in either package);
- ``--occlusion_mesh_path``: a 2 cm grid mesh of the surface, alone and with
  the faces of ``--occlusion_splats_path`` added;
- ``--cache_observations`` with ``--multi_res_point_cloud_directory_path``
  (the first run writes both caches, a second run loads them) and without;
- ``--write_debug_point_clouds``: ``initial_point_cloud.ply``.

Held to the limits of ``test_torch_cli_registrator_flags.py``: the same
``scale_*_state`` files, qvec and tvec 5e-7 per entry, intrinsics 1e-3 px,
optimum cost 1e-4 relative, the other metadata equal (the observations
cache's hit rate too). The debug cloud's points and colours are equal to the
JAX tool's, byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.io import colmap as jcio
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.tools import image_registrator as treg
from dataset_pipeline_tpu_torch.utils import synthetic

torch.set_num_threads(2)
Q_TOL, T_TOL, PARAM_TOL, COST_RTOL = 5e-7, 5e-7, 1e-3, 1e-4  # as test_torch_cli_registrator_flags.py
W, H = 320, 240
RIG = [-0.15, 0.0, 0.0, 0.0, 0.004, 0.0]  # the second camera 15 cm to the right, turned 4 mrad


def _scene(root, width=W, height=H, rig=None):
    synthetic.write_scene(str(root), width, height, 2800.0 * width / 3072, 4 if rig else 2, 6000,
                          seed=7, device="cpu", rig=rig)
    return root


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    plain = _scene(tmp_path_factory.mktemp("plain"))
    half_w, half_h = synthetic.scan_extent(W, H, 2800.0 * W / 3072, 2, synthetic.DEPTH, 0.15)
    verts, faces = synthetic.surface_mesh(half_w, half_h, 0.02, synthetic.DEPTH)
    write_ply(str(plain / "mesh.ply"), PointCloud(verts, faces=faces))
    hv, hf = synthetic.surface_mesh(half_w, half_h, 0.02, synthetic.DEPTH, hole=(-0.1, 0.1, -0.1, 0.1))
    write_ply(str(plain / "mesh_hole.ply"), PointCloud(hv, faces=hf))
    # splat "quads" over the hole: two triangles per scan point near it
    scan = read_ply(str(plain / "scan.ply")).positions
    near = scan[(np.abs(scan[:, 0]) < 0.12) & (np.abs(scan[:, 1]) < 0.12)][:200]
    d = np.asarray([[-0.01, -0.01, 0], [0.01, -0.01, 0], [0.01, 0.01, 0], [-0.01, 0.01, 0]],
                   np.float32)
    quads = (near[:, None, :] + d[None]).reshape(-1, 3).astype(np.float32)
    v = np.arange(len(near), dtype=np.int32)[:, None] * 4
    sf = np.concatenate([v + [0, 1, 2], v + [0, 2, 3]]).astype(np.int32)
    write_ply(str(plain / "splats.ply"), PointCloud(quads, faces=sf))
    return {"plain": plain, "rig": _scene(tmp_path_factory.mktemp("rig"), rig=RIG),
            "three_scales": _scene(tmp_path_factory.mktemp("three_scales"), 480, 320)}


def _args(root, out, extra):
    return ["--scan_alignment_path", str(root / "scene.mlp"),
            "--image_base_path", str(root / "images"), "--state_path", str(root / "state"),
            "--output_folder_path", str(root / out), "--max_iterations", "2", *extra]


def _meta(path):
    return dict(line.split(" ", 1) for line in open(path).read().splitlines())


def _compare(a_dir, b_dir):
    scales = sorted(d for d in os.listdir(a_dir) if d.startswith("scale_"))
    assert scales and scales == sorted(d for d in os.listdir(b_dir) if d.startswith("scale_"))
    for d in scales:
        assert sorted(os.listdir(b_dir / d)) == sorted(os.listdir(a_dir / d))
        a, b = jcio.read_model(str(a_dir / d)), jcio.read_model(str(b_dir / d))
        assert sorted(a.images) == sorted(b.images) and sorted(a.cameras) == sorted(b.cameras)
        for i in a.images:
            assert a.images[i].name == b.images[i].name
            np.testing.assert_allclose(b.images[i].qvec, a.images[i].qvec, rtol=0, atol=Q_TOL)
            np.testing.assert_allclose(b.images[i].tvec, a.images[i].tvec, rtol=0, atol=T_TOL)
        for c in a.cameras:
            np.testing.assert_allclose(b.cameras[c].params, a.cameras[c].params, rtol=0,
                                       atol=PARAM_TOL)
        ma, mb = _meta(a_dir / d / "metadata.txt"), _meta(b_dir / d / "metadata.txt")
        assert list(ma) == list(mb)
        assert {k: v for k, v in ma.items() if k != "optimum_cost"} == \
               {k: v for k, v in mb.items() if k != "optimum_cost"}
        np.testing.assert_allclose(float(mb["optimum_cost"]), float(ma["optimum_cost"]),
                                   rtol=COST_RTOL)
        if os.path.exists(a_dir / d / "rigs.json"):
            assert open(b_dir / d / "rigs.json").read() == open(a_dir / d / "rigs.json").read()
    return scales


def _run_both(root, name, extra):
    from dataset_pipeline_tpu.tools.image_registrator import main as jax_main

    assert jax_main(_args(root, f"jax_{name}", extra)) == 0
    stats = {}
    assert treg.main(_args(root, f"port_{name}", extra + ["--device", "cpu"]), stats=stats) == 0
    return _compare(root / f"jax_{name}", root / f"port_{name}"), stats


def test_rigs_json_matches_jax_tool(scenes):
    root = scenes["rig"]
    scales, stats = _run_both(root, "rig", [])
    # the rig's extrinsics hold: image_T_global(cam1) = extr . image_T_global(cam0)
    m = jcio.read_model(str(root / "port_rig" / scales[-1]))
    from dataset_pipeline_tpu_torch.models.lie import quat_to_matrix_np

    rel = []
    for s in range(2):
        a, b = m.images[2 * s + 1], m.images[2 * s + 2]
        Ra, Rb = quat_to_matrix_np(a.qvec), quat_to_matrix_np(b.qvec)
        rel.append((Rb @ Ra.T, b.tvec - Rb @ Ra.T @ a.tvec))
    np.testing.assert_allclose(rel[0][0], rel[1][0], atol=1e-5)
    np.testing.assert_allclose(rel[0][1], rel[1][1], atol=1e-5)
    assert stats["scales"][-1]["optimum_cost"] < stats["scales"][-1]["iteration_costs"][0]


@pytest.mark.parametrize("extra", [
    ["--depth_residuals_weight", "1"],
    ["--occlusion_mesh_path", "mesh.ply"],
    ["--occlusion_mesh_path", "mesh_hole.ply", "--occlusion_splats_path", "splats.ply"],
    ["--cache_observations"],
], ids=["depth_weight", "mesh", "mesh_and_splats", "cache_observations"])
def test_flags_match_jax_tool(scenes, extra):
    root = scenes["three_scales" if "--cache_observations" in extra else "plain"]
    extra = [str(root / x) if x.endswith(".ply") else x for x in extra]
    name = "_".join(os.path.basename(x).strip("-").replace(".ply", "") for x in extra)
    _run_both(root, name, extra)


def test_both_caches_write_then_load(scenes):
    """The first run of each tool writes the multi-resolution cloud, the
    photo levels and the observations cache into its own directory; the
    second loads them and gives the same states."""
    root = scenes["three_scales"]
    for run in ("write", "load"):
        for pkg in ("jax", "port"):
            _run_both_cache = ["--multi_res_point_cloud_directory_path", str(root / f"cache_{pkg}"),
                               "--cache_observations"]
            if pkg == "jax":
                from dataset_pipeline_tpu.tools.image_registrator import main as jax_main

                assert jax_main(_args(root, f"jax_cache_{run}", _run_both_cache)) == 0
            else:
                assert treg.main(_args(root, f"port_cache_{run}",
                                       _run_both_cache + ["--device", "cpu"])) == 0
        _compare(root / f"jax_cache_{run}", root / f"port_cache_{run}")
    for pkg in ("jax", "port"):
        _compare(root / f"{pkg}_cache_write", root / f"{pkg}_cache_load")
    assert sorted(os.listdir(root / "cache_port")) == sorted(os.listdir(root / "cache_jax"))
    assert "observations_cache.npz" in os.listdir(root / "cache_port")


def test_write_debug_point_clouds_matches_jax_tool(scenes):
    root = scenes["plain"]
    _run_both(root, "debug", ["--write_debug_point_clouds"])
    a = read_ply(str(root / "jax_debug" / "initial_point_cloud.ply"))
    b = read_ply(str(root / "port_debug" / "initial_point_cloud.ply"))
    np.testing.assert_array_equal(b.positions, a.positions)
    np.testing.assert_array_equal(b.colors, a.colors)
    assert (a.colors > 0).any(axis=1).mean() > 0.3
    assert (open(root / "port_debug" / "initial_point_cloud.ply", "rb").read()
            == open(root / "jax_debug" / "initial_point_cloud.ply", "rb").read())
