"""Port vs JAX: the NormalEstimator and SplatCreator CLIs, files compared.

Two scans of ``synthetic.write_scene``'s height field (the second's points
stored under a tilted pose) through ``normal_estimator.main(..., "--device", "cpu")`` and
the JAX tool, by brute force and (``--grid_above 1500``) by the voxel grid:
the merged PLY's positions and colours bit for bit, the normals within 1e-4
(the tolerance of ``test_torch_knn.py``'s normals). Then both SplatCreators
on the JAX tool's merged cloud and a grid mesh of the surface with a
rectangular hole: the same splat count and faces, the vertices within 1e-6,
and the splats in the hole.
"""

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.tools import normal_estimator as jne
from dataset_pipeline_tpu.tools import splat_creator as jsc
from dataset_pipeline_tpu_torch.io.meshlab import MeshInfo, write_meshlab_project
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.tools import normal_estimator as tne
from dataset_pipeline_tpu_torch.tools import splat_creator as tsc
from dataset_pipeline_tpu_torch.utils import synthetic

torch.set_num_threads(2)
W, H, F = 96, 72, 80.0
HOLE = (-0.6, 0.4, -0.5, 0.3)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("normals_splats")
    synthetic.write_scene(str(root), W, H, F, 2, 4000, seed=9, device="cpu")
    scan = read_ply(str(root / "scan.ply"))
    M1 = np.eye(4)
    a = 0.07
    M1[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    M1[:3, 3] = [0.01, 0.02, -0.03]
    half = len(scan.positions) // 2
    write_ply(str(root / "a.ply"), PointCloud(scan.positions[:half], None, scan.colors[:half]))
    b_local = (scan.positions[half:] - M1[:3, 3]) @ M1[:3, :3]  # the same world points
    write_ply(str(root / "b.ply"), PointCloud(b_local.astype(np.float32), None, scan.colors[half:]))
    write_meshlab_project(str(root / "two.mlp"), [MeshInfo("a", "a.ply", np.eye(4)),
                                                  MeshInfo("b", "b.ply", M1)])
    half_w, half_h = synthetic.scan_extent(W, H, F, 2, synthetic.DEPTH, 0.15)
    verts, faces = synthetic.surface_mesh(half_w, half_h, 0.05, synthetic.DEPTH, hole=HOLE)
    write_ply(str(root / "mesh.ply"), PointCloud(verts, faces=faces))
    return root


@pytest.mark.parametrize("extra", [[], ["--grid_above", "1500"]], ids=["bruteforce", "grid"])
def test_normal_estimator_matches_jax(scene, extra):
    args = ["-i", str(scene / "two.mlp"), "--neighbor_count", "8", *extra]
    tag = "grid" if extra else "bf"
    assert jne.main(args + ["-o", str(scene / f"n_{tag}_jax.ply")]) == 0
    assert tne.main(args + ["-o", str(scene / f"n_{tag}_torch.ply"), "--device", "cpu"]) == 0
    j, t = read_ply(str(scene / f"n_{tag}_jax.ply")), read_ply(str(scene / f"n_{tag}_torch.ply"))
    np.testing.assert_array_equal(t.positions, j.positions)
    np.testing.assert_array_equal(t.colors, j.colors)
    np.testing.assert_allclose(t.normals, j.normals, atol=1e-4)
    assert (np.linalg.norm(t.normals, axis=1) > 0.99).mean() > 0.99


def test_splat_creator_matches_jax(scene):
    merged = scene / "n_for_splats.ply"
    assert jne.main(["-i", str(scene / "two.mlp"), "-o", str(merged)]) == 0
    args = ["--point_normal_cloud_path", str(merged), "--mesh_path", str(scene / "mesh.ply"),
            "--distance_threshold", "0.03"]
    assert jsc.main(args + ["--output_path", str(scene / "s_jax.ply")]) == 0
    assert tsc.main(args + ["--output_path", str(scene / "s_torch.ply"), "--device", "cpu"]) == 0
    j, t = read_ply(str(scene / "s_jax.ply")), read_ply(str(scene / "s_torch.ply"))
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_allclose(t.positions, j.positions, rtol=0, atol=1e-6)
    # every point well inside the hole has a splat; none deep inside the mesh
    centers = t.positions.reshape(-1, 4, 3).mean(1)
    pts = read_ply(str(merged)).positions
    x0, x1, y0, y1 = HOLE

    def inside(p, margin):
        return ((p[:, 0] > x0 + margin) & (p[:, 0] < x1 - margin)
                & (p[:, 1] > y0 + margin) & (p[:, 1] < y1 - margin))

    deep = inside(pts, 0.1)
    assert deep.sum() > 20
    d2 = ((pts[deep][:, None, :2] - centers[None, :, :2]) ** 2).sum(-1).min(1)
    assert (d2 < 1e-8).all()
    half_w, half_h = synthetic.scan_extent(W, H, F, 2, synthetic.DEPTH, 0.15)
    meshed = ~inside(centers, -0.6) & (np.abs(centers[:, 0]) < half_w - 0.6) & (
        np.abs(centers[:, 1]) < half_h - 0.6)
    assert not meshed.any()
