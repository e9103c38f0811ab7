"""The port's counterpart of ``tests/test_full_pipeline.py``: every tool of
the port in the reference order on that test's 30,000-point scene, each on
the CPU (``--device cpu`` where the tool has the flag), each stage's outputs
feeding the next:

PointCloudCleaner -> CubeMapRenderer -> SfMScaleEstimator -> ICPScanAligner ->
NormalEstimator -> SplatCreator -> ImageRegistrator (with
``--write_debug_point_clouds``, ``--cache_observations`` and the cloud cache)
-> GroundTruthCreator.

The assertions are those of the JAX test for these stages. Left out: the
DatasetInspector (not ported, ROADMAP A.14) and the registrator's
``--devices 8`` (more than one device, ROADMAP A.11). No JAX function runs
here; the images are rendered with the port's own splat renderer.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from dataset_pipeline_tpu_torch.io import colmap as cio
from dataset_pipeline_tpu_torch.io.depthmap import read_depth_raw
from dataset_pipeline_tpu_torch.io.meshlab import MeshInfo, read_meshlab_project, write_meshlab_project
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.ops.splat import (
    CUBE_FACE_ROTATIONS,
    fill_color_from_depth,
    flood_fill_colors,
    render_points_depth_color,
)

RNG = np.random.RandomState(77)


@pytest.fixture
def four_threads():
    """Eight tools on 60,000 points: four threads for this test (the other
    port tests take two), restored after it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _scene(n=30000):
    u = RNG.rand(n)
    v = RNG.rand(n)
    x, y = u * 2, v * 2
    z = 0.12 * np.sin(3 * x) * np.cos(2.5 * y)
    pts = np.stack([x, y, z], -1).astype(np.float32)
    tex = (128 + 60 * np.sin(7 * x) * np.cos(9 * y) + 40 * np.sin(19 * x + 11 * y)).clip(0, 252)
    return pts, np.stack([tex] * 3, -1).astype(np.uint8)


def _look_at(eye, target, up=np.asarray([0.0, 1.0, 0.0])):
    f = target - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f])
    return R, -R @ eye


def _quat(R):
    w = np.sqrt(max(0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    return np.asarray([w, (R[2, 1] - R[1, 2]) / (4 * w),
                       (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w)])


def test_full_pipeline_with_port_tools(tmp_path, four_threads):
    from dataset_pipeline_tpu_torch.tools import (
        cube_map_renderer,
        ground_truth_creator,
        icp_scan_aligner,
        image_registrator,
        normal_estimator,
        point_cloud_cleaner,
        sfm_scale_estimator,
        splat_creator,
    )

    root = str(tmp_path)
    pts, cols = _scene()

    # 1. PointCloudCleaner
    outliers = (RNG.rand(40, 3).astype(np.float32) - 0.5) * 60 + np.asarray([30, 0, 0], np.float32)
    dirty = np.concatenate([pts, outliers])
    write_ply(f"{root}/scan0.ply", PointCloud(dirty, None,
                                              np.concatenate([cols, np.zeros((40, 3), np.uint8)])))
    assert point_cloud_cleaner.main(["--in", f"{root}/scan0.ply", "--filter", "24,1.3",
                                     "--device", "cpu"]) == 0
    cleaned = read_ply(f"{root}/scan0.inliers.ply")
    assert len(pts) * 0.95 <= len(cleaned) < len(dirty)
    assert len(read_ply(f"{root}/scan0.outliers.ply")) == len(dirty) - len(cleaned)

    # 2. CubeMapRenderer
    assert cube_map_renderer.main(["-c", f"{root}/scan0.inliers.ply", "-o", f"{root}/scan0.ply",
                                   "--size", "128", "--device", "cpu"]) == 0
    assert os.path.exists(f"{root}/scan0.ply.front.depth")
    assert os.path.exists(f"{root}/scan0.ply.intrinsics.txt")

    # 3. SfMScaleEstimator (a synthetic SfM model at 1/2 metric scale)
    depth = read_depth_raw(f"{root}/scan0.ply.right.depth", 128, 128)
    ys, xs = np.nonzero(np.isfinite(depth))
    assert len(ys) > 100
    sel = RNG.choice(len(ys), size=min(60, len(ys)), replace=False)
    keyp = np.stack([xs[sel], ys[sel]], -1).astype(np.float64)
    f = c = 64.0
    zs = depth[ys[sel], xs[sel]]
    pts3_face = np.stack([(keyp[:, 0] - c) / f * zs, (keyp[:, 1] - c) / f * zs, zs], -1)
    R_right = CUBE_FACE_ROTATIONS[3]
    pts3_global = pts3_face @ R_right
    os.makedirs(f"{root}/sfm", exist_ok=True)
    cams = {1: cio.ColmapCamera(1, "PINHOLE", 128, 128, np.asarray([f, f, c, c]))}
    imgs = {1: cio.ColmapImage(1, _quat(R_right), np.zeros(3), 1, "scan0.ply.right.png", keyp,
                               np.arange(len(sel), dtype=np.int64))}
    points = {i: cio.ColmapPoint3D(i, pts3_global[i] / 2.0, np.zeros(3, np.uint8), 0.1, [(1, i)])
              for i in range(len(sel))}
    cio.write_model(f"{root}/sfm", cio.ColmapModel(cams, imgs, points))
    assert sfm_scale_estimator.main(["-s", f"{root}/sfm", "-si", root, "-i", root,
                                     "-o", f"{root}/scaled"]) == 0
    assert len(read_meshlab_project(f"{root}/scaled/meshlab_project.mlp")) == 1

    # 4. ICPScanAligner (a second scan with a small offset)
    pts2, cols2 = _scene()
    write_ply(f"{root}/scan1.ply", PointCloud(pts2, None, cols2))
    M1 = np.eye(4)
    M1[:3, 3] = [0.02, -0.015, 0.01]
    write_meshlab_project(f"{root}/align_in.mlp", [MeshInfo("scan0", "scan0.inliers.ply", np.eye(4)),
                                                   MeshInfo("scan1", "scan1.ply", M1)])
    assert icp_scan_aligner.main(["-i", f"{root}/align_in.mlp", "-o", f"{root}/aligned.mlp",
                                  "-d", "0.05", "--max_iterations", "20", "--device", "cpu"]) == 0
    aligned = read_meshlab_project(f"{root}/aligned.mlp")
    assert np.linalg.norm(aligned[1].global_T_mesh[:3, 3]) < 5e-3

    # 5. NormalEstimator
    assert normal_estimator.main(["-i", f"{root}/aligned.mlp", "-o", f"{root}/merged.ply",
                                  "--neighbor_count", "8", "--device", "cpu"]) == 0
    assert read_ply(f"{root}/merged.ply").normals is not None

    # 6. SplatCreator (a mesh over x < 1 only: splats fill the rest)
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [1, 2, 0], [0, 2, 0]], np.float32)
    write_ply(f"{root}/mesh.ply", PointCloud(verts, faces=np.asarray([[0, 1, 2], [0, 2, 3]],
                                                                      np.int32)))
    assert splat_creator.main(["--point_normal_cloud_path", f"{root}/merged.ply",
                               "--mesh_path", f"{root}/mesh.ply",
                               "--output_path", f"{root}/splats.ply",
                               "--distance_threshold", "0.05", "--device", "cpu"]) == 0
    splats = read_ply(f"{root}/splats.ply")
    assert splats.faces is not None and len(splats.faces) > 0

    # 7. ImageRegistrator (two rendered views, perturbed poses)
    W, H, fx, cx, cy = 200, 150, 170.0, 99.5, 74.5
    os.makedirs(f"{root}/images/dslr", exist_ok=True)
    gt_poses, imgs2 = [], {}
    for i, eye in enumerate([np.asarray([1.0, 1.0, -1.3]), np.asarray([1.2, 0.9, -1.25])]):
        R, t = _look_at(eye, np.asarray([1.0, 1.0, 0.0]))
        p_cam = torch.from_numpy((pts @ R.T + t).astype(np.float32))
        d, cimg = render_points_depth_color(p_cam[None], torch.from_numpy(cols), W, H, fx, fx,
                                            cx, cy)
        cf, v = fill_color_from_depth(d[0], cimg[0])
        img = flood_fill_colors(cf, v).numpy()
        Image.fromarray(np.asarray(img, np.uint8)).convert("L").convert("RGB").save(
            f"{root}/images/dslr/v{i}.png")
        gt_poses.append((R, t))
        w_ = RNG.randn(3) * 0.003
        K = np.asarray([[0, -w_[2], w_[1]], [w_[2], 0, -w_[0]], [-w_[1], w_[0], 0]])
        u_, _, vt_ = np.linalg.svd((np.eye(3) + K) @ R)
        imgs2[i + 1] = cio.ColmapImage(i + 1, _quat(u_ @ vt_), t + RNG.randn(3) * 0.008, 1,
                                       f"dslr/v{i}.png")
    cio.write_model(f"{root}/state", cio.ColmapModel(
        {1: cio.ColmapCamera(1, "PINHOLE", W, H, np.asarray([fx, fx, cx + 0.5, cy + 0.5]))},
        imgs2, {}))
    write_meshlab_project(f"{root}/scene.mlp", [MeshInfo("scene", "scan0.inliers.ply", np.eye(4))])
    reg = ["--scan_alignment_path", f"{root}/scene.mlp", "--image_base_path", f"{root}/images",
           "--state_path", f"{root}/state", "--max_iterations", "15", "--fix_intrinsics",
           "--multi_res_point_cloud_directory_path", f"{root}/cache", "--cache_observations",
           "--device", "cpu"]
    assert image_registrator.main(reg + ["--output_folder_path", f"{root}/reg",
                                         "--write_debug_point_clouds"]) == 0
    dbg = read_ply(f"{root}/reg/initial_point_cloud.ply")
    assert dbg.colors is not None and (dbg.colors.sum(1) > 0).sum() > 1000
    refined = cio.read_model(f"{root}/reg/scale_1_state")
    for i, (R, t) in enumerate(gt_poses):
        init_err = np.linalg.norm(imgs2[i + 1].tvec - t)
        assert np.linalg.norm(refined.images[i + 1].tvec - t) < max(init_err, 5e-3)
    assert {"metadata.json", "photo_metadata.json",
            "observations_cache.npz"} <= set(os.listdir(f"{root}/cache"))

    # 8. GroundTruthCreator
    assert ground_truth_creator.main(["--scan_alignment_path", f"{root}/scene.mlp",
                                      "--state_path", f"{root}/reg/scale_1_state",
                                      "--output_folder_path", f"{root}/gt",
                                      "--splat_radius", "0.01", "--device", "cpu"]) == 0
    gt_depth = read_depth_raw(f"{root}/gt/ground_truth_depth/dslr/v0.png", H, W)
    valid = np.isfinite(gt_depth)
    assert valid.sum() > 500
    assert 0.3 < gt_depth[valid].min() < gt_depth[valid].max() < 10.0
    assert os.path.exists(f"{root}/gt/scan_alignment.mlp")
