"""Port vs JAX: the CubeMapRenderer and SfMScaleEstimator CLIs, files compared.

A 20,000-point cloud in the form of ``bench.py``'s ``_cube_cloud`` (random
directions, distances 1-20, random colours) through
``cube_map_renderer.main(..., "--device", "cpu")`` and the JAX tool at
``--size 96``: every ``.depth`` file (median hole fill), ``.png`` (flood fill)
and ``intrinsics.txt`` equal. Then a COLMAP model of keypoints of the
"right" face at a known scale of 2 (as ``tests/test_full_pipeline.py`` builds
it) through both SfM scale estimators: the same ``meshlab_project.mlp`` and
``colmap_model/``, and the scale within 1e-4 of 2.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from dataset_pipeline_tpu.tools import cube_map_renderer as jcube
from dataset_pipeline_tpu.tools import sfm_scale_estimator as jsfm
from dataset_pipeline_tpu_torch.io import colmap as cio
from dataset_pipeline_tpu_torch.io.depthmap import read_depth_raw
from dataset_pipeline_tpu_torch.io.meshlab import read_meshlab_project
from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
from dataset_pipeline_tpu_torch.ops.splat import CUBE_FACE_NAMES, CUBE_FACE_ROTATIONS
from dataset_pipeline_tpu_torch.tools import cube_map_renderer as tcube
from dataset_pipeline_tpu_torch.tools import sfm_scale_estimator as tsfm

torch.set_num_threads(2)
SIZE = 96


def cube_cloud(n_points, seed=0):
    """The cloud of ``bench.py:_cube_cloud``."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(1.0, 20.0, n_points).astype(np.float32)
    v = rng.randn(n_points, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    cols = rng.randint(0, 255, (n_points, 3)).astype(np.uint8)
    return v * d[:, None], cols


def _quat(R):
    w = np.sqrt(max(0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    return np.asarray([w, (R[2, 1] - R[1, 2]) / (4 * w),
                       (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w)])


@pytest.fixture(scope="module")
def cubes(tmp_path_factory):
    root = tmp_path_factory.mktemp("cube")
    pos, cols = cube_cloud(20_000)
    write_ply(str(root / "scan0.ply"), PointCloud(pos, None, cols))
    for side in ("jax", "torch"):
        os.makedirs(root / side)
    args = ["-c", str(root / "scan0.ply"), "--size", str(SIZE)]
    assert jcube.main(args + ["-o", str(root / "jax" / "scan0.ply")]) == 0
    stats = {}
    assert tcube.main(args + ["-o", str(root / "torch" / "scan0.ply"), "--device", "cpu"],
                      stats=stats) == 0
    return root, stats


def test_cube_map_files_match_jax(cubes):
    root, stats = cubes
    names = sorted(os.listdir(root / "jax"))
    assert names == sorted(os.listdir(root / "torch")) and len(names) == 13
    for name in names:
        j, t = root / "jax" / name, root / "torch" / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(t)), np.asarray(Image.open(j)))
        else:
            assert t.read_bytes() == j.read_bytes(), name
    depth = read_depth_raw(str(root / "torch" / "scan0.ply.front.depth"), SIZE, SIZE)
    assert 0.2 < np.isfinite(depth).mean() < 1.0  # holes left after one fill pass
    assert stats["flood_fill_steps"] >= 1


def test_flood_fill_leaves_no_black_pixel(cubes):
    root, _ = cubes
    for face in CUBE_FACE_NAMES:
        img = np.asarray(Image.open(root / "torch" / f"scan0.ply.{face}.png"))
        assert img.shape == (SIZE, SIZE, 3)
        # colours come from 0..254 per channel, a pure-black filled pixel is an unfilled one
        assert (img.max(-1) > 0).mean() > 0.999


def _sfm_model(root, depth_dir):
    rng = np.random.RandomState(77)
    depth = read_depth_raw(f"{depth_dir}/scan0.ply.right.depth", SIZE, SIZE)
    ys, xs = np.nonzero(np.isfinite(depth))
    sel = rng.choice(len(ys), size=60, replace=False)
    keyp = np.stack([xs[sel], ys[sel]], -1).astype(np.float64)
    f = c = SIZE / 2
    zs = depth[ys[sel], xs[sel]]
    pts3_face = np.stack([(keyp[:, 0] - c) / f * zs, (keyp[:, 1] - c) / f * zs, zs], -1)
    R_right = CUBE_FACE_ROTATIONS[3]
    pts3_global = pts3_face @ R_right
    true_scale = 2.0
    cams = {1: cio.ColmapCamera(1, "PINHOLE", SIZE, SIZE, np.asarray([f, f, c, c]))}
    imgs = {1: cio.ColmapImage(1, _quat(R_right), np.zeros(3), 1, "scan0.ply.right.png", keyp,
                               np.arange(60, dtype=np.int64))}
    points = {i: cio.ColmapPoint3D(i, pts3_global[i] / true_scale, np.zeros(3, np.uint8), 0.1,
                                   [(1, i)]) for i in range(60)}
    cio.write_model(f"{root}/sfm", cio.ColmapModel(cams, imgs, points))


def test_sfm_scale_estimator_matches_jax(cubes, capsys):
    root, _ = cubes
    root = str(root)
    _sfm_model(root, f"{root}/torch")
    base = ["-s", f"{root}/sfm", "-si", f"{root}/torch", "-i", f"{root}/torch"]
    assert jsfm.main(base + ["-o", f"{root}/scaled_jax"]) == 0
    assert tsfm.main(base + ["-o", f"{root}/scaled_torch"]) == 0
    for rel in ("meshlab_project.mlp", "colmap_model/cameras.txt", "colmap_model/images.txt",
                "colmap_model/points3D.txt"):
        with open(f"{root}/scaled_jax/{rel}") as a, open(f"{root}/scaled_torch/{rel}") as b:
            assert b.read() == a.read(), rel
    scale, _, count = tsfm.estimate_scale_and_poses(cio.read_model(f"{root}/sfm", read_points=True),
                                                   f"{root}/torch", 1)
    assert count == 60 and abs(scale - 2.0) < 1e-4
    m = read_meshlab_project(f"{root}/scaled_torch/meshlab_project.mlp")
    assert len(m) == 1
