"""Port vs JAX: the PointCloudCleaner CLI.

A seeded cloud with colours, normals and an extra property (a thin slab plus
1 % planted points above it) through ``point_cloud_cleaner.main([...,
"--device", "cpu"])`` and the JAX tool with the same filters: the
``X.inliers.ply`` and ``X.outliers.ply`` files must be byte-equal. Once below
the 200,000-point switch (the brute force on the device) and once above it
(the native host kNN, shared by both packages), with the ETH3D recipe's
second filter after a first one.
"""

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
from dataset_pipeline_tpu_torch.tools import point_cloud_cleaner as tcl

torch.set_num_threads(2)


def _write_cloud(path, n, seed):
    rng = np.random.RandomState(seed)
    s = np.sqrt(12.0 / n)
    pts = np.concatenate([rng.rand(n, 3) * np.asarray([4.0, 3.0, 0.002]),
                          rng.rand(n // 100, 3) * np.asarray([4.0, 3.0, 8 * s])
                          + np.asarray([0, 0, 4 * s])]).astype(np.float32)
    m = len(pts)
    normals = rng.randn(m, 3).astype(np.float32)
    colors = rng.randint(0, 256, (m, 3)).astype(np.uint8)
    write_ply(str(path), PointCloud(pts, normals, colors, None,
                                    {"intensity": rng.rand(m).astype(np.float32)}))


@pytest.mark.parametrize("n,filters", [(8000, ["30,1.15", "20,1.15"]),
                                       (220_000, ["24,1.15", "20,1.15"])],
                         ids=["device_bruteforce", "native_host_knn"])
def test_cleaner_plys_equal_jax_tool(tmp_path, n, filters):
    from dataset_pipeline_tpu.tools.point_cloud_cleaner import main as jax_main

    args = [x for f in filters for x in ("--filter", f)]
    for pkg in ("jax", "port"):
        _write_cloud(tmp_path / f"{pkg}.ply", n, seed=3)
    assert jax_main(["--in", str(tmp_path / "jax.ply"), *args]) == 0
    timings = {}
    assert tcl.main(["--in", str(tmp_path / "port.ply"), *args, "--device", "cpu"],
                    timings=timings) == 0
    assert ("knn_host" in timings) == (n > 200_000)
    for suffix in ("inliers", "outliers"):
        a = open(tmp_path / f"jax.{suffix}.ply", "rb").read()
        b = open(tmp_path / f"port.{suffix}.ply", "rb").read()
        assert a == b, suffix
    kept = open(tmp_path / "port.inliers.ply", "rb").read()
    assert len(kept) > 0.8 * len(open(tmp_path / "port.ply", "rb").read())


def test_out_prefix_and_no_filter(tmp_path):
    _write_cloud(tmp_path / "c.ply", 3000, seed=4)
    assert tcl.main(["--in", str(tmp_path / "c.ply"), "--out_prefix", str(tmp_path / "o"),
                     "--device", "cpu"]) == 0
    assert (open(tmp_path / "o.inliers.ply", "rb").read()
            == open(tmp_path / "c.ply", "rb").read())


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so --device cuda is valid")
    _write_cloud(tmp_path / "c.ply", 100, seed=5)
    with pytest.raises(RuntimeError, match="cuda"):
        tcl.main(["--in", str(tmp_path / "c.ply"), "--filter", "5,1.1"])
