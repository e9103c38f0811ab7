"""Port vs JAX: depth-map and cube-intrinsics I/O (``io/depthmap.py``).

Raw depth files and ``intrinsics.txt`` are compared byte for byte; a ``.gz``
file by its decompressed payload (the gzip header holds a time and a name).
Each side reads the other's files back.
"""

import gzip

import numpy as np
import torch

from dataset_pipeline_tpu.io import depthmap as jdm
from dataset_pipeline_tpu_torch.io import depthmap as tdm

torch.set_num_threads(2)


def _depth():
    rng = np.random.RandomState(0)
    d = rng.uniform(0.5, 20.0, (37, 53)).astype(np.float32)
    d[rng.rand(37, 53) < 0.3] = np.inf
    return d


def test_raw_depth_files_are_byte_equal(tmp_path):
    d = _depth()
    pj = jdm.write_depth_raw(str(tmp_path / "j.depth"), d)
    pt = tdm.write_depth_raw(str(tmp_path / "t.depth"), d)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_array_equal(tdm.read_depth_raw(pj, 37, 53), d)
    np.testing.assert_array_equal(jdm.read_depth_raw(pt, 37, 53), d)


def test_compressed_depth_payloads_are_equal(tmp_path):
    d = _depth()
    pj = jdm.write_depth_raw(str(tmp_path / "j.depth"), d, compress=True)
    pt = tdm.write_depth_raw(str(tmp_path / "t.depth"), d, compress=True)
    assert pt.endswith(".gz") and pj.endswith(".gz")
    with gzip.open(pj, "rb") as a, gzip.open(pt, "rb") as b:
        assert b.read() == a.read()
    np.testing.assert_array_equal(tdm.read_depth_raw(pj, 37, 53), d)
    np.testing.assert_array_equal(jdm.read_depth_raw(pt, 37, 53), d)


def test_cube_intrinsics_files_are_byte_equal(tmp_path):
    args = (2048, 1024, 1024, 1023.5, 1024, 511.25)
    jdm.write_cube_intrinsics(str(tmp_path / "j.txt"), *args)
    tdm.write_cube_intrinsics(str(tmp_path / "t.txt"), *args)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tdm.read_cube_intrinsics(str(tmp_path / "j.txt")) == jdm.read_cube_intrinsics(
        str(tmp_path / "t.txt"))


def test_wrong_size_raises(tmp_path):
    p = tdm.write_depth_raw(str(tmp_path / "t.depth"), _depth())
    try:
        tdm.read_depth_raw(p, 10, 10)
    except ValueError as e:
        assert "expected 100 floats" in str(e)
    else:
        raise AssertionError("no error on a wrong size")
