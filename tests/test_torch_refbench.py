"""Port vs JAX: the C++ reference baselines (``refbench.py``, ``csrc/ref_*.cc``).

The port's three sources are byte-equal copies of the JAX package's
``native/ref_*.cc`` and are built with the same flags, so on the same small
inputs every output equals the JAX package's exactly: ICP H, b, cost; the
photometric loop's observation count; a cube face's depth and colour; a GT
frame's depth. The tests skip only when there is no C++ compiler, as
``tests/test_ref_baseline.py`` does.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from dataset_pipeline_tpu.native import refbench as jref
from dataset_pipeline_tpu_torch import refbench as tref

REPO = Path(__file__).resolve().parent.parent


def _both(name, *args, **kw):
    got, want = getattr(tref, name)(*args, **kw), getattr(jref, name)(*args, **kw)
    if got is None or want is None:
        pytest.skip("no C++ compiler available")
    return got, want


@pytest.mark.parametrize("name", ["icp_loop", "photo_loop", "render_loops"])
def test_sources_are_byte_equal_to_the_jax_package_s(name):
    assert (tref.SOURCES[name].read_bytes()
            == (REPO / "dataset_pipeline_tpu" / "native" / f"ref_{name}.cc").read_bytes())
    assert tref.REF_FLAGS == jref.REF_FLAGS == ["-O2", "-msse2", "-msse3"]


def test_ref_icp_inner_matches_jax():
    rng = np.random.RandomState(0)
    M = 20_000
    ps = rng.randn(M, 3).astype(np.float32)
    ns = rng.randn(M, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    pt = ps + 0.01 * rng.randn(M, 3).astype(np.float32)
    nt = rng.randn(M, 3).astype(np.float32)
    nt /= np.linalg.norm(nt, axis=1, keepdims=True)
    R = np.stack([np.eye(3), np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]])]).astype(np.float32)
    t = rng.randn(2, 3).astype(np.float32)
    got, want = _both("ref_icp_inner", ps, ns, pt, nt, R, t, iters=2)
    assert got[0] > 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3] > 0


def test_ref_photo_inner_matches_jax():
    from dataset_pipeline_tpu_torch.tools.bench import ref_photo_inputs

    args = ref_photo_inputs(n_points=20_000, W=384, H=256)
    got, want = _both("ref_photo_inner", *args, iters=2)
    assert got[0] > 0
    assert got[1] == want[1] > 0


def test_ref_render_loops_match_jax():
    from dataset_pipeline_tpu_torch.tools.bench import _cube_cloud, gt_depth_points

    pos, cols = _cube_cloud(50_000)
    (d, c), (jd, jc) = _both("ref_cubemap_face", pos, cols, np.eye(3), 64.0, 64.0, 64.0, 64.0,
                             128, 128)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(c, jc)
    assert np.isfinite(d).any() and c.any()

    pts = gt_depth_points(50_000)
    obs = np.random.RandomState(1).randint(0, 4, len(pts)).astype(np.int32)
    occl = np.full((96, 128), 8.0, np.float32)
    T = np.hstack([np.eye(3), np.asarray([[0.1], [0.0], [0.0]])])
    got, want = _both("ref_gt_depth_frame", pts, obs, T, 60.0, 60.0, 63.5, 47.5, 128, 96, occl)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


def test_no_compiler_gives_none(monkeypatch, tmp_path):
    """Without g++ (a fresh build directory, the compiler not found) every
    function returns None, as the JAX package's do."""
    def missing(*a, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tref, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(tref, "_libs", {})
    monkeypatch.setattr(subprocess, "run", missing)
    z3 = np.zeros((4, 3), np.float32)
    assert tref.ref_icp_inner(z3, z3, z3, z3) is None
    assert tref.ref_cubemap_face(z3, z3.astype(np.uint8), np.eye(3), 1.0, 1.0, 1.0, 1.0, 4, 4) is None
    assert tref.ref_gt_depth_frame(z3, np.zeros(4, np.int32), np.eye(3, 4), 1.0, 1.0, 1.0, 1.0,
                                   4, 4, np.zeros((4, 4), np.float32)) is None
    assert not list(tmp_path.rglob("*.so"))
