"""Port vs JAX: the triangle-mesh rasterizer (``ops/mesh_raster.py``).

The cases of ``tests/test_mesh_raster.py`` (planar, slanted, distorted, all
camera models, occlusion-boundary masking, colour, batch), each rendered by
the JAX function and by the port on the same vertices, plus a colour case on
coplanar duplicate faces (the last-writer rule). Depths and colours are
compared exactly: the port writes the barycentrics and depths as the fused
multiply-adds XLA's CPU backend makes of them, so pixel coverage and values
agree bit for bit. Vertices come from the JAX ``unproject`` so both sides
start from the same float32 inputs.

Known differences, listed in ``KNOWN_DIFFS`` and held to those counts: with a
distortion model the vertex pixels differ in the last bits. JAX projects the
vertices op by op (outside ``jit``), where ``sum(xy * xy)`` rounds both
squares; the port's camera model evaluates the squared radius as one fused
multiply-add (the ``jit`` form its registrator needs). Then a pixel on a
triangle edge can flip between covered and not, and a covered pixel's depth
can differ by an ulp (held to 2 ulps). Undistorted cameras agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.models import cameras as jcm
from dataset_pipeline_tpu.models.lie import SE3 as JSE3
from dataset_pipeline_tpu.ops import mesh_raster as jmr
from dataset_pipeline_tpu_torch.models import cameras as tcm
from dataset_pipeline_tpu_torch.models.lie import SE3 as TSE3
from dataset_pipeline_tpu_torch.ops import mesh_raster as tmr
from test_cameras import MODEL_PARAMS

torch.set_num_threads(2)
PIN = [50.0, 50.0, 31.5, 23.5]


def _cams(model, w, h, params, scale=None):
    jc = jcm.make_camera(model, w, h, params)
    tc = tcm.make_camera(model, w, h, params, device="cpu")
    if scale is not None:
        jc, tc = jcm.scaled_by(jc, scale), tcm.scaled_by(tc, scale)
    # identical cutoffs on both sides: the test is about the raster
    return jc, tc.__class__(tc.model, tc.width, tc.height, tc.params,
                            torch.tensor(float(jc.radius_cutoff_sq)))


def _grid_mesh_on_rays(jc, step, depth_fn):
    xs = np.arange(0, jc.width, step)
    ys = np.arange(0, jc.height, step)
    nx, ny = len(xs), len(ys)
    gx, gy = np.meshgrid(xs, ys)
    pix = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], -1), jnp.float32)
    depths = np.asarray([depth_fn(x, y) for y in ys for x in xs], np.float32)
    pts = np.asarray(jcm.unproject(jc, pix, jnp.asarray(depths)))
    faces = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            v = j * nx + i
            faces.append([v, v + 1, v + nx])
            faces.append([v + 1, v + nx + 1, v + nx])
    return pts, np.asarray(faces, np.int32)


# (coverage flips, depth differences of 1-2 ulps) per distorted case, 64x48
KNOWN_DIFFS = {
    "distorted": (0, 1),
    "FISHEYE_POLYNOMIAL_2_TANGENTIAL_2": (3, 17),
    "FOV": (2, 17),
    "FULL_OPENCV": (0, 2),
    "OPENCV_FISHEYE": (0, 9),
    "RADIAL_FISHEYE": (0, 14),
    "SIMPLE_RADIAL": (0, 4),
    "SIMPLE_RADIAL_FISHEYE": (0, 11),
    "THIN_PRISM_FISHEYE": (0, 12),
}


def _assert_depths(td, jd, case):
    flips_max, ulps_max = KNOWN_DIFFS.get(case, (0, 0))
    flips = (td > 0) != (jd > 0)
    both = (td > 0) & (jd > 0)
    assert flips.sum() <= flips_max, (case, int(flips.sum()))
    np.testing.assert_allclose(td[both], jd[both], rtol=2.4e-7, atol=0)
    assert (td[both] != jd[both]).sum() <= ulps_max, (case, int((td[both] != jd[both]).sum()))
    np.testing.assert_array_equal(td[~flips & ~both], jd[~flips & ~both])


def _both_depths(jc, tc, pts, faces, q=None, t=None, **kw):
    q = np.asarray([1.0, 0, 0, 0], np.float32) if q is None else np.asarray(q, np.float32)
    t = np.zeros(3, np.float32) if t is None else np.asarray(t, np.float32)
    jd = np.asarray(jmr.render_occlusion_mesh_depth(
        jc, JSE3(jnp.asarray(q), jnp.asarray(t)), jmr.build_occlusion_mesh(pts, faces), **kw))
    td = tmr.render_occlusion_mesh_depth(
        tc, TSE3(torch.from_numpy(q), torch.from_numpy(t)),
        tmr.build_occlusion_mesh(pts, faces, device="cpu"), **kw).numpy()
    return jd, td


def test_build_occlusion_mesh_matches_jax():
    rng = np.random.RandomState(4)
    jc, _ = _cams("PINHOLE", 64, 48, PIN)
    pts, faces = _grid_mesh_on_rays(jc, 4, lambda x, y: 2.0 + 0.01 * x)
    # a non-manifold fin and a duplicate face
    extra = np.asarray([[0, 1, len(pts)], [0, 1, 16]], np.int32)
    pts = np.concatenate([pts, rng.randn(1, 3).astype(np.float32)])
    faces = np.concatenate([faces, extra])
    jm = jmr.build_occlusion_mesh(pts, faces)
    tm = tmr.build_occlusion_mesh(pts, faces, device="cpu")
    for name in jm._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["planar", "slanted", "distorted"])
def test_mesh_depth_matches_jax(case):
    if case == "distorted":
        jc, tc = _cams("SIMPLE_RADIAL", 64, 48, [50.0, 31.5, 23.5, 0.08])
        pts, faces = _grid_mesh_on_rays(jc, 2, lambda x, y: 1.5)
    else:
        jc, tc = _cams("PINHOLE", 64, 48, PIN)
        fn = (lambda x, y: 2.0) if case == "planar" else (lambda x, y: 2.0 + 0.01 * x)
        pts, faces = _grid_mesh_on_rays(jc, 4, fn)
    jd, td = _both_depths(jc, tc, pts, faces, edge_splats=False)
    _assert_depths(td, jd, case)
    assert (jd[5:-5, 5:-5] > 0).mean() > 0.9


@pytest.mark.parametrize("model", sorted(MODEL_PARAMS))
def test_all_camera_models_match_jax(model):
    jc, tc = _cams(model, 640, 480, MODEL_PARAMS[model], scale=0.1)
    pts, faces = _grid_mesh_on_rays(jc, 4, lambda x, y: 1.5)
    jd, td = _both_depths(jc, tc, pts, faces, edge_splats=False)
    _assert_depths(td, jd, model)
    assert (jd[8:-8, 8:-8] > 0).mean() > 0.8


def _occluder_scene():
    jc, tc = _cams("PINHOLE", 64, 48, PIN)
    pts_bg, faces_bg = _grid_mesh_on_rays(jc, 4, lambda x, y: 3.0)
    gx, gy = np.meshgrid(np.linspace(-0.8, 0.0, 9), np.linspace(-0.5, 0.5, 9))
    pts_fg = np.stack([gx.ravel() * 1.5, gy.ravel() * 1.5, np.full(gx.size, 1.5)],
                      -1).astype(np.float32)
    faces_fg = [[j * 9 + i, j * 9 + i + 1, j * 9 + i + 9] for j in range(8) for i in range(8)]
    faces_fg += [[j * 9 + i + 1, j * 9 + i + 10, j * 9 + i + 9] for j in range(8) for i in range(8)]
    pts = np.concatenate([pts_bg, pts_fg])
    faces = np.concatenate([faces_bg, np.asarray(faces_fg, np.int32) + len(pts_bg)])
    return jc, tc, pts, faces


@pytest.mark.parametrize("pose", ["identity", "moved"])
def test_occlusion_boundary_masking_matches_jax(pose):
    jc, tc, pts, faces = _occluder_scene()
    q, t = (None, None) if pose == "identity" else ([0.9999, 0.01, -0.008, 0.005], [0.03, -0.02, 0.1])
    if q is not None:
        q = np.asarray(q) / np.linalg.norm(q)
    jd, td = _both_depths(jc, tc, pts, faces, q, t, splat_radius=0.03, edge_splats=True)
    np.testing.assert_array_equal(td, jd)
    assert (jd == -1.0).sum() > 20


def test_boundary_edges_always_splat_matches_jax():
    jc, tc = _cams("PINHOLE", 64, 48, PIN)
    pts = np.asarray([[-0.2, -0.2, 1.0], [0.2, -0.2, 1.0], [0.0, 0.2, 1.0]], np.float32)
    faces = np.asarray([[0, 1, 2]], np.int32)
    jd, td = _both_depths(jc, tc, pts, faces, splat_radius=0.05, edge_splats=True)
    np.testing.assert_array_equal(td, jd)
    assert (jd == -1.0).any()


def _color_both(jc, tc, pts, faces, cols):
    jd, jcol = jmr.render_mesh_depth_color(jc, JSE3.identity(), jmr.build_occlusion_mesh(pts, faces),
                                           cols)
    td, tcol = tmr.render_mesh_depth_color(tc, TSE3.identity(), tmr.build_occlusion_mesh(
        pts, faces, device="cpu"), torch.from_numpy(cols))
    return np.asarray(jd), np.asarray(jcol), td.numpy(), tcol.numpy()


def test_mesh_color_matches_jax():
    jc, tc = _cams("PINHOLE", 64, 48, PIN)
    pts, faces = _grid_mesh_on_rays(jc, 4, lambda x, y: 2.0)
    cols = np.stack([pts[:, 0] * 10 + 100, pts[:, 1] * 10 + 100,
                     np.full(len(pts), 55.0)], -1).astype(np.float32)
    jd, jcol, td, tcol = _color_both(jc, tc, pts, faces, cols)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tcol, jcol)
    assert (jcol[5:-5, 5:-5, 2] == np.float32(55.0)).mean() > 0.9


def test_mesh_color_coplanar_duplicates_last_writer():
    """Three copies of each face, each copy its own colour, plus a slanted
    mesh in the 32-pixel tier: every pixel takes the last write in (tier,
    pixel offset, face) order, as the JAX CPU scatter does."""
    jc, tc = _cams("PINHOLE", 64, 48, PIN)
    pts, faces = _grid_mesh_on_rays(jc, 4, lambda x, y: 2.0)
    big, big_faces = _grid_mesh_on_rays(jc, 16, lambda x, y: 2.5 + 0.02 * y)
    n = len(pts)
    all_pts = np.concatenate([pts, pts, pts, big])
    all_faces = np.concatenate([faces, faces + n, faces + 2 * n, big_faces + 3 * n])
    rng = np.random.RandomState(7)
    cols = rng.uniform(0, 255, (len(all_pts), 3)).astype(np.float32)
    jd, jcol, td, tcol = _color_both(jc, tc, all_pts, all_faces, cols)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tcol, jcol)
    covered = jd > 0
    assert covered.mean() > 0.85
    # the winner is not the first copy: colours of copy 2 or 3 show
    assert (tcol[covered] != 0).all(-1).mean() > 0.9


def test_mesh_depth_batch_matches_jax():
    jc, tc = _cams("PINHOLE", 64, 48, PIN)
    pts, faces = _grid_mesh_on_rays(jc, 4, lambda x, y: 2.0 + 0.01 * x)
    rng = np.random.RandomState(3)
    qs = np.stack([np.r_[1.0, 0.01 * rng.randn(3)] for _ in range(3)])
    qs = (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(np.float32)
    ts = (0.02 * rng.randn(3, 3)).astype(np.float32)
    jb = np.asarray(jmr.render_occlusion_mesh_depth_batch(
        jc, jnp.asarray(qs), jnp.asarray(ts), jmr.build_occlusion_mesh(pts, faces),
        splat_radius=0.01))
    tb = tmr.render_occlusion_mesh_depth_batch(
        tc, torch.from_numpy(qs), torch.from_numpy(ts),
        tmr.build_occlusion_mesh(pts, faces, device="cpu"), splat_radius=0.01).numpy()
    np.testing.assert_array_equal(tb, jb)
