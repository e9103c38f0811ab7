"""Port vs JAX: the point and splat renderers and the fills (``ops/splat.py``).

``render_splats_depth``, ``render_points_depth`` and
``render_points_depth_color`` for a batch of images against the JAX
functions one image at a time; ``zbuffer_min`` (with ``aux`` on exact
z-ties: the lowest point index wins) against the JAX scatter path;
``fill_depth_holes`` at every valid-neighbour count, ``fill_color_from_depth``
and ``flood_fill_colors`` (with a face that has no seed) on a batch of faces.
Everything is compared exactly: the pixel and tier of a point come from the
same float32 expressions, a min is exact whatever the order of the writes,
the medians pick neighbour values, and colour means sum at most eight
integers.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.ops import splat as jsplat
from dataset_pipeline_tpu_torch.ops import splat as tsplat

torch.set_num_threads(2)


def test_zbuffer_min_matches_jax():
    rng = np.random.RandomState(1)
    n_px = 5000
    flat = rng.randint(-20, n_px + 20, 4000).astype(np.int32)
    z = rng.rand(4000).astype(np.float32)
    ref = np.asarray(jsplat.zbuffer_min(jnp.asarray(flat), jnp.asarray(z), n_px, use_sorted=False))
    got = tsplat.zbuffer_min(torch.from_numpy(flat).long(), torch.from_numpy(z), n_px).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.isinf(got).any() and np.isfinite(got).sum() > 2000


def _camera(model, W, H, params):
    from dataset_pipeline_tpu_torch.models import cameras as cm

    return cm.make_camera(model, W, H, params, device="cpu")


@pytest.mark.parametrize("max_radius_px", [1, 3])
@pytest.mark.parametrize("camera", ["PINHOLE", "SIMPLE_PINHOLE", "OPENCV"])
def test_render_splats_depth_matches_jax(max_radius_px, camera):
    """A camera without a lens (PINHOLE, SIMPLE_PINHOLE, OPENCV with zero
    distortion) gives the JAX function's pinhole centres of its focals and
    principal point, bit for bit."""
    rng = np.random.RandomState(2 + max_radius_px)
    W, H, f, cx, cy = 96, 72, 80.0, 47.5, 35.5
    n = 3000
    xy = rng.uniform(-1.5, 1.5, (n, 2))
    z = rng.uniform(-0.2, 3.0, n)  # some behind the camera
    pts = np.concatenate([xy * np.abs(z)[:, None], z[:, None]], 1).astype(np.float32)
    radii = rng.uniform(0.0, 0.08, n).astype(np.float32)
    batch = np.stack([pts, pts[::-1] * np.float32(1.1)])
    params = {"PINHOLE": [f, f + 1.0, cx, cy], "SIMPLE_PINHOLE": [f, cx, cy],
              "OPENCV": [f, f + 1.0, cx, cy, 0.0, 0.0, 0.0, 0.0]}[camera]
    cam = _camera(camera, W, H, params)
    assert not cam.lens
    got = tsplat.render_splats_depth(torch.from_numpy(batch), torch.from_numpy(radii), cam,
                                     max_radius_px=max_radius_px).numpy()
    assert got.shape == (2, H, W)
    fy = f if camera == "SIMPLE_PINHOLE" else f + 1.0
    for b in range(2):
        ref = np.asarray(jsplat.render_splats_depth(jnp.asarray(batch[b]), jnp.asarray(radii),
                                                    W, H, f, fy, cx, cy,
                                                    max_radius_px=max_radius_px))
        np.testing.assert_array_equal(got[b], ref)
        assert np.isfinite(ref).mean() > 0.3


LENS_PARAMS = {
    "THIN_PRISM_FISHEYE": [80.0, 81.0, 47.5, 35.5, 0.28, 0.09, 2e-4, -3e-4, 2e-3, 1e-3, 4e-4, -2e-4],
    "OPENCV": [80.0, 81.0, 47.5, 35.5, -0.12, 0.03, 1e-3, -5e-4],
}


def _splats_by_loop(cam, p_cam, radius, R):
    """The splat depth of one image, point by point: each point that
    ``cameras.project`` marks valid paints the (2k+1)^2 square around the
    pixel holding its projection, k = ceil(clamp(f radius / z, 0, R))."""
    from dataset_pipeline_tpu_torch.models import cameras as cm

    W, H = cam.width, cam.height
    out = np.full((H, W), np.inf, np.float32)
    f = 0.5 * (cam.fx + cam.fy)
    for p in p_cam:
        pix, ok = cm.project(cam, p)
        if not bool(ok):
            continue
        z = p[2]
        k = int(torch.ceil(torch.clamp(f * radius / z, 0.0, float(R))))
        jx, jy = int(torch.floor(pix[0])), int(torch.floor(pix[1]))
        y0, y1, x0, x1 = max(jy - k, 0), min(jy + k + 1, H), max(jx - k, 0), min(jx + k + 1, W)
        if y0 < y1 and x0 < x1:
            out[y0:y1, x0:x1] = np.minimum(out[y0:y1, x0:x1], float(z))
    return out


@pytest.mark.parametrize("model", sorted(LENS_PARAMS))
@pytest.mark.parametrize("via", ["render_splats_depth", "ground_truth_creator"])
def test_splats_follow_the_lens(model, via):
    """Under a camera with a lens, each splat sits at ``cameras.project``'s
    pixel and the points it marks invalid paint nothing (behind the camera,
    beyond the radius cutoff): as a plain loop over the points, exactly; the
    GroundTruthCreator's splat occlusion passes its camera through."""
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.tools import ground_truth_creator as gtc

    rng = np.random.RandomState(9)
    W, H, R, radius = 96, 72, 3, 0.05
    cam = _camera(model, W, H, LENS_PARAMS[model])
    n = 2500
    xy = rng.uniform(-1.6, 1.6, (n, 2))
    z = np.where(rng.rand(n) < 0.1, -rng.uniform(0.1, 0.3, n), rng.uniform(0.06, 4.0, n))
    pts = torch.from_numpy(np.concatenate([xy * np.abs(z)[:, None], z[:, None]], 1)
                           .astype(np.float32))
    if via == "render_splats_depth":
        radii = torch.full((n,), radius)
        got = tsplat.render_splats_depth(pts[None], radii, cam, max_radius_px=R)[0]
    else:
        got = gtc.render_occlusion_depth(cam, SE3.identity(device="cpu"), pts, radius,
                                         max_radius_px=R)
    want = _splats_by_loop(cam, pts, radius, R)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cam.lens
    pinhole = tsplat.render_splats_depth(pts[None], torch.full((n,), radius),
                                         dataclasses.replace(cam, lens=False),
                                         max_radius_px=R)[0].numpy()
    assert np.isfinite(want).mean() > 0.5 and (pinhole != want).mean() > 0.05


@pytest.mark.parametrize("model,params,lens", [
    ("PINHOLE", [80.0, 81.0, 47.5, 35.5], False),
    ("OPENCV", [80.0, 81.0, 47.5, 35.5, 0.0, 0.0, 0.0, 0.0], False),
    ("OPENCV", [80.0, 81.0, 47.5, 35.5, 0.0, 0.0, 1e-4, 0.0], True),
    ("OPENCV_FISHEYE", [80.0, 81.0, 47.5, 35.5, 0.0, 0.0, 0.0, 0.0], True),
    ("FOV", [80.0, 81.0, 47.5, 35.5, 0.0], True),
])
def test_the_lens_is_decided_when_the_camera_is_made(model, params, lens):
    """``Camera.lens``: a pre-warp or the FOV model always, a polynomial
    distortion where a coefficient is nonzero; new parameters keep it."""
    cam = _camera(model, 96, 72, params)
    assert cam.lens is lens
    assert cam.with_params(cam.params * 1.5).lens is lens


def test_zbuffer_min_aux_lowest_index_on_ties_matches_jax():
    rng = np.random.RandomState(4)
    n_px, n = 300, 5000
    flat = rng.randint(-10, n_px + 10, n).astype(np.int32)
    z = rng.randint(0, 4, n).astype(np.float32)  # many exact z-ties per pixel
    aux = rng.randint(0, 1 << 24, n).astype(np.int32)
    jd, ja = (np.asarray(a) for a in jsplat.zbuffer_min(jnp.asarray(flat), jnp.asarray(z), n_px,
                                                        aux=jnp.asarray(aux), use_sorted=False))
    td, ta = tsplat.zbuffer_min(torch.from_numpy(flat), torch.from_numpy(z), n_px,
                                aux=torch.from_numpy(aux))
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(ta.numpy(), ja)
    # the winner of a tie is the lowest point index
    px = int(np.bincount(flat[(flat >= 0) & (flat < n_px)]).argmax())
    at = np.nonzero((flat == px) & (z == jd[px]))[0]
    assert len(at) > 1 and ta.numpy()[px] == aux[at[0]]


def _points_cam(seed, n):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-1.2, 1.2, (n, 2))
    z = rng.uniform(-0.2, 3.0, n)
    return np.concatenate([xy * np.abs(z)[:, None], z[:, None]], 1).astype(np.float32)


def test_render_points_depth_and_color_match_jax():
    W, H, f, c = 64, 48, 30.0, 31.0
    pts = np.stack([_points_cam(6, 4000), _points_cam(7, 4000)])
    cols = np.random.RandomState(8).randint(0, 256, (4000, 3)).astype(np.uint8)
    td = tsplat.render_points_depth(torch.from_numpy(pts), W, H, f, f + 1.0, c, c - 2).numpy()
    tdc, tcol = tsplat.render_points_depth_color(torch.from_numpy(pts), torch.from_numpy(cols),
                                                 W, H, f, f + 1.0, c, c - 2)
    for b in range(2):
        jd = np.asarray(jsplat.render_points_depth(jnp.asarray(pts[b]), W, H, f, f + 1.0, c, c - 2))
        jdc, jcol = jsplat.render_points_depth_color(jnp.asarray(pts[b]), jnp.asarray(cols),
                                                     W, H, f, f + 1.0, c, c - 2)
        np.testing.assert_array_equal(td[b], jd)
        np.testing.assert_array_equal(tdc[b].numpy(), np.asarray(jdc))
        np.testing.assert_array_equal(tcol[b].numpy(), np.asarray(jcol))
        assert 0.3 < np.isfinite(jd).mean() < 1.0


def test_fill_depth_holes_every_count_branch_matches_jax():
    rng = np.random.RandomState(9)
    H, W = 40, 50
    # rows of increasing hole density, so each valid-neighbour count from 0
    # to 8 occurs many times (count <= 1, == 2, <= 4, <= 6, > 6)
    density = np.linspace(0.05, 0.95, H)[:, None]
    depth = rng.uniform(1.0, 5.0, (3, H, W)).astype(np.float32)
    depth[rng.rand(3, H, W) < density] = np.inf
    depth[0, 10:13, 10:13] = np.inf  # a hole whose centre has 0 valid neighbours
    got = tsplat.fill_depth_holes(torch.from_numpy(depth)).numpy()
    nb = sum(np.isfinite(np.pad(depth, ((0, 0), (1, 1), (1, 1)), constant_values=np.inf)
                         [:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx)
    holes = ~np.isfinite(depth)
    assert all((holes & (nb == k)).sum() >= 3 for k in range(9))
    for b in range(3):
        np.testing.assert_array_equal(got[b], np.asarray(jsplat.fill_depth_holes(jnp.asarray(depth[b]))))


def test_color_fills_match_jax():
    rng = np.random.RandomState(10)
    H, W = 36, 44
    depth = rng.uniform(1.0, 5.0, (2, H, W)).astype(np.float32)
    depth[rng.rand(2, H, W) < 0.8] = np.inf
    depth[1] = np.inf  # a face with no seed: the flood fill never fills it
    color = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    color[~np.isfinite(depth)] = 0
    tcf, tv = tsplat.fill_color_from_depth(torch.from_numpy(depth), torch.from_numpy(color))
    stats = {}
    tff = tsplat.flood_fill_colors(tcf, tv, stats=stats).numpy()
    for b in range(2):
        jcf, jv = jsplat.fill_color_from_depth(jnp.asarray(depth[b]), jnp.asarray(color[b]))
        np.testing.assert_array_equal(tcf[b].numpy(), np.asarray(jcf))
        np.testing.assert_array_equal(tv[b].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tff[b], np.asarray(jsplat.flood_fill_colors(jcf, jv)))
    assert (tff[0].max(-1) > 0).all() and (tff[1] == 0).all()
    assert stats["flood_fill_steps"] >= 2


@pytest.fixture
def check_every(monkeypatch):
    def set_(k):
        monkeypatch.setattr(tsplat, "FLOOD_CHECK_EVERY", k)
    return set_


def test_flood_fill_check_interval_does_not_change_the_result(check_every):
    rng = np.random.RandomState(11)
    color = rng.randint(1, 256, (1, 30, 30, 3)).astype(np.uint8)
    valid = np.zeros((1, 30, 30), bool)
    valid[0, 3, 5] = valid[0, 25, 20] = True
    outs = []
    for k in (1, 3, 8, 64):
        check_every(k)
        outs.append(tsplat.flood_fill_colors(torch.from_numpy(color), torch.from_numpy(valid)).numpy())
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_cube_face_tables_match_jax():
    assert tsplat.CUBE_FACE_NAMES == jsplat.CUBE_FACE_NAMES
    np.testing.assert_array_equal(tsplat.CUBE_FACE_ROTATIONS, jsplat.CUBE_FACE_ROTATIONS)
