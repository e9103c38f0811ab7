"""Port vs JAX: the forward path of the 14 COLMAP camera models.

``project`` (pixels and validity), ``in_image``, ``scaled_by`` and the radius
cutoff of ``make_camera`` / ``init_cutoff`` on seeded points. Tolerances:

- pixels: 1e-4 px absolute plus 1e-6 relative (float32 over a ~1e3 px range
  is ~6e-5 px per ulp; the two libraries order a few products differently);
- ``radius_cutoff_sq``: 2e-3 relative. The multi-start undistortion includes
  starts that never converge and wander chaotically; which of them land
  within 1e-6 of a root depends on last bits (torch's ``linspace`` rounds
  the border samples differently from ``jnp.linspace``). Measured gap:
  7.8e-4 on the strong SIMPLE_RADIAL case, 0 on the others;
- validity: identical, except for points whose warped radius lies between
  the two cutoffs (widened by 1e-4 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.models import cameras as jcm
from dataset_pipeline_tpu_torch.models import cameras as tcm

torch.set_num_threads(2)
W, H = 640, 480
PIX_ATOL, PIX_RTOL = 1e-4, 1e-6
CUTOFF_RTOL = 2e-3

MILD = {
    "PINHOLE": [340.0, 341.0, 320.0, 240.5],
    "SIMPLE_PINHOLE": [340.0, 320.0, 240.5],
    "POLYNOMIAL_3": [340.0, 341.0, 320.0, 240.5, 0.05, -0.02, 0.002],
    "POLYNOMIAL_4": [340.0, 341.0, 320.0, 240.5, 0.05, -0.02, 0.002, -0.0001],
    "OPENCV": [340.0, 341.0, 320.0, 240.5, 0.05, -0.02, 0.001, -0.0005],
    "FULL_OPENCV": [340.0, 341.0, 320.0, 240.5, 0.05, -0.02, 0.001, -0.0005, 0.002, 0.01,
                    -0.005, 0.001],
    "OPENCV_FISHEYE": [340.0, 341.0, 320.0, 240.5, 0.05, -0.02, 0.002, -0.0001],
    "FISHEYE_POLYNOMIAL_2_TANGENTIAL_2": [340.0, 341.0, 320.0, 240.5, 0.05, -0.02, 0.001,
                                          -0.0005],
    "FOV": [340.0, 341.0, 320.0, 240.5, 0.9],
    "RADIAL": [340.0, 320.0, 240.5, 0.05, -0.02],
    "SIMPLE_RADIAL": [340.0, 320.0, 240.5, 0.05],
    "RADIAL_FISHEYE": [340.0, 320.0, 240.5, 0.05, -0.02],
    "SIMPLE_RADIAL_FISHEYE": [340.0, 320.0, 240.5, 0.05],
    "THIN_PRISM_FISHEYE": [340.0, 341.0, 320.0, 240.5, 0.05, -0.02, 0.001, -0.0005, 0.002,
                           -0.0001, 0.0005, -0.0002],
}
# barrel distortions strong enough that the projection folds inside the
# sampled range, so the cutoff is finite and decides validity
STRONG = {
    "SIMPLE_RADIAL": [300.0, 320.0, 240.5, -0.12],
    "RADIAL": [300.0, 320.0, 240.5, -0.1, 0.004],
    "OPENCV": [300.0, 301.0, 320.0, 240.5, -0.12, 0.005, 0.001, -0.0005],
    "POLYNOMIAL_3": [300.0, 301.0, 320.0, 240.5, -0.12, 0.004, 0.0001],
}
CASES = [(m, "mild", p) for m, p in sorted(MILD.items())] + \
        [(m, "strong", p) for m, p in sorted(STRONG.items())]


def test_registry_matches():
    assert set(MILD) == set(jcm.CAMERA_MODELS) == set(tcm.CAMERA_MODELS)
    for name, spec in jcm.CAMERA_MODELS.items():
        t = tcm.CAMERA_MODELS[name]
        assert (t.param_count, t.unique_focal, t.fisheye) == (
            spec.param_count, spec.unique_focal, spec.fisheye)


def _points(seed, n=4000):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-2.0, 2.0, (n, 2))
    z = rng.uniform(-0.3, 3.0, n)
    z[:20] = 0.0  # on the camera plane
    return np.concatenate([xy * np.abs(z)[:, None], z[:, None]], 1).astype(np.float32)


@pytest.mark.parametrize("model,kind,params", CASES)
def test_project_and_cutoff_match_jax(model, kind, params):
    jc = jcm.make_camera(model, W, H, params)
    tc = tcm.make_camera(model, W, H, params, device="cpu")
    jcut, tcut = float(jc.radius_cutoff_sq), float(tc.radius_cutoff_sq)
    if np.isinf(jcut):
        assert np.isinf(tcut)
    else:
        np.testing.assert_allclose(tcut, jcut, rtol=CUTOFF_RTOL)
    if kind == "strong":
        assert np.isfinite(jcut)  # the case exercises a finite cutoff

    pts = _points(sum(map(ord, model)))
    jpix, jok = (np.asarray(a) for a in jcm.project(jc, jnp.asarray(pts)))
    tpix, tok = (a.numpy() for a in tcm.project(tc, torch.from_numpy(pts)))
    # the warped radius decides the cutoff: skip points right at it
    n = pts[:, :2] / np.where(np.abs(pts[:, 2:]) < 1e-6, 1e-6, pts[:, 2:])
    r = np.linalg.norm(n, axis=1)
    wr2 = (np.arctan(r) ** 2) if tcm.CAMERA_MODELS[model].fisheye else r * r
    lo, hi = min(jcut, tcut) * (1 - 1e-4), max(jcut, tcut) * (1 + 1e-4)
    near = np.isfinite(jcut) & (wr2 >= lo) & (wr2 <= hi)
    np.testing.assert_array_equal(tok[~near], jok[~near])
    both = jok & tok
    assert both.sum() > 500
    np.testing.assert_allclose(tpix[both], jpix[both], rtol=PIX_RTOL, atol=PIX_ATOL)

    jin = np.asarray(jcm.in_image(jc, jnp.asarray(jpix[both]), border=1.0))
    tin = tcm.in_image(tc, torch.from_numpy(jpix[both]), border=1.0).numpy()
    np.testing.assert_array_equal(tin, jin)


@pytest.mark.parametrize("model", sorted(MILD))
def test_scaled_by_matches_jax(model):
    jc = jcm.make_camera(model, W, H, MILD[model], cutoff=False)
    tc = tcm.make_camera(model, W, H, MILD[model], cutoff=False, device="cpu")
    for factor in (0.5, 0.25, 0.125):
        js, ts = jcm.scaled_by(jc, factor), tcm.scaled_by(tc, factor)
        assert (ts.width, ts.height) == (js.width, js.height)
        np.testing.assert_array_equal(ts.params.numpy(), np.asarray(js.params))


def test_project_differentiates_through_params():
    """jacfwd through ``with_params`` agrees with JAX's jacfwd."""
    import jax

    model, params = "OPENCV", MILD["OPENCV"]
    jc = jcm.make_camera(model, W, H, params)
    tc = tcm.make_camera(model, W, H, params, device="cpu")
    pts = _points(5, 200)
    pts = pts[pts[:, 2] > 0.5]
    jj = np.asarray(jax.jacfwd(lambda p: jcm.project(jc.with_params(p), jnp.asarray(pts))[0])(
        jc.params))
    tj = torch.func.jacfwd(lambda p: tcm.project(tc.with_params(p), torch.from_numpy(pts))[0])(
        tc.params).numpy()
    np.testing.assert_allclose(tj, jj, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# The inverse half: undistortion, unprojection, the lookup table, Jacobians.
# Tolerances: normalized coordinates 2e-6 absolute (the 100-step Gauss-Newton
# stops per point at a residual of 1e-10 squared; either side may stop one
# step apart); the round trips those of ``tests/test_cameras.py``: pixels
# 2e-2 px, normalized coordinates 1e-4 (held here at 1e-5); Jacobians 1e-5
# relative + 1e-3 absolute (forward-mode derivatives of the same formulas,
# fused differently).
# ---------------------------------------------------------------------------

N_TOL = 2e-6


def _pixels(w=W, h=H):
    xs = np.array([10.0, 100.0, 320.0, 550.0, 630.0]) * w / W
    ys = np.array([10.0, 120.0, 240.0, 400.0, 470.0]) * h / H
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


@pytest.mark.parametrize("model", sorted(MILD))
def test_undistort_and_unproject_match_jax(model):
    # the cutoff plays no part in the inverse path, and the round trip below
    # stays inside the image: both cameras skip it
    jc = jcm.make_camera(model, W, H, MILD[model], cutoff=False)
    tc = tcm.make_camera(model, W, H, MILD[model], cutoff=False, device="cpu")
    pix = _pixels()
    rng = np.random.RandomState(4)
    n = rng.uniform(-0.45, 0.45, (64, 2)).astype(np.float32)
    jd = np.asarray(jcm.distort(jc, jnp.asarray(n)))
    np.testing.assert_allclose(tcm.distort(tc, torch.from_numpy(n)).numpy(), jd, atol=1e-6)
    # one undistortion per side on all inputs (one JAX compile): the pixels'
    # distorted coordinates, jd, and the port's own distort(n) for its round trip
    dist = np.asarray(jcm.image_to_distorted(jc, jnp.asarray(pix)))
    ju = np.asarray(jcm.undistort(jc, jnp.asarray(np.concatenate([dist, jd]))))
    jn, jun = ju[:len(pix)], ju[len(pix):]
    tu = tcm.undistort(tc, torch.cat([tcm.image_to_distorted(tc, torch.from_numpy(pix)),
                                      torch.from_numpy(jd), tcm.distort(tc, torch.from_numpy(n))]))
    tn, tun, n2 = (x.numpy() for x in torch.split(tu, [len(pix), len(jd), len(n)]))
    ok = np.isfinite(jn).all(1)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(np.isfinite(tn).all(1), ok)
    np.testing.assert_allclose(tn[ok], jn[ok], atol=N_TOL)
    np.testing.assert_allclose(tun, jun, atol=N_TOL)
    np.testing.assert_allclose(n2, n, atol=1e-5)  # distort -> undistort round trip
    depth = rng.uniform(0.5, 5.0, len(pix)).astype(np.float32)
    jp = np.concatenate([jn * depth[:, None], depth[:, None]], 1)  # jcm.unproject's formula
    tp = tcm.unproject(tc, torch.from_numpy(pix), torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(tp[ok], jp[ok], atol=N_TOL * 5.0)
    # round trip through the port's own projection
    pix2 = tcm.normalized_to_image(tc, torch.from_numpy(tn)).numpy()
    fin = np.isfinite(pix2).all(1)
    assert fin.mean() > 0.9
    np.testing.assert_allclose(pix2[fin], pix[fin], atol=2e-2)


def test_undistortion_lut_matches_jax():
    params = [100.0, 100.0, 63.5, 47.5, 0.2, -0.05, 0.001, -0.002]
    jc = jcm.make_camera("OPENCV", 128, 96, params)
    tc = tcm.make_camera("OPENCV", 128, 96, params, device="cpu")
    for step in (1.0, 2.5):
        jl, tl = jcm.build_undistortion_lut(jc, step), tcm.build_undistortion_lut(tc, step)
        assert tl.values.shape == jl.values.shape and tl.step == jl.step
        # k1 = 0.2: near the corners the two Gauss-Newton runs stop up to 9e-6 apart
        np.testing.assert_allclose(tl.values.numpy(), np.asarray(jl.values), atol=1e-5)
    rng = np.random.RandomState(0)
    pix = np.stack([rng.uniform(-2, 130, 500), rng.uniform(-2, 98, 500)], -1).astype(np.float32)
    d = rng.uniform(1.0, 5.0, 500).astype(np.float32)
    np.testing.assert_allclose(
        tcm.image_to_normalized_lut(tc, tl, torch.from_numpy(pix)).numpy(),
        np.asarray(jcm.image_to_normalized_lut(jc, jl, jnp.asarray(pix))), atol=1e-5)
    tp = tcm.unproject_lut(tc, tl, torch.from_numpy(pix), torch.from_numpy(d))
    np.testing.assert_allclose(
        tp.numpy(), np.asarray(jcm.unproject_lut(jc, jl, jnp.asarray(pix), jnp.asarray(d))),
        atol=5e-5)
    # the LUT serves the iterative undistortion's values between nodes
    ref = tcm.image_to_normalized(tc, torch.from_numpy(pix[(pix[:, 0] > 2) & (pix[:, 1] > 2)
                                                          & (pix[:, 0] < 125) & (pix[:, 1] < 93)]))
    lut1 = tcm.build_undistortion_lut(tc)
    sel = (pix[:, 0] > 2) & (pix[:, 1] > 2) & (pix[:, 0] < 125) & (pix[:, 1] < 93)
    np.testing.assert_allclose(tcm.image_to_normalized_lut(tc, lut1, torch.from_numpy(pix[sel])),
                               ref, atol=2e-5)


@pytest.mark.parametrize("model", sorted(MILD))
def test_image_jacobians_match_jax(model):
    # the Jacobians do not read the cutoff
    jc = jcm.make_camera(model, W, H, MILD[model], cutoff=False)
    tc = tcm.make_camera(model, W, H, MILD[model], cutoff=False, device="cpu")
    pts = np.asarray([[0.1, -0.05, 1.2], [0.4, 0.3, 2.0], [-0.2, 0.25, 0.8],
                      [0.0, 0.0, 1.0]], np.float32).reshape(2, 2, 3)
    jp = np.asarray(jcm.image_jacobian_wrt_point(jc, jnp.asarray(pts)))
    tp = tcm.image_jacobian_wrt_point(tc, torch.from_numpy(pts)).numpy()
    assert tp.shape == (2, 2, 2, 3)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-3)
    jq = np.asarray(jcm.image_jacobian_wrt_params(jc, jnp.asarray(pts)))
    tq = tcm.image_jacobian_wrt_params(tc, torch.from_numpy(pts)).numpy()
    assert tq.shape == (2, 2, 2, len(MILD[model]))
    np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-3)


def test_project_fused_matches_jax_inside_jit():
    """``project(..., fused=True)`` is the JAX function inside ``jit``, bit
    for bit for the models without distortion."""
    import jax

    rng = np.random.RandomState(12)
    pts = np.concatenate([rng.uniform(-2, 2, (3000, 2)), rng.uniform(0.5, 4, (3000, 1))],
                         1).astype(np.float32)
    for model in ("PINHOLE", "SIMPLE_PINHOLE"):
        jc = jcm.make_camera(model, W, H, MILD[model])
        tc = tcm.make_camera(model, W, H, MILD[model], device="cpu")
        jpix = np.asarray(jax.jit(lambda p: jcm.project(jc, p)[0])(jnp.asarray(pts)))
        np.testing.assert_array_equal(tcm.project(tc, torch.from_numpy(pts), fused=True)[0].numpy(),
                                      jpix)
        np.testing.assert_array_equal(tcm.project(tc, torch.from_numpy(pts))[0].numpy(),
                                      np.asarray(jcm.project(jc, jnp.asarray(pts))[0]))


def test_fisheye_projection_after_the_icp_tests_matches_jax():
    """C.1 (open): the fisheye case above failed, a few times, when it ran
    after ``tests/test_icp.py`` or ``test_ref_baseline.py`` in one loaded
    process, with the points of the second half, 2000-3999, off by up to
    0.065 px. Torch computes a float32 ``atan`` of 4000 points with MKL's
    ``vsAtan`` in chunks of 2048 across its intra-op threads, so that half
    is the chunk its second thread computes. Here the ICP tests' JAX work
    (their H, b at the Pallas test's size) runs first; then the port
    projects five times on torch's threads (two, as this file sets them),
    each projection bit-equal to one made on the calling thread alone
    before that work, and within 1e-4 px of JAX."""
    from dataset_pipeline_tpu.icp.point_to_plane import _icp_hb_cost

    model = "FISHEYE_POLYNOMIAL_2_TANGENTIAL_2"
    pts = _points(sum(map(ord, model)))
    tc = tcm.make_camera(model, W, H, MILD[model], device="cpu")
    threads = torch.get_num_threads()
    assert threads >= 2
    torch.set_num_threads(1)
    try:
        before = tcm.project(tc, torch.from_numpy(pts))[0].numpy()
    finally:
        torch.set_num_threads(threads)
    rng = np.random.RandomState(0)
    m = 3000
    ps = rng.randn(m, 3).astype(np.float32)
    ns = rng.randn(m, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (2, 1))
    out = _icp_hb_cost(jnp.asarray(q), jnp.zeros((2, 3), jnp.float32), jnp.asarray(ps),
                       jnp.asarray(ns), jnp.asarray(ps + 0.01), jnp.asarray(ns),
                       jnp.zeros(m, jnp.int32), jnp.ones(m, jnp.int32), jnp.ones(m, jnp.float32), 2)
    np.asarray(out[0])
    jc = jcm.make_camera(model, W, H, MILD[model])
    jpix, jok = (np.asarray(a) for a in jcm.project(jc, jnp.asarray(pts)))
    for _ in range(5):
        tpix, tok = (a.numpy() for a in tcm.project(tc, torch.from_numpy(pts)))
        np.testing.assert_array_equal(tpix, before)
    both = jok & tok
    assert both.sum() > 500
    np.testing.assert_allclose(tpix[both], jpix[both], rtol=PIX_RTOL, atol=PIX_ATOL)
