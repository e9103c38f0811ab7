"""Port vs JAX: the photometric optimizer from one shared problem state.

The JAX problem of ``tests/scenes.synthetic_two_frame_problem`` (two rendered
160x120 views of a textured height field) is carried into the port with
``problem_from_numpy``; then both sides evaluate

- the splat occlusion depths, visibility masks and observation scales;
- ``_hb_batch`` (H, b, cost, count) with intrinsics and the dynamic-scale
  Jacobian row;
- ``_cost_batch`` and ``_imgdesc_batch``;
- three LM iterations of ``run_on_current_scale``: per-iteration costs and
  the final poses and intrinsics.

Tolerances: masks identical; obs_scale 5e-4 absolute (the footprint scale
differences two projections ~0.1 px apart, so one float32 ulp of a ~100 px
coordinate is ~5e-5 relative in px_per_m before the log2; measured 3.1e-4);
H and b 1e-4 of their
largest entry and the cost 1e-5 relative (float32 sums over ~10^4
observations in another order); iteration costs 1e-4 relative, poses 1e-5
per quaternion / translation entry and intrinsics 1e-3 px after three LM
steps (the measured gaps are about 100x smaller).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataset_pipeline_tpu.photometric.optimizer as jpo
from dataset_pipeline_tpu_torch.ops import hb_gram
from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
from dataset_pipeline_tpu_torch.photometric import problem as tpb
from scenes import synthetic_two_frame_problem

torch.set_num_threads(2)


def _to_port(jp):
    levels = [dict(points=np.asarray(l.points), intensities=np.asarray(l.intensities),
                   scan_indices=np.asarray(l.scan_indices), neighbors=np.asarray(l.neighbors),
                   fixed_descriptors=np.asarray(l.fixed_descriptors), radius=l.radius)
              for l in jp.levels]
    groups = [dict(model=g.camera.model, width=g.camera.width, height=g.camera.height,
                   params=np.asarray(g.camera.params),
                   radius_cutoff_sq=np.asarray(g.camera.radius_cutoff_sq),
                   pyramid=[np.asarray(p) for p in g.pyramid], q=np.asarray(g.poses.q),
                   t=np.asarray(g.poses.t), image_ids=g.image_ids,
                   min_image_scale=g.min_image_scale)
              for g in jp.groups]
    return tpb.problem_from_numpy(levels, groups, np.asarray(jp.occlusion_points),
                                  jp.occlusion_radius, jp.scale_count, jp.max_valid_intensity,
                                  jp.occlusion_depth_threshold, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """(JAX optimizer, port optimizer) on the same state, at scale 0 with
    frozen visibility and variable descriptors computed."""
    jp = synthetic_two_frame_problem()
    tp = _to_port(jp)
    jo = jpo.PhotometricOptimizer(jp, variable_weight=1.0)
    to = tpo.PhotometricOptimizer(tp, variable_weight=1.0)
    jo.current_scale = to.current_scale = 0
    return jo, to


def _vis(jo, to):
    jocc, tocc = jo._occlusion_depths(), to._occlusion_depths()
    np.testing.assert_array_equal(tocc[0].numpy(), np.asarray(jocc[0]))
    return jo._visibility(jocc), to._visibility(tocc)


def test_occlusion_and_visibility_match(pair):
    jo, to = pair
    jv, tv = _vis(jo, to)
    total = 0
    for l in range(len(jo.p.levels)):
        (jm, js), (tm, ts) = jv[0][l][0], tv[0][l][0]
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        m = np.asarray(jm)
        np.testing.assert_allclose(ts.numpy()[m], np.asarray(js)[m], rtol=0, atol=5e-4)
        total += m.sum()
    assert total > 1000


def _chunk_inputs(jo, to, l):
    jv, tv = _vis(jo, to)
    jm, js = jv[0][l][0]
    g, tg = jo.p.groups[0], to.p.groups[0]
    b = to._batches[0][0]
    lv, tl = jo.p.levels[l], to.p.levels[l]
    jargs = (g.camera, g.camera.params, g.poses.q, g.poses.t, lv.points, lv.neighbors)
    targs = (tg.camera, tg.camera.params, tg.poses.q, tg.poses.t, tl.points, tl.neighbors)
    return (jargs, tuple(g.pyramid), js, jm, lv), (targs, b, torch.from_numpy(np.asarray(js)),
                                                   torch.from_numpy(np.asarray(jm)), tl)


@pytest.mark.parametrize("optimize_intrinsics,dynamic_scale", [(True, True), (False, False)])
def test_hb_batch_matches(pair, optimize_intrinsics, dynamic_scale):
    jo, to = pair
    for l in range(len(jo.p.levels)):
        (ja, pyr, js, jm, lv), (ta, b, ts, tm, tl) = _chunk_inputs(jo, to, l)
        H, bb, c, n = (np.asarray(x) for x in jpo._hb_batch(
            *ja, lv.fixed_descriptors, pyr, js, jm, jnp.asarray(lv.radius, jnp.float32),
            optimize_intrinsics, dynamic_scale))
        tH, tb, tc, tn = (x.numpy() for x in tpo._hb_batch(
            *ta, tl.fixed_descriptors, b.flat, b.layout, ts, tm, tl.radius,
            optimize_intrinsics, dynamic_scale))
        V = 10 if optimize_intrinsics else 6
        assert tH.shape == H.shape == (2, V, V)
        assert int(tn) == int(n) > 0
        np.testing.assert_allclose(tc, c, rtol=1e-5)
        np.testing.assert_allclose(tH, H, rtol=0, atol=1e-4 * np.abs(H).max())
        np.testing.assert_allclose(tb, bb, rtol=0, atol=1e-4 * np.abs(bb).max())


def test_cost_and_descriptor_batches_match(pair):
    jo, to = pair
    for l in range(len(jo.p.levels)):
        (ja, pyr, js, jm, lv), (ta, b, ts, tm, tl) = _chunk_inputs(jo, to, l)
        c, n = jpo._cost_batch(*ja, lv.fixed_descriptors, pyr, js, jm)
        tc, tn = tpo._cost_batch(*ta, tl.fixed_descriptors, b.flat, b.layout, ts, tm)
        assert int(tn) == int(n) > 0
        np.testing.assert_allclose(float(tc), float(c), rtol=1e-5)
        d, k = jpo._imgdesc_batch(*ja, pyr, js, jm)
        td, tk = tpo._imgdesc_batch(*ta, b.flat, b.layout, ts, tm)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(k))
        np.testing.assert_allclose(td.numpy(), np.asarray(d), rtol=0, atol=1e-3)


def test_run_on_current_scale_matches():
    jp = synthetic_two_frame_problem()
    tp = _to_port(jp)
    jo = jpo.PhotometricOptimizer(jp, variable_weight=1.0)
    to = tpo.PhotometricOptimizer(tp, variable_weight=1.0)
    jo.current_scale = to.current_scale = 0
    jcosts = []
    accumulate = jo._lm_accumulate

    def record(vis):
        out = accumulate(vis)
        jcosts.append(out[2])
        return out

    jo._lm_accumulate = record
    jr = jo.run_on_current_scale(max_iterations=3)
    tcosts = []
    tr = to.run_on_current_scale(max_iterations=3, iteration_costs=tcosts)
    assert tr.iterations == jr.iterations == 3
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    np.testing.assert_allclose(tr.optimum_cost, jr.optimum_cost, rtol=1e-4)
    assert tr.optimum_cost < tcosts[0]
    jg, tg = jp.groups[0], tp.groups[0]
    np.testing.assert_allclose(tg.poses.q.numpy(), np.asarray(jg.poses.q), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tg.poses.t.numpy(), np.asarray(jg.poses.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tg.camera.params.numpy(), np.asarray(jg.camera.params), rtol=0,
                               atol=1e-3)


def _three_image_problem():
    """The two-frame problem with image 0 repeated as a third image."""
    from dataset_pipeline_tpu.models.lie import SE3 as JSE3

    jp = synthetic_two_frame_problem()
    g = jp.groups[0]
    g.pyramid = [jnp.concatenate([p, p[:1]]) for p in g.pyramid]
    g.poses = JSE3(jnp.concatenate([g.poses.q, g.poses.q[:1]]),
                   jnp.concatenate([g.poses.t, g.poses.t[:1]]))
    g.image_ids = [0, 1, 2]
    return jp


@pytest.mark.parametrize("port_chunk", [2, 4])
def test_uneven_image_chunks_match_jax(port_chunk):
    """Three images: the JAX package pads its chunk of 3 to 4 rows, the port
    runs chunks of [2, 1] or [3] rows with no padding; the assembled H, b
    and entry cost agree (tolerances of test_hb_batch_matches)."""
    assert [list(c) for c in tpo._chunk_indices(13, 8)] == [list(range(8)),
                                                             list(range(8, 13))]
    jp = _three_image_problem()
    tp = _to_port(jp)
    jo = jpo.PhotometricOptimizer(jp, variable_weight=1.0, image_chunk=4)
    to = tpo.PhotometricOptimizer(tp, variable_weight=1.0, image_chunk=port_chunk)
    assert [b.nb for b in to._batches[0]] == ([2, 1] if port_chunk == 2 else [3])
    jo.current_scale = to.current_scale = 0
    jv, tv = jo._visibility(jo._occlusion_depths()), to._visibility(to._occlusion_depths())
    H, bb, c, _ = jo._lm_accumulate(jv)
    tH, tb, tc, _ = to._lm_accumulate(tv)
    assert tH.shape == H.shape == (4 + 18, 4 + 18)
    assert np.abs(H[-6:, -6:]).max() > 0
    np.testing.assert_allclose(tc, c, rtol=1e-5)
    np.testing.assert_allclose(tH, H, rtol=0, atol=1e-4 * np.abs(H).max())
    np.testing.assert_allclose(tb, bb, rtol=0, atol=1e-4 * np.abs(bb).max())


def test_split_gram_matches_one_product():
    """The row-split Gram product (several slices plus a remainder) equals
    the single product in float64."""
    rng = np.random.RandomState(8)
    M = 3 * hb_gram._GRAM_ROWS + 777
    x = torch.from_numpy(rng.randn(2, M, 10).astype(np.float32))
    y = torch.from_numpy(rng.randn(2, M, 3).astype(np.float32))
    ref = torch.bmm(x.double().transpose(1, 2), y.double()).numpy()
    np.testing.assert_allclose(hb_gram.gram(x, y).double().numpy(), ref, rtol=0, atol=1e-3)
    np.testing.assert_allclose(hb_gram.gram(x[:, :100], y[:, :100]).numpy(),
                               torch.bmm(x[:, :100].transpose(1, 2), y[:, :100]).numpy())


def test_masks_and_mask_filter_match(tmp_path):
    """Mask files (image + camera mask, OR-combined), the OR-pooled mask
    pyramid, and visibility with the mask filter on, against JAX."""
    from PIL import Image

    from dataset_pipeline_tpu.photometric import masks as jmasks
    from dataset_pipeline_tpu_torch.photometric import masks as tmasks

    jp = synthetic_two_frame_problem()
    g = jp.groups[0]
    H, W = g.camera.height, g.camera.width
    rng = np.random.RandomState(9)
    os.makedirs(tmp_path / "masks_for_images" / "cam", exist_ok=True)
    os.makedirs(tmp_path / "masks_for_cameras", exist_ok=True)
    Image.fromarray(((rng.rand(H, W) < 0.1) * 1).astype(np.uint8)).save(
        tmp_path / "masks_for_images" / "cam" / "v0.png")
    cam_mask = np.zeros((H, W), np.uint8)
    cam_mask[: H // 4] = 2
    Image.fromarray(cam_mask).save(tmp_path / "masks_for_cameras" / "cam.png")
    ms = []
    for name in ("cam/v0.jpg", "cam/v1.jpg"):
        a = tmasks.combined_mask(str(tmp_path), name, (H, W))
        np.testing.assert_array_equal(a, jmasks.combined_mask(str(tmp_path), name, (H, W)))
        ms.append(a)
    assert tmasks.combined_mask(str(tmp_path), "other/v.jpg", (H, W)) is None
    tpyr = tmasks.build_mask_pyramid(np.stack(ms), g.level_count, device="cpu")
    jpyr = jmasks.build_mask_pyramid(np.stack(ms), g.level_count)
    for a, b in zip(tpyr, jpyr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    g.mask_pyramid = jpyr
    tp = _to_port(jp)
    tp.groups[0].mask_pyramid = tpyr
    jo = jpo.PhotometricOptimizer(jp)
    to = tpo.PhotometricOptimizer(tp)
    jo.current_scale = to.current_scale = 0
    jv, tv = _vis(jo, to)
    for l in range(len(jp.levels)):
        np.testing.assert_array_equal(tv[0][l][0][0].numpy(), np.asarray(jv[0][l][0][0]))
