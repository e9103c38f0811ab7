"""Port vs JAX: camera rigs and inverse-depth residuals in the photometric
optimizer.

- ``photometric/rig.py``: ``assign_rigs`` (averaged extrinsics, rig-consistent
  poses, images added where a set lacks one) and ``mark_rig_groups`` give the
  JAX package's structures (extrinsics and poses within 1e-6).
- The optimizer's rig half (``_hb_rig_batch``, ``_sync_dependent_poses``, the
  extrinsics in ``_var_layout`` / ``_candidate_state``) and depth half
  (``_hb_depth_batch``, ``_cost_depth_batch``): on the four-frame scenes of
  ``tests/test_rig_alignment.py`` (two sets of a two-camera rig; 200x150
  pinhole images rendered exactly), both packages assemble the LM system from
  the same frozen observations (the JAX visibility carried over), and H, b
  must agree within 1e-4 of their largest entry, the entry cost within 1e-5
  relative. The depth case compares each chunk's H, b with ``_hb_depth_batch``
  too.
- The full schedule (``PhotometricOptimizer.run``) from the reference's
  perturbation: every image pose within 0.0016 per se(3)-log component of the
  truth (the bound of ``test_rig_alignment.py``), the extrinsics' translation
  within 2x that, for the rig with fixed colours and for the depth residual
  alone (non-rig, height-field geometry, +-0.002 perturbation).
- The JAX tests of the numerical rig Jacobians
  (``test_photometric_jacobians.py:121``) in the port: J from the port's
  forward-mode chain against central differences.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dataset_pipeline_tpu.photometric.optimizer as jpo
import test_rig_alignment as tra
from dataset_pipeline_tpu.io.colmap import ColmapRig as JRig, ColmapRigCamera as JRigCam
from dataset_pipeline_tpu.io.state import ImageState as JImage, ModelState as JModel
from dataset_pipeline_tpu.models import cameras as jcm
from dataset_pipeline_tpu.models.lie import SE3 as JSE3
from dataset_pipeline_tpu.models.lie import quat_from_matrix as jquat_from_matrix
from dataset_pipeline_tpu.photometric import rig as jrig
from dataset_pipeline_tpu.photometric.problem import (
    ImageGroup,
    PhotoProblem,
    build_image_pyramid,
    image_scale_count,
)
from dataset_pipeline_tpu_torch.io.colmap import ColmapRig, ColmapRigCamera
from dataset_pipeline_tpu_torch.io.state import ImageState, ModelState
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
from dataset_pipeline_tpu_torch.photometric import problem as tpb
from dataset_pipeline_tpu_torch.photometric import rig as trig

torch.set_num_threads(2)


def to_port(jp):
    """A JAX problem (rigs and depth maps included) as the port's, on the CPU."""
    levels = [dict(points=np.asarray(l.points), intensities=np.asarray(l.intensities),
                   scan_indices=np.asarray(l.scan_indices), neighbors=np.asarray(l.neighbors),
                   fixed_descriptors=np.asarray(l.fixed_descriptors), radius=l.radius)
              for l in jp.levels]
    groups = [dict(model=g.camera.model, width=g.camera.width, height=g.camera.height,
                   params=np.asarray(g.camera.params),
                   radius_cutoff_sq=np.asarray(g.camera.radius_cutoff_sq),
                   pyramid=[np.asarray(p) for p in g.pyramid], q=np.asarray(g.poses.q),
                   t=np.asarray(g.poses.t), image_ids=g.image_ids,
                   min_image_scale=g.min_image_scale, rig_id=g.rig_id,
                   rig_cam_index=g.rig_cam_index, ref_group=g.ref_group, ref_slots=g.ref_slots)
              for g in jp.groups]
    depth = jp.depth_map_pyramids
    return tpb.problem_from_numpy(
        levels, groups, np.asarray(jp.occlusion_points), jp.occlusion_radius, jp.scale_count,
        jp.max_valid_intensity, jp.occlusion_depth_threshold, device="cpu",
        rig_extrinsics=[(np.asarray(e.q), np.asarray(e.t)) for e in jp.rig_extrinsics],
        depth_map_pyramids=None if depth is None else [[np.asarray(p) for p in pg] for pg in depth])


def four_frame_problem(rig: bool, depth: bool, geometry="quadric", perturb=tra.PERTURB, seed=4):
    """The JAX problem of ``test_rig_alignment._run_four_frame`` and the truth."""
    if geometry == "heightfield":
        sc = tra._heightfield_scene()
        pts, cols, gt, imgs, deps = (sc[k] for k in ("hf_pts", "hf_cols", "hf_gt", "hf_imgs",
                                                     "hf_deps"))
    else:
        sc = tra._scene()
        pts, cols, gt, imgs, deps = (sc[k] for k in ("pts", "cols", "gt", "imgs", "deps"))
    cam = jcm.make_camera("PINHOLE", tra._W, tra._H, [tra._F, tra._F, tra._CX, tra._CY])
    scale_count = image_scale_count(tra._W, tra._H)
    rng = np.random.RandomState(seed)
    init_ref = [tra._perturb_log(gt[si][0], perturb, rng) for si in range(2)]
    init_extr = tra._perturb_log(tra._se3_mat(np.eye(3), tra._EXTR_T), perturb, rng)
    pyr = [build_image_pyramid(np.stack(imgs[c]), scale_count) for c in range(2)]
    ref = JSE3.from_matrix(jnp.asarray(np.stack(init_ref), jnp.float32))
    depth_pyrs = ([build_image_pyramid(np.stack(deps[c]), scale_count) for c in range(2)]
                  if depth else None)
    if rig:
        extr = [JSE3.from_matrix(jnp.asarray(np.stack([np.eye(4), init_extr]), jnp.float32))]
        groups = [ImageGroup(camera=cam, pyramid=pyr[0], poses=ref, image_ids=[1, 3],
                             rig_id=0, rig_cam_index=0),
                  ImageGroup(camera=cam, pyramid=pyr[1], poses=ref, image_ids=[2, 4], rig_id=0,
                             rig_cam_index=1, ref_group=0, ref_slots=np.asarray([0, 1]))]
    else:
        init_dep = [tra._perturb_log(gt[si][1], perturb, rng) for si in range(2)]
        dep = JSE3.from_matrix(jnp.asarray(np.stack(init_dep), jnp.float32))
        extr = []
        groups = [ImageGroup(camera=cam, pyramid=pyr[0], poses=ref, image_ids=[1, 3]),
                  ImageGroup(camera=cam, pyramid=pyr[1], poses=dep, image_ids=[2, 4])]
    poses_all = JSE3(jnp.concatenate([ref.q, ref.q]), jnp.concatenate([ref.t, ref.t]))
    levels = tra._levels_for(pts, cols, poses_all, cam, scale_count, geometry)
    return PhotoProblem(groups=groups, levels=levels, occlusion_points=jnp.asarray(pts),
                        occlusion_radius=0.008, scale_count=scale_count, rig_extrinsics=extr,
                        depth_map_pyramids=depth_pyrs), gt


def _vis_to_port(jv):
    return [[[tuple(torch.from_numpy(np.asarray(x)) for x in ms) for ms in per_level]
             for per_level in per_group] for per_group in jv]


def _pose_errors(groups, gt):
    errs = []
    for si in range(2):
        for ci, g in enumerate(groups):
            M = SE3(g.poses.q[si], g.poses.t[si]).matrix().double().numpy()
            rel = M @ np.linalg.inv(gt[si][ci])
            errs.append(np.abs(SE3.from_matrix(torch.from_numpy(rel[None]).float()).log()[0].numpy()))
    return np.asarray(errs)


def test_assign_rigs_and_mark_groups_match_jax():
    rng = np.random.RandomState(21)
    jims, tims = [], []
    iid = 1
    for si in range(3):
        R0, t0 = tra._look_at(np.asarray([si * 0.2, 0.0, -2.0]), np.zeros(3))
        for ci, (R, t) in enumerate(((R0, t0), (R0, t0 + np.asarray([-0.1, 0.0, 0.0])))):
            if si == 2 and ci == 1:
                continue  # a set without its second image: it gets added
            q = np.asarray(jquat_from_matrix(jnp.asarray(R, jnp.float32)), np.float64)
            tt = t + rng.randn(3) * 1e-3
            jims.append(JImage(iid, 1 + ci, f"cam{ci}/{si}.png", q.copy(), tt.copy()))
            tims.append(ImageState(iid, 1 + ci, f"cam{ci}/{si}.png", q.copy(), tt.copy()))
            iid += 1
    js, ts = JModel({}, jims, 1.0), ModelState({}, tims, 1.0)
    jr = jrig.assign_rigs(js, [JRig(1, [JRigCam(1, "cam0"), JRigCam(2, "cam1")])])
    tr = trig.assign_rigs(ts, [ColmapRig(1, [ColmapRigCamera(1, "cam0"),
                                            ColmapRigCamera(2, "cam1")])])
    assert len(tr) == len(jr) == 1 and len(ts.images) == len(js.images) == 6
    np.testing.assert_allclose(tr[0].image_T_rig[1], jr[0].image_T_rig[1], rtol=0, atol=1e-6)
    for a, b in zip(js.images, ts.images):
        assert (a.image_id, a.camera_id, a.name) == (b.image_id, b.camera_id, b.name)
        np.testing.assert_allclose(b.qvec, a.qvec, rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.tvec, a.tvec, rtol=0, atol=1e-6)
    # groups by camera: cam1's images are dependent on cam0's
    jg = [ImageGroup(camera=None, pyramid=[], poses=None, image_ids=[1, 3, 5]),
          ImageGroup(camera=None, pyramid=[], poses=None, image_ids=[2, 4, 6])]
    tg = [tpb.ImageGroup(camera=None, pyramid=[], poses=None, image_ids=[1, 3, 5]),
          tpb.ImageGroup(camera=None, pyramid=[], poses=None, image_ids=[2, 4, 6])]
    je = jrig.mark_rig_groups(js, jg, jr)
    te = trig.mark_rig_groups(ts, tg, tr, device="cpu")
    np.testing.assert_allclose(te[0].t.numpy(), np.asarray(je[0].t), atol=1e-6)
    for a, b in zip(jg, tg):
        assert (a.rig_id, a.rig_cam_index, a.ref_group) == (b.rig_id, b.rig_cam_index, b.ref_group)
        assert (a.ref_slots is None) == (b.ref_slots is None)
    np.testing.assert_array_equal(tg[1].ref_slots, jg[1].ref_slots)


@pytest.mark.parametrize("case", ["rig_fixed", "rig_fixed_variable", "depth"])
def test_lm_system_matches_jax(case):
    rig = case.startswith("rig")
    jp, _ = four_frame_problem(rig, depth=not rig, geometry="quadric" if rig else "heightfield",
                               perturb=tra.PERTURB if rig else 0.002)
    tp = to_port(jp)
    kw = dict(optimize_intrinsics=False, fixed_weight=1.0 if rig else 0.0,
              variable_weight=1.0 if case == "rig_fixed_variable" else 0.0,
              depth_weight=0.0 if rig else 1.0)
    jo, to = jpo.PhotometricOptimizer(jp, **kw), tpo.PhotometricOptimizer(tp, **kw)
    for a, b in zip(jp.groups, tp.groups):  # the dependent poses, derived at construction
        np.testing.assert_allclose(b.poses.q.numpy(), np.asarray(a.poses.q), rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.poses.t.numpy(), np.asarray(a.poses.t), rtol=0, atol=1e-6)
    jo.current_scale = to.current_scale = 0
    jv = jo._visibility(jo._occlusion_depths())
    tv = _vis_to_port(jv)
    if kw["variable_weight"]:
        jo._var_desc = jo._compute_variable_descriptors(jv)
        to._var_desc = [(torch.from_numpy(np.asarray(d)), torch.from_numpy(np.asarray(m)))
                        for d, m in jo._var_desc]
    H, b, c, offsets = jo._lm_accumulate(jv)
    tH, tb, tc, toffsets = to._lm_accumulate(tv)
    assert toffsets == offsets and tH.shape == H.shape
    assert H.shape == ((6 + 12, 6 + 12) if rig else (24, 24))
    np.testing.assert_allclose(tc, c, rtol=1e-5)
    np.testing.assert_allclose(tH, H, rtol=0, atol=1e-4 * np.abs(H).max())
    np.testing.assert_allclose(tb, b, rtol=0, atol=1e-4 * np.abs(b).max())
    if not rig:  # each chunk's depth H, b through _hb_depth_batch
        g, tg, bt = jp.groups[0], tp.groups[0], to._batches[0][0]
        for l, (jm, js) in enumerate(v[0] for v in jv[0]):
            out = jpo._hb_depth_batch(g.camera, g.camera.params, g.poses.q, g.poses.t,
                                      jp.levels[l].points, tuple(jp.depth_map_pyramids[0]), js, jm,
                                      False)
            got = tpo._hb_depth_batch(tg.camera, tg.camera.params, tg.poses.q, tg.poses.t,
                                      tp.levels[l].points, bt.depth_flat, bt.layout,
                                      torch.from_numpy(np.asarray(js)),
                                      torch.from_numpy(np.asarray(jm)), False)
            Hj, bj, cj, nj = (np.asarray(x) for x in out)
            assert int(got[3]) == int(nj) > 0
            np.testing.assert_allclose(got[0].numpy(), Hj, rtol=0, atol=1e-5 * np.abs(Hj).max())
            np.testing.assert_allclose(got[1].numpy(), bj, rtol=0, atol=1e-4 * np.abs(bj).max())
            np.testing.assert_allclose(float(got[2]), float(cj), rtol=1e-5)
            cc, cn = tpo._cost_depth_batch(tg.camera, tg.camera.params, tg.poses.q, tg.poses.t,
                                           tp.levels[l].points, bt.depth_flat, bt.layout,
                                           torch.from_numpy(np.asarray(js)),
                                           torch.from_numpy(np.asarray(jm)))
            jc, jn = jpo._cost_depth_batch(g.camera, g.camera.params, g.poses.q, g.poses.t,
                                           jp.levels[l].points, tuple(jp.depth_map_pyramids[0]),
                                           js, jm)
            assert int(cn) == int(jn)
            np.testing.assert_allclose(float(cc), float(jc), rtol=1e-5)


@pytest.mark.parametrize("case", ["rig_fixed", "depth_only"])
def test_full_schedule_reaches_reference_bound(case):
    rig = case == "rig_fixed"
    jp, gt = four_frame_problem(rig, depth=not rig, geometry="quadric" if rig else "heightfield",
                                perturb=tra.PERTURB if rig else 0.002)
    tp = to_port(jp)
    before = _pose_errors(tp.groups, gt).max()
    opt = tpo.PhotometricOptimizer(tp, optimize_intrinsics=False, fixed_weight=1.0 if rig else 0.0,
                                   depth_weight=0.0 if rig else 1.0)
    done = []
    opt.run(max_iterations_per_scale=60 if rig else 100,
            on_scale_done=lambda o, r: done.append((o.current_scale, r.optimum_cost)))
    assert [s for s, _ in done] == list(range(tp.scale_count - 2, -1, -1))
    errs = _pose_errors(opt.p.groups, gt)
    assert errs.max() <= tra.REF_BOUND < before
    if rig:
        t_est = opt.p.rig_extrinsics[0].t[1].numpy()
        assert np.linalg.norm(t_est - tra._EXTR_T) < 2 * tra.REF_BOUND


def test_rig_jacobians_against_central_differences():
    """The port's rig chain (forward mode over [6 extrinsics | 6 reference
    pose]) against central differences of the intensity, as
    ``test_photometric_jacobians.py:121`` holds the JAX chain."""
    from dataset_pipeline_tpu_torch.models import cameras as tcm
    from dataset_pipeline_tpu_torch.ops import hb_geometry as hg
    from dataset_pipeline_tpu_torch.ops.pyramid_sample import flatten_pyramid

    W, H = 64, 48
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = torch.from_numpy(60 + 0.8 * xx + 0.5 * yy)[None]
    pyr = [img, img[:, :H // 2 * 2, :W // 2 * 2].reshape(1, H // 2, 2, W // 2, 2).mean((2, 4))]
    flat, layout = flatten_pyramid(pyr)
    cam = tcm.make_camera("PINHOLE", W, H, [50.0, 50.0, 31.5, 23.5], device="cpu")
    rng = np.random.RandomState(2)
    pts = torch.from_numpy(np.stack([rng.uniform(-0.4, 0.4, 40), rng.uniform(-0.3, 0.3, 40),
                                     np.full(40, 2.0)], -1).astype(np.float32))
    obs = torch.full((1, 40), 0.3)
    extr = SE3.exp(torch.from_numpy((0.005 * rng.randn(6)).astype(np.float32)))
    ref = extr.inverse().compose(SE3.identity(device="cpu"))

    def inten(eps_e, eps_r):
        pose = SE3.exp(eps_e).compose(extr).compose(SE3.exp(eps_r).compose(ref))
        v, _ = tpo._point_intensities(cam, cam.params, pose.q[None], pose.t[None], pts, flat,
                                      layout, obs)
        return v[0].double()

    z6 = torch.zeros(6)
    geom = hg.geom_fn(cam, pts, 0.0, False, lambda e, r: SE3.exp(e).compose(extr).compose(
        SE3.exp(r).compose(SE3(ref.q[None, None], ref.t[None, None]))))
    pix, _ = geom(z6, z6, cam.params)
    _, dpx, dpy, dvds, _ = tpo.pyramid_sample(flat, layout, pix.contiguous(), obs, True)
    J = hg.forward_jacobian(geom, (z6, z6, cam.params), lambda t: (t[:6], t[6:], cam.params * 0),
                            torch.eye(12), hg.intensity_chain(dpx, dpy, dvds, False), 40)[0]
    for c in range(12):
        e = torch.zeros(12)
        e[c] = 1e-3
        num = (inten(e[:6], e[6:]) - inten(-e[:6], -e[6:])) / 2e-3
        assert float((J[:, c].double() - num).abs().max()) < 0.05 + 0.01 * float(num.abs().max())
