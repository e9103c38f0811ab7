"""Port vs JAX: rig-capable joint BA (``parallel/joint_ba_rig.py``).

Scenes: the two-frame, two-camera rig scenes of ``tests/test_joint_ba_rig.py``
(200x150 pinhole images rendered exactly on the textured paraboloid), with
the reference slot's depth maps for the inverse-depth rows (depth weight
200, as the JAX test), built by the JAX package and carried into the port as
numpy. Tolerances as in ``test_torch_joint_ba.py``: masks equal, observation
scales 1e-5 relative, the normal equations' pieces within
rtol 1e-4 / atol 1e-3 of JAX (an H entry against its scale sqrt(H_ii H_jj),
``test_torch_joint_ba.close_gram``: JAX's own op-by-op and compiled forms
break the bound taken against the entry itself), costs 1e-5, the step within
2 % of its largest entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_joint_ba_rig as tjr
import test_torch_joint_ba as tj
from dataset_pipeline_tpu.models import cameras as jcm
from dataset_pipeline_tpu.models.lie import SE3 as JSE3
from dataset_pipeline_tpu.parallel import joint_ba_rig as jjr
from dataset_pipeline_tpu.parallel.ba import JointScene
from dataset_pipeline_tpu.parallel.mesh import make_data_mesh
from dataset_pipeline_tpu.photometric.multiscale import build_multiscale_cloud
from dataset_pipeline_tpu.photometric.problem import (
    ImageGroup,
    PhotoProblem,
    build_image_pyramid,
    build_photo_level,
    image_scale_count,
)
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.parallel import joint_ba as tjb
from dataset_pipeline_tpu_torch.parallel import joint_ba_rig as tjr_port

from scenes import render_surface_image, surface_cloud

torch.set_num_threads(2)
DEPTH_WEIGHT = 200.0


def depth_rig_scene():
    """``test_rig_joint_depth_rows_smoke``'s scene: one scene, two frames of a
    two-camera rig at the true extrinsic, depth maps of the reference slot."""
    W, H, F, CX, CY = tjr.W, tjr.H, tjr.F, tjr.CX, tjr.CY
    pts, cols = surface_cloud(260)
    cam = jcm.make_camera("PINHOLE", W, H, [F, F, CX, CY])
    scale_count = image_scale_count(W, H)
    imgs, deps0, ref_mats = [[], []], [], []
    for eye in tjr.SET_EYES:
        R0, t0 = tjr._look_at(eye, np.asarray([1.0, 1.0, 0.0]))
        ref_mats.append(tjr._se3_mat(R0, t0))
        i0, d0 = render_surface_image(R0, t0, W, H, F, CX, CY, with_depth=True)
        imgs[0].append(i0)
        deps0.append(d0)
        imgs[1].append(render_surface_image(R0, t0 + tjr.EXTR_T, W, H, F, CX, CY))
    ref_poses = JSE3.from_matrix(jnp.asarray(np.stack(ref_mats), jnp.float32))
    extr = JSE3.from_matrix(jnp.asarray(np.stack([np.eye(4), tjr._se3_mat(np.eye(3), tjr.EXTR_T)]),
                                        jnp.float32))
    group0 = ImageGroup(camera=cam, pyramid=build_image_pyramid(np.stack(imgs[0]), scale_count),
                        poses=ref_poses, image_ids=[1, 3], rig_id=0, rig_cam_index=0)
    group1 = ImageGroup(camera=cam, pyramid=build_image_pyramid(np.stack(imgs[1]), scale_count),
                        poses=ref_poses, image_ids=[2, 4], rig_id=0, rig_cam_index=1,
                        ref_group=0, ref_slots=np.asarray([0, 1]))
    poses_all = JSE3(jnp.concatenate([ref_poses.q, ref_poses.q]),
                     jnp.concatenate([ref_poses.t, ref_poses.t]))
    levels_raw = build_multiscale_cloud(pts, cols, np.zeros(len(pts), np.uint8), poses_all, cam,
                                        scale_count)
    levels = [pl_ for i, lv in enumerate(levels_raw) if (pl_ := build_photo_level(lv, seed=i))]
    lv = levels[0]
    levels = [type(lv)(lv.points, lv.intensities, lv.scan_indices, lv.neighbors,
                       lv.fixed_descriptors, 0.006)]
    problem = PhotoProblem(groups=[group0, group1], levels=levels,
                           occlusion_points=jnp.asarray(pts), occlusion_radius=0.008,
                           scale_count=scale_count, rig_extrinsics=[extr],
                           depth_map_pyramids=[build_image_pyramid(np.stack(deps0), scale_count)])
    return JointScene(problem, 0, None, icp_weight=1.0)


@pytest.fixture(scope="module")
def setup():
    scenes = [depth_rig_scene()]
    jpack = jjr.pack_rig_scenes(make_data_mesh(1), scenes, optimize_intrinsics=True,
                                depth_weight=DEPTH_WEIGHT)
    jsys = jjr.RigJointBASystem(jpack)
    jst0 = jjr.make_rig_state(jpack)
    vis, osc = jsys.visibility(jst0)
    xk, xi, _, _ = jsys.step(jst0, vis, osc, 1e-2)
    jst1 = jjr.apply_rig_delta(jpack, jst0, xk, xi)
    tpack = tjr_port.pack_rig_scenes("cpu", tj.port_scenes(scenes), optimize_intrinsics=True,
                                     depth_weight=DEPTH_WEIGHT)
    return dict(scenes=scenes, jpack=jpack, jsys=jsys, tpack=tpack,
                tsys=tjr_port.RigJointBASystem(tpack), states={"initial": jst0, "carried": jst1})


def jax_rig_normal_equations(pack, st, vis, osc):
    """H, b pieces from the JAX package's per-(frame, slot) and depth
    functions, folded as its ``step_fn`` folds them."""
    n_keep = pack.n_keep
    Hkk, bk, cost = jnp.zeros((n_keep, n_keep)), jnp.zeros((n_keep,)), jnp.asarray(0.0)
    Hki, Hii, bi = [], [], []
    params = st["params"]
    for i in range(pack.f_pad):
        si = int(np.asarray(pack.frame_scene)[i])
        kk, ki = jnp.zeros((n_keep, n_keep)), jnp.zeros((n_keep, 6))
        ii, bkk, bii, c_f = jnp.zeros((6, 6)), jnp.zeros((n_keep,)), jnp.zeros((6,)), 0.0
        for c in range(pack.n_cams):
            G, g, c_i, _ = jjr._rows_one(pack, c, params[c], st["corr_q"], st["corr_t"],
                                         st["extr_q"], st["extr_t"], st["pose_q"][i],
                                         st["pose_t"][i], jnp.asarray(si),
                                         [lvl[i, c] for lvl in pack.pyramids], vis[i, c],
                                         osc[i, c])
            dk, E = pack.dk(c), pack.expand_c[c][si]
            kk = kk + E.T @ (G[:dk, :dk] @ E)
            ki = ki + E.T @ G[:dk, dk:]
            ii = ii + G[dk:, dk:]
            bkk = bkk + E.T @ g[:dk]
            bii = bii + g[dk:]
            c_f = c_f + c_i
        Gd, gd, cd, _ = jjr._depth_rows_one(pack, params[0], st["corr_q"], st["corr_t"],
                                            st["pose_q"][i], st["pose_t"][i], jnp.asarray(si),
                                            [lvl[i] for lvl in pack.depth_pyramids], vis[i, 0],
                                            osc[i, 0])
        w, dk0, E0 = pack.depth_weight, pack.p_len[0] + 6 * pack.s_max, pack.expand_c[0][si]
        kk = kk + w * (E0.T @ (Gd[:dk0, :dk0] @ E0))
        ki = ki + w * (E0.T @ Gd[:dk0, dk0:])
        ii = ii + w * Gd[dk0:, dk0:]
        bkk = bkk + w * (E0.T @ gd[:dk0])
        bii = bii + w * gd[dk0:]
        Hkk, bk, cost = Hkk + kk, bk + bkk, cost + c_f + w * cd
        Hki.append(ki)
        Hii.append(ii)
        bi.append(bii)
    return Hkk, bk, jnp.stack(Hki), jnp.stack(Hii), jnp.stack(bi), cost


def test_pack_rig_scenes_matches_jax(setup):
    jp, tp = setup["jpack"], setup["tpack"]
    assert (tp.n_keep, tp.n_cams, tp.n_frames, tp.f_pad, tp.n_int, tp.p_off, tp.p_len,
            tp.n_free, tp.scan_off) == (jp.n_keep, jp.n_cams, jp.n_frames, jp.f_pad, jp.n_int,
                                         list(jp.p_off), jp.p_len, jp.n_free, jp.scan_off)
    for name in ("scene_points", "scene_neighbors", "scene_desc", "scene_valid", "scene_radius",
                 "frame_scene", "frame_valid", "present", "ref_q0", "ref_t0", "extr_q0",
                 "extr_t0"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    for a, b in zip(tp.expand_c + tp.pyramids + tp.depth_pyramids,
                    jp.expand_c + jp.pyramids + jp.depth_pyramids):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_jax_rig_op_by_op_and_compiled_grams_break_a_per_entry_bound(setup):
    """As ``test_torch_joint_ba``'s: the rig system's H, b from the JAX
    package op by op and compiled differ by more than rtol 1e-4 / atol 1e-3
    of some entry itself and stay within the scaled bound."""
    assert tj.jax_eager_vs_compiled(setup, jax_rig_normal_equations) > 1.0


@pytest.mark.parametrize("which", ["initial", "carried"])
def test_rig_visibility_normal_equations_and_cost_match_jax(setup, which):
    """Photometric rows of both slots and the reference slot's depth rows."""
    jpack, jsys, tsys = setup["jpack"], setup["jsys"], setup["tsys"]
    jst = setup["states"][which]
    tst = tjb.state_from_numpy(setup["tpack"], tj.jax_state_np(jst))
    jv, js = jsys.visibility(jst)
    tv, ts = tsys.visibility(tst)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    m = np.asarray(jv)
    assert m[:, 0].sum() > 400 and m[:, 1].sum() > 400
    tj.close(ts.numpy()[m], np.asarray(js)[m], tj.SCALE_RTOL, tj.SCALE_ATOL, "obs_scale")

    vis, osc = torch.from_numpy(np.asarray(jv)), torch.from_numpy(np.asarray(js))
    tj.check_normal_equations(tsys.normal_equations(tst, vis, osc),
                              jax_rig_normal_equations(jpack, jst, jv, js))
    jc, jn = jsys.cost(jst, jv, js)
    tc, tn = tsys.cost(tst, vis, osc)
    assert int(tn) == int(jn)
    tj.close(tc, float(jc), tj.COST_RTOL, 0, "frozen-visibility cost")


@pytest.mark.parametrize("devices", [1, 8])
def test_rig_step_matches_jax_on_1_and_8_device_meshes(setup, devices):
    """The rig system's step against JAX's on a 1-device mesh and on the
    8-device CPU mesh (2 frames padded to 8)."""
    tsys = setup["tsys"]
    if devices == 1:
        jpack, jsys = setup["jpack"], setup["jsys"]
    else:
        jpack = jjr.pack_rig_scenes(make_data_mesh(devices), setup["scenes"],
                                    optimize_intrinsics=True, depth_weight=DEPTH_WEIGHT)
        jsys = jjr.RigJointBASystem(jpack)
        assert jpack.f_pad == 8
    jst = jjr.make_rig_state(jpack)
    f = setup["tpack"].f_pad
    tst = tjb.state_from_numpy(setup["tpack"], {k: v[:f] if k.startswith("pose") else v
                                                for k, v in tj.jax_state_np(jst).items()})
    jv, js = jsys.visibility(jst)
    vis = torch.from_numpy(np.asarray(jv)[:f])
    osc = torch.from_numpy(np.asarray(js)[:f])
    for lam in (1e-2, 1.0):
        jk, ji, jc, jn = jsys.step(jst, jv, js, lam)
        tk, ti, tc, tn = tsys.step(tst, vis, osc, lam)
        assert int(tn) == int(jn)
        tj.close(tc, float(jc), tj.COST_RTOL, 0, "step cost")
        tj.close_step(tk, np.asarray(jk), f"x_keep lam {lam}")
        tj.close_step(ti, np.asarray(ji)[:f], f"x_img lam {lam}")


def test_apply_rig_delta_matches_jax(setup):
    jpack, tpack = setup["jpack"], setup["tpack"]
    jst = setup["states"]["initial"]
    rng = np.random.RandomState(12)
    xk = (1e-3 * rng.randn(jpack.n_keep)).astype(np.float32)
    xi = (1e-3 * rng.randn(jpack.f_pad, 6)).astype(np.float32)
    jnew = tj.jax_state_np(jjr.apply_rig_delta(jpack, jst, xk, xi))
    tnew = tjr_port.apply_rig_delta(tpack, tjb.state_from_numpy(tpack, tj.jax_state_np(jst)),
                                    torch.from_numpy(xk), torch.from_numpy(xi))
    for k, v in jnew.items():
        if k == "params":
            for a, b in zip(tnew[k], v):
                tj.close(a, b, 1e-6, 1e-6, k)
        else:
            tj.close(tnew[k], v, 1e-6, 1e-6, k)


def test_run_rig_joint_ba_matches_jax_and_recovers_extrinsic():
    """The extrinsic-recovery run of ``tests/test_joint_ba_rig.py`` in both packages:
    the same accept pattern and cost trace (1e-4 relative per iteration),
    and the port's extrinsic error falls below half its start."""
    from dataset_pipeline_tpu.icp.moments import se3_exp_np
    from dataset_pipeline_tpu.models.lie import quat_to_matrix_np

    d = np.random.RandomState(5).uniform(-0.004, 0.004, 6)
    q, t = se3_exp_np(d)
    extr_gt = tjr._se3_mat(np.eye(3), tjr.EXTR_T)
    extr_init = tjr._se3_mat(quat_to_matrix_np(q), t) @ extr_gt
    _, scene = tjr._build_rig_scene(extr_init)
    jpack = jjr.pack_rig_scenes(make_data_mesh(1), [scene], optimize_intrinsics=False)
    tpack = tjr_port.pack_rig_scenes("cpu", tj.port_scenes([scene]), optimize_intrinsics=False)
    jres = jjr.run_rig_joint_ba(jpack, max_iterations=8, lam0=1.0, refresh_visibility_every=0)
    tres = tjr_port.run_rig_joint_ba(tpack, max_iterations=8, lam0=1.0,
                                     refresh_visibility_every=0)
    assert tres.iterations == jres.iterations and tres.rows == jres.rows
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-4)
    assert tres.costs[-1] < tres.costs[0]

    def extr_error(q_, t_):
        M = SE3(torch.as_tensor(q_, dtype=torch.float32),
                torch.as_tensor(t_, dtype=torch.float32)).matrix().double().numpy()
        rel = M @ np.linalg.inv(extr_gt)
        return float(torch.linalg.norm(SE3.from_matrix(torch.from_numpy(rel).float()).log()))

    before = extr_error(tpack.extr_q0[1], tpack.extr_t0[1])
    after = extr_error(tres.state["extr_q"][1], tres.state["extr_t"][1])
    assert after < 0.5 * before, (before, after)
