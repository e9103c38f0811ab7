"""Port vs JAX: joint multi-scene BA (``parallel/ba.py``, ``parallel/joint_ba.py``).

Scenes: the two synthetic two-scan scenes of ``tests/test_joint_ba_system.py``
(128x96 pinhole images, ~1600 points each, perturbed scan 1 and image poses,
ICP correspondences), built once by the JAX package and carried into the port
as numpy. Each JAX call runs on its own CPU mesh: ``make_data_mesh(1)`` (the
port's world size) and, for the padding case, the 8-device mesh.

Tolerances:
- visibility masks equal; observation scales within 1e-5 relative (the
  port's visibility takes the fused multiply-add forms of the JAX pass's
  ``jit``: the footprint difference pix2 - pix magnifies an ulp of a pixel
  ~1e4-fold);
- the normal equations' pieces (Hkk, bk, Hki, Hii, bi) within the JAX
  tests' bounds for H and b, rtol 1e-4 / atol 1e-3 per entry
  (``tests/test_parallel.py:45-47``), an H entry's rtol taken against its
  scale sqrt(H_ii H_jj) (``close_gram``), and the cost within 1e-5. JAX's
  own op-by-op and compiled evaluations of the same H, b break the bound
  taken against the entry itself (up to ~15x here) and keep the scaled one
  (``test_jax_op_by_op_and_compiled_grams_break_a_per_entry_bound``);
- the solved step within 2 % of its largest entry: the reduced system's
  condition number (~1e5 here, the shared intrinsics against the scan
  poses) turns the float32 rounding of H into that much of the step;
- apply_delta within float32 rounding (1e-6); the refreshed ICP targets'
  indices and weights equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import test_joint_ba as tjb_jax
import test_joint_ba_system as tjs
from dataset_pipeline_tpu.parallel import ba as jba
from dataset_pipeline_tpu.parallel import joint_ba as jjb
from dataset_pipeline_tpu.parallel.mesh import make_data_mesh
from dataset_pipeline_tpu_torch.parallel import ba as tba
from dataset_pipeline_tpu_torch.parallel import joint_ba as tjb
from dataset_pipeline_tpu_torch.photometric import problem as tpb

torch.set_num_threads(2)
H_RTOL, H_ATOL, COST_RTOL = 1e-4, 1e-3, 1e-5
SCALE_RTOL, SCALE_ATOL = 1e-5, 0.0
STEP_TOL = 0.02


def to_port(jp):
    """A JAX PhotoProblem as the port's, on the CPU."""
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


def port_scenes(scenes):
    return [tba.JointScene(to_port(s.problem), s.level_idx, s.icp, icp_weight=s.icp_weight)
            for s in scenes]


def jax_state_np(state) -> dict:
    return {k: (tuple(np.asarray(p) for p in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in state.items()}


def np64(x):
    return np.asarray(x.double().cpu().numpy() if torch.is_tensor(x) else x, np.float64)


def close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np64(got), np64(want), rtol=rtol, atol=atol, err_msg=what)


def close_step(got, want, what):
    want = np64(want)
    np.testing.assert_allclose(np64(got), want, rtol=0, atol=STEP_TOL * np.abs(want).max(),
                               err_msg=what)


@pytest.fixture(scope="module")
def setup():
    _, scenes, gt = tjs._make_scenes()
    jpack = jjb.pack_scenes(make_data_mesh(1), scenes, optimize_intrinsics=True)
    jsys = jjb.JointBASystem(jpack)
    jst0 = jjb.make_state(jpack)
    # a carried state: the JAX system's damped step applied once
    vis, osc = jsys.visibility(jst0)
    xk, xi, _, _ = jsys.step(jst0, vis, osc, 1e-2)
    jst1 = jjb.apply_delta(jpack, jst0, xk, xi)
    tpack = tjb.pack_scenes("cpu", port_scenes(scenes), optimize_intrinsics=True)
    return dict(scenes=scenes, gt=gt, jpack=jpack, jsys=jsys, tpack=tpack,
                tsys=tjb.JointBASystem(tpack), states={"initial": jst0, "carried": jst1})


def jax_normal_equations(pack, st, vis, osc):
    """H, b pieces from the JAX package's own per-image and ICP functions,
    folded as its ``step_fn`` folds them (images in order)."""
    dk, n_int = pack.dk, pack.n_int

    Hkk = jnp.zeros((pack.n_keep, pack.n_keep))
    bk = jnp.zeros((pack.n_keep,))
    cost = jnp.asarray(0.0)
    Hki, Hii, bi = [], [], []
    for i in range(pack.m_pad):
        si = int(np.asarray(pack.img_scene)[i])
        G, g, c, _ = jjb._rows_one_image(pack, st["params"], st["corr_q"], st["corr_t"],
                                         st["pose_q"][i], st["pose_t"][i], jnp.asarray(si),
                                         [lvl[i] for lvl in pack.pyramids], vis[i], osc[i])
        E = pack.expand[si]
        Hkk = Hkk + E.T @ (G[:dk, :dk] @ E)
        bk = bk + E.T @ g[:dk]
        cost = cost + c
        Hki.append(E.T @ G[:dk, dk:])
        Hii.append(G[dk:, dk:])
        bi.append(g[dk:])
    Hs, bs, c_icp = jjb._icp_local(pack, st["corr_q"], st["corr_t"])
    Hkk = Hkk.at[n_int:, n_int:].add(Hs)
    bk = bk.at[n_int:].add(bs)
    return Hkk, bk, jnp.stack(Hki), jnp.stack(Hii), jnp.stack(bi), cost + c_icp


def close_gram(got, want, what, scale):
    """H or b pieces within rtol 1e-4 / atol 1e-3 of JAX, an entry's rtol
    taken against its scale: sqrt(H_ii H_jj) for H_ij, sqrt(H_ii 2 cost) for
    b_i (the Cauchy-Schwarz bounds of a Gram entry and of J^T W r), i.e. its
    size in the Jacobi-normalized system, rather than against the entry
    itself. An entry that cancels to ~1e-5 of its scale moves by more than
    1e-4 of itself when the Jacobian moves by an ulp: so do JAX's own
    op-by-op and compiled evaluations of the same Gram."""
    got, want = np64(got), np64(want)
    bound = H_RTOL * scale + H_ATOL
    err = np.abs(got - want)
    assert np.all(err <= bound), (what, float((err / bound).max()))


def check_normal_equations(got, want):
    """(Hkk, bk, Hki, Hii, bi, cost) of the port against JAX's."""
    Hkk, bk, Hki, Hii, bi, cost = (np64(x) for x in want)
    dk = np.abs(np.diagonal(Hkk))
    di = np.abs(np.diagonal(Hii, axis1=1, axis2=2))
    close_gram(got[0], Hkk, "Hkk", np.sqrt(dk[:, None] * dk[None, :]))
    close_gram(got[2], Hki, "Hki", np.sqrt(dk[None, :, None] * di[:, None, :]))
    close_gram(got[3], Hii, "Hii", np.sqrt(di[:, :, None] * di[:, None, :]))
    close_gram(got[1], bk, "bk", np.sqrt(dk * 2 * abs(cost)))
    close_gram(got[4], bi, "bi", np.sqrt(di * 2 * abs(cost)))
    close(got[5], float(cost), COST_RTOL, 0, "cost")


def test_jax_op_by_op_and_compiled_grams_break_a_per_entry_bound(setup):
    """Why ``close_gram`` scales an entry's rtol: JAX's own normal equations,
    evaluated op by op (``jax_normal_equations``) and compiled (the same
    function under ``jax.jit``, which fuses and reorders the float32 sums),
    differ by more than rtol 1e-4 / atol 1e-3 of some entry itself, while
    every entry stays within the scaled bound the port is held to."""
    assert jax_eager_vs_compiled(setup, jax_normal_equations) > 1.0


def jax_eager_vs_compiled(setup, normal_equations) -> float:
    """``normal_equations(pack, state, vis, obs_scale)`` of the JAX package op
    by op and under ``jax.jit``, at each of the setup's states: checks the
    compiled pieces against the eager ones with ``check_normal_equations``
    and returns the largest |compiled - eager| / (rtol |eager| + atol)."""
    import jax

    jpack, jsys = setup["jpack"], setup["jsys"]
    compiled = jax.jit(lambda st, v, o: normal_equations(jpack, st, v, o))
    worst = 0.0
    for st in setup["states"].values():
        jv, js = jsys.visibility(st)
        eager = normal_equations(jpack, st, jv, js)
        comp = compiled(st, jv, js)
        check_normal_equations(comp, eager)
        for a, b in zip(eager[:5], comp[:5]):
            a, b = np64(a), np64(b)
            worst = max(worst, float((np.abs(b - a) / (H_RTOL * np.abs(a) + H_ATOL)).max()))
    return worst


def test_pack_scenes_matches_jax(setup):
    """Gauge, the expansion maps, the level concatenation (a second, coarser
    level added to scene 0) and the pooled ICP rows."""
    scenes = setup["scenes"]
    pr = scenes[0].problem
    lv0 = pr.levels[0]
    lv1 = type(lv0)(lv0.points[:200], lv0.intensities[:200], lv0.scan_indices[:200],
                    jnp.clip(lv0.neighbors[:200], 0, 199), lv0.fixed_descriptors[:200],
                    lv0.radius * 4)
    pr.levels.append(lv1)
    try:
        jp = jjb.pack_scenes(make_data_mesh(1), scenes, optimize_intrinsics=True)
        tp = tjb.pack_scenes("cpu", port_scenes(scenes), optimize_intrinsics=True)
    finally:
        pr.levels.pop()
    assert (tp.n_keep, tp.n_free, tp.n_int, tp.m_pad, tp.s_max, tp.n_icp, tp.dk) == (
        jp.n_keep, jp.n_free, jp.n_int, jp.m_pad, jp.s_max, jp.n_icp, jp.dk)
    np.testing.assert_array_equal(tp.scan_col_np, jp.scan_col_np)
    for name in ("scene_points", "scene_scan_idx", "scene_neighbors", "scene_desc", "scene_valid",
                 "scene_radius", "scan_col", "expand", "img_scene", "img_valid", "pose_q0",
                 "pose_t0", "icp_ps", "icp_ns", "icp_pt", "icp_nt", "icp_w", "icp_scene",
                 "icp_src_s", "icp_tgt_s"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    for a, b in zip(tp.pyramids, jp.pyramids):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tp.icp_w0_np, jp.icp_w0_np)
    n0 = int(lv0.points.shape[0])
    assert tp.scene_neighbors[0, n0:n0 + 200].min() >= n0


@pytest.mark.parametrize("which", ["initial", "carried"])
def test_visibility_and_normal_equations_match_jax(setup, which):
    jpack, jsys, tsys = setup["jpack"], setup["jsys"], setup["tsys"]
    jst = setup["states"][which]
    tst = tjb.state_from_numpy(setup["tpack"], jax_state_np(jst))
    jv, js = jsys.visibility(jst)
    tv, ts = tsys.visibility(tst)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    m = np.asarray(jv)
    assert m.sum() > 1000
    close(ts.numpy()[m], np.asarray(js)[m], SCALE_RTOL, SCALE_ATOL, "obs_scale")

    # the same frozen observations on both sides
    vis, osc = torch.from_numpy(np.asarray(jv)), torch.from_numpy(np.asarray(js))
    check_normal_equations(tsys.normal_equations(tst, vis, osc),
                           jax_normal_equations(jpack, jst, jv, js))
    jc, jn = jsys.cost(jst, jv, js)
    tc, tn = tsys.cost(tst, vis, osc)
    assert int(tn) == int(jn)
    close(tc, float(jc), COST_RTOL, 0, "frozen-visibility cost")


@pytest.mark.parametrize("devices,which", [(1, "initial"), (1, "carried"), (8, "initial")])
def test_step_matches_jax_on_1_and_8_device_meshes(setup, devices, which):
    """The whole system's step and cost against JAX's on a 1-device mesh and
    on the 8-device CPU mesh, whose padding (4 images to 8, ICP rows to a
    multiple of 8) changes nothing beyond the order of the sums."""
    scenes, tsys = setup["scenes"], setup["tsys"]
    if devices == 1:
        jpack, jsys = setup["jpack"], setup["jsys"]
    else:
        jpack = jjb.pack_scenes(make_data_mesh(devices), scenes, optimize_intrinsics=True)
        jsys = jjb.JointBASystem(jpack)
        assert jpack.m_pad == 8 and jpack.n_images == 4
    jst = setup["states"][which]
    if devices != 1:
        jst = jjb.make_state(jpack)
    tst = tjb.state_from_numpy(setup["tpack"], {k: v[:4] if k.startswith("pose") else v
                                                for k, v in jax_state_np(jst).items()})
    jv, js = jsys.visibility(jst)
    vis = torch.from_numpy(np.asarray(jv)[:4])
    osc = torch.from_numpy(np.asarray(js)[:4])
    for lam in (1e-3, 1.0):
        jk, ji, jc, jn = jsys.step(jst, jv, js, lam)
        tk, ti, tc, tn = tsys.step(tst, vis, osc, lam)
        assert int(tn) == int(jn)
        close(tc, float(jc), COST_RTOL, 0, "step cost")
        close_step(tk, np.asarray(jk), f"x_keep lam {lam}")
        close_step(ti, np.asarray(ji)[:4], f"x_img lam {lam}")
        jcost, _ = jsys.cost(jst, jv, js)
        close(tsys.cost(tst, vis, osc)[0], float(jcost), COST_RTOL, 0, "cost")


def test_schur_eliminate_images_and_joint_ba_step_match_jax():
    """``schur_eliminate_images`` on an SPD system with block-diagonal image
    blocks, and ``build_joint_rows`` + ``joint_ba_step`` (the dense twin) on
    the scenes of ``tests/test_joint_ba.py``."""
    rng = np.random.RandomState(7)
    n_keep, m = 10, 5
    n = n_keep + 6 * m
    A = rng.randn(n, n)
    H = A @ A.T + n * np.eye(n)
    for i in range(m):
        for j in range(m):
            if i != j:
                H[n_keep + 6 * i:n_keep + 6 * i + 6, n_keep + 6 * j:n_keep + 6 * j + 6] = 0
    b = rng.randn(n)
    H32, b32 = H.astype(np.float32), b.astype(np.float32)
    Sj, rj, backj = jba.schur_eliminate_images(jnp.asarray(H32), jnp.asarray(b32), n_keep, m, 0.1)
    St, rt, backt = tba.schur_eliminate_images(torch.from_numpy(H32), torch.from_numpy(b32),
                                               n_keep, m, 0.1)
    close(St, np.asarray(Sj), 1e-5, 1e-4, "S")
    close(rt, np.asarray(rj), 1e-5, 1e-5, "rhs")
    x = rng.randn(n_keep).astype(np.float32)
    close(backt(torch.from_numpy(x)), np.asarray(backj(jnp.asarray(x))), 1e-5, 1e-6, "back")

    cam = tjb_jax.cm.make_camera("PINHOLE", tjb_jax.W, tjb_jax.H,
                                 [tjb_jax.F, tjb_jax.F, tjb_jax.CX, tjb_jax.CY])
    rng = np.random.RandomState(3)
    scenes = []
    for seed, phase in [(10, 0.0), (20, 0.7)]:
        problem, icp, _, _ = tjb_jax._build_scene(seed, cam, phase,
                                                  0.008 * rng.randn(6).astype(np.float32),
                                                  0.003 * rng.randn(2, 6).astype(np.float32))
        scenes.append(jba.JointScene(problem, 0, icp, icp_weight=30.0))
    jrows, jr, jw, jk, jm = jba.build_joint_rows(scenes, obs_scale=0.0)
    trows, tr, tw, tk, tm = tba.build_joint_rows(port_scenes(scenes), obs_scale=0.0)
    assert (tk, tm) == (jk, jm) and trows.shape == jrows.shape
    np.testing.assert_array_equal(tw > 0, jw > 0)
    close(tr, jr, 1e-4, 1e-3, "r")
    close(tw, jw, 1e-5, 1e-6, "w")
    close(trows, jrows, 1e-3, 1e-3 * np.abs(jrows).max(), "rows")

    def row_fn(rows, r, w):
        return rows, r, w

    xk_j, xi_j, c_j = jba.joint_ba_step(make_data_mesh(1), row_fn,
                                        tuple(jnp.asarray(a) for a in (jrows, jr, jw)),
                                        (P("data"),) * 3, jk, jm, lam=1e-3)
    xk_t, xi_t, c_t = tba.joint_ba_step("cpu", row_fn,
                                        tuple(torch.from_numpy(a) for a in (jrows, jr, jw)),
                                        jk, jm, lam=1e-3)
    close(c_t, float(c_j), COST_RTOL, 0, "dense cost")
    close_step(xk_t, np.asarray(xk_j), "dense x_keep")
    close_step(xi_t, np.asarray(xi_j), "dense x_img")


def test_apply_delta_and_icp_refresh_match_jax(setup):
    jpack, tpack = setup["jpack"], setup["tpack"]
    jst = setup["states"]["initial"]
    rng = np.random.RandomState(11)
    xk = (1e-3 * rng.randn(jpack.n_keep)).astype(np.float32)
    xi = (1e-3 * rng.randn(jpack.m_pad, 6)).astype(np.float32)
    jnew = jax_state_np(jjb.apply_delta(jpack, jst, xk, xi))
    tnew = tjb.apply_delta(tpack, tjb.state_from_numpy(tpack, jax_state_np(jst)),
                           torch.from_numpy(xk), torch.from_numpy(xi))
    for k, v in jnew.items():
        close(tnew[k], v, 1e-6, 1e-6, k)

    # targets re-found after scene 0's scan 1 moved by 3 cm
    clouds = {}
    rngn = np.random.RandomState(0)
    for si in range(2):
        lv = setup["scenes"][si].problem.levels[0]
        for s in range(2):
            p_ = np.asarray(lv.points)[np.asarray(lv.scan_indices) == s]
            n_ = rngn.randn(len(p_), 3).astype(np.float32)
            clouds[(si, s)] = (p_, n_ / np.linalg.norm(n_, axis=1, keepdims=True))
    st = dict(jst)
    ct = np.asarray(jst["corr_t"]).copy()
    ct[0, 1] = [0.03, 0.0, 0.0]
    st["corr_t"] = jnp.asarray(ct)
    jp2 = jjb.pack_scenes(make_data_mesh(1), setup["scenes"], optimize_intrinsics=True)
    tp2 = tjb.pack_scenes("cpu", port_scenes(setup["scenes"]), optimize_intrinsics=True)
    pt_before = np.asarray(jp2.icp_pt).copy()
    jjb.refresh_icp_correspondences(jp2, st, clouds, max_dist=0.1)
    tjb.refresh_icp_correspondences(tp2, tjb.state_from_numpy(tp2, jax_state_np(st)), clouds,
                                    max_dist=0.1)
    w = np.asarray(jp2.icp_w)
    assert (w > 0).sum() > 100
    assert (np.abs(np.asarray(jp2.icp_pt) - pt_before).max(1) > 0).mean() > 0.2
    np.testing.assert_array_equal(tp2.icp_w.numpy(), w)
    np.testing.assert_array_equal(tp2.icp_pt.numpy(), np.asarray(jp2.icp_pt))
    np.testing.assert_array_equal(tp2.icp_nt.numpy(), np.asarray(jp2.icp_nt))


def test_run_joint_ba_cost_trace_matches_jax(setup):
    """The LM loop from the same start: the same accept / reject pattern
    and cost trace (within 1e-4 relative per iteration), and both recover
    each scene's scan-1 perturbation as the JAX test demands."""
    scenes = setup["scenes"]
    jpack = jjb.pack_scenes(make_data_mesh(1), scenes, optimize_intrinsics=False)
    tpack = tjb.pack_scenes("cpu", port_scenes(scenes), optimize_intrinsics=False)
    jres = jjb.run_joint_ba(jpack, max_iterations=4, lam0=1.0, refresh_visibility_every=0)
    tres = tjb.run_joint_ba(tpack, max_iterations=4, lam0=1.0, refresh_visibility_every=0)
    assert tres.iterations == jres.iterations and tres.rows == jres.rows
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-4)
    assert tres.costs[-1] < tres.costs[0]
    from dataset_pipeline_tpu_torch.models.lie import SE3

    for si, (d_scan, _) in enumerate(setup["gt"]):
        corr = SE3(tres.state["corr_q"][si, 1], tres.state["corr_t"][si, 1])
        d = SE3(torch.from_numpy(np.asarray(d_scan.q)), torch.from_numpy(np.asarray(d_scan.t)))
        err_after = float(torch.linalg.norm(corr.compose(d).log()))
        err_before = float(torch.linalg.norm(d.log()))
        assert err_after < 0.6 * err_before, (si, err_before, err_after)
