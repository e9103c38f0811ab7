"""JointBA: joint multi-scene scan+image bundle adjustment (Schur).

Port of ``dataset_pipeline_tpu/tools/joint_ba.py`` with the same flags plus
``--device`` (default ``cuda``; it raises when CUDA is absent instead of
running on the CPU). Several scenes sharing ONE camera are optimized jointly
over [shared intrinsics | per-scene free scan poses | per-image poses], with
photometric descriptor rows and symmetric point-to-plane ICP rows produced on
the device and reduced through a Schur complement (``parallel/joint_ba.py``).
Scenes whose state dir holds ``rigs.json`` take the rig route
(``parallel/joint_ba_rig.py``).

Each ``--scene`` is ``mlp_path,colmap_state_dir,image_base_path``. Outputs,
per scene: ``scene_<i>/scan_alignment.mlp`` (the corrected scan poses,
rewritten after every iteration), the COLMAP state (image poses + shared
intrinsics) and ``metadata.txt`` with the LM cost trace; ``timing.json`` at
the output root.

``--devices N`` (0, the default: every card of the host, one on the CPU)
or ``--mesh HxD`` shard the images (frames on the rig route) and the ICP
rows over N (H x D) ranks, one process per device; S, rhs, cost and count
are summed over the ranks and every rank applies the same update. Without
the ``DPT_*`` environment the tool starts the ranks on this host itself and
returns when they end; under it, this process is one rank of a run launched
elsewhere, and ``--devices`` must be 0 or the world size. Rank 0 alone
writes the output files and ``timing.json`` (each JAX process writes them).

Run: ``python -m dataset_pipeline_tpu_torch.tools.joint_ba --scene
a.mlp,a_state,a_images --scene b.mlp,b_state,b_images --output_folder_path
out [--device cpu] [--devices 2]``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.io.scans import load_scan_set, write_scan_poses
from dataset_pipeline_tpu_torch.io.state import ImageState, ModelState, load_colmap_state, save_colmap_state
from dataset_pipeline_tpu_torch.models.lie import SE3, quat_to_matrix_np
from dataset_pipeline_tpu_torch.ops.knn import build_grid, knn_adaptive, nearest_neighbor
from dataset_pipeline_tpu_torch.ops.normals import _normals_from_neighbors
from dataset_pipeline_tpu_torch.parallel.ba import JointScene
from dataset_pipeline_tpu_torch.parallel.joint_ba import (
    pack_scenes,
    refresh_icp_correspondences,
    run_joint_ba,
)
from dataset_pipeline_tpu_torch.parallel.mesh import cli_mesh, launch, ranks_to_launch
from dataset_pipeline_tpu_torch.parallel.joint_ba_rig import (
    RigJointBASystem,
    apply_rig_delta,
    make_rig_state,
    pack_rig_scenes,
)
from dataset_pipeline_tpu_torch.photometric.multiscale import build_multiscale_cloud
from dataset_pipeline_tpu_torch.photometric.problem import PhotoProblem, build_photo_level
from dataset_pipeline_tpu_torch.photometric.rig import assign_rigs_from_state_dir, mark_rig_groups
from dataset_pipeline_tpu_torch.tools.image_registrator import load_groups
from dataset_pipeline_tpu_torch.utils.params import Parameters
from dataset_pipeline_tpu_torch.utils.timing import StageTimer


def scan_normals(points: np.ndarray, origin: np.ndarray, k: int, device) -> np.ndarray:
    """PCA normals of one scan from its exact k nearest neighbours, flipped
    toward the scan origin. The JAX tool takes the brute-force kNN; the
    port's ``knn_adaptive`` is that brute force up to 20,000 points and an
    exact grid search above, where the brute force's (Q, N) distance blocks
    would not fit on the card."""
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    _, idx = knn_adaptive(pts, pts, k + 1)
    vp = torch.as_tensor(np.asarray(origin, np.float32), device=device).expand(pts.shape)
    normals, _ = _normals_from_neighbors(pts, pts, idx[:, 1:], vp)  # idx[:, 0] is the point
    return normals.cpu().numpy()


def icp_correspondences(scan_pts, normals, max_corr_dist: float, device):
    """Cross-scan ICP correspondences in the initial state: for every ordered
    pair of overlapping scans (i, j), each point of i's nearest point of j
    within ``max_corr_dist`` (the grid search of ``ops/knn.py``). Returns
    (ps, ns, pt, nt, src, tgt) numpy, or None."""
    cols = {k: [] for k in ("ps", "ns", "pt", "nt", "src", "tgt")}
    grids = {}
    S = len(scan_pts)
    for i in range(S):
        for j in range(S):
            if i == j:
                continue
            lo = scan_pts[i].min(0) - max_corr_dist
            hi = scan_pts[i].max(0) + max_corr_dist
            if (scan_pts[j].min(0) > hi).any() or (scan_pts[j].max(0) < lo).any():
                continue
            if j not in grids:
                grids[j] = build_grid(torch.as_tensor(scan_pts[j], device=device), max_corr_dist)
            d2, idx = (x.cpu().numpy() for x in nearest_neighbor(
                grids[j], torch.as_tensor(scan_pts[i], device=device)))
            keep = (idx >= 0) & (d2 <= max_corr_dist ** 2)
            if not keep.any():
                continue
            si_ = np.nonzero(keep)[0]
            ti_ = idx[keep]
            cols["ps"].append(scan_pts[i][si_])
            cols["ns"].append(normals[i][si_])
            cols["pt"].append(scan_pts[j][ti_])
            cols["nt"].append(normals[j][ti_])
            cols["src"].append(np.full(len(si_), i, np.int32))
            cols["tgt"].append(np.full(len(si_), j, np.int32))
    if not cols["ps"]:
        return None
    return tuple(np.concatenate(cols[k]) for k in ("ps", "ns", "pt", "nt", "src", "tgt"))


def build_scene(mlp_path: str, state_dir: str, image_base: str, params, point_level: int,
                max_corr_dist: float, icp_weight: float, normal_k: int, device,
                timer: StageTimer):
    """One JointScene: the scene's photometric problem (a single group, or
    one group per rig camera) + cross-scan ICP correspondences found once,
    in the initial state. Returns (scene, scans, state, scan points, normals
    or None)."""
    scans = load_scan_set(mlp_path)
    state = load_colmap_state(state_dir, scans.scale_factor, device=device)
    rig_infos = assign_rigs_from_state_dir(state, state_dir)
    groups, global_count = load_groups(state, image_base, device)
    rig_extr = []
    if len(groups) != 1:
        rig_extr = mark_rig_groups(state, groups, rig_infos, device)
        dependents = sum(1 for g_ in groups if g_.rig_cam_index > 0)
        if dependents != len(groups) - 1:
            raise SystemExit("joint_ba: multi-group scenes must form one rig via rigs.json "
                             f"({mlp_path}: {len(groups)} groups, {dependents} rig-dependent)")
        groups = sorted(groups, key=lambda g_: g_.rig_cam_index)
    g = groups[0]

    scan_pts = [scans.global_positions(i) for i in range(len(scans.infos))]
    scan_cols = [scans.clouds[i].colors if scans.clouds[i].colors is not None
                 else np.zeros((len(scan_pts[i]), 3), np.uint8) for i in range(len(scans.infos))]
    all_pts = np.concatenate(scan_pts)
    scan_idx = np.concatenate([np.full(len(p_), i, np.uint8) for i, p_ in enumerate(scan_pts)])

    with timer.stage("build_scene.merge"):
        levels_raw = build_multiscale_cloud(
            all_pts, np.concatenate(scan_cols), scan_idx, g.poses, g.camera, global_count,
            min_radius_bias=params.min_radius_bias,
            merge_distance_factor=params.merge_distance_factor,
            occlusion_threshold=params.occlusion_depth_threshold)
    if point_level >= 0:
        levels_raw = [levels_raw[min(point_level, len(levels_raw) - 1)]]
    levels = []
    with timer.stage("build_scene.neighbors"):
        for li, lr in enumerate(levels_raw):
            lv = build_photo_level(lr, k=params.point_neighbor_count, seed=li,
                                   num_candidates=params.point_neighbor_candidate_count,
                                   min_mean_diff=params.min_mean_intensity_difference_for_points,
                                   device=device)
            if lv is not None:
                levels.append(lv)
    if not levels:
        raise SystemExit(f"joint_ba: no usable point level in {mlp_path} after the gradient filter")

    problem = PhotoProblem(
        groups=groups, levels=levels,
        occlusion_points=torch.as_tensor(all_pts.astype(np.float32), device=device),
        occlusion_radius=params.splat_radius, scale_count=global_count,
        occlusion_depth_threshold=params.occlusion_depth_threshold, rig_extrinsics=rig_extr)

    icp = normals = None
    if len(scan_pts) > 1 and max_corr_dist > 0:
        with timer.stage("build_scene.normals"):
            normals = [scan_normals(p_, scans.scan_origin(i), normal_k, device)
                       for i, p_ in enumerate(scan_pts)]
        with timer.stage("build_scene.icp_nn"):
            icp = icp_correspondences(scan_pts, normals, max_corr_dist, device)
    return JointScene(problem, 0, icp, icp_weight=icp_weight), scans, state, scan_pts, normals


def parse_args(argv=None):
    """The CLI's (args, Parameters)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", action="append", required=True, metavar="MLP,STATE_DIR,IMAGE_BASE",
                   help="repeatable: one scene's scan alignment .mlp, COLMAP state dir and "
                        "image base path")
    p.add_argument("--output_folder_path", required=True)
    p.add_argument("--max_iterations", type=int, default=20)
    p.add_argument("--lambda0", type=float, default=1.0)
    p.add_argument("--start_scale", type=int, default=0,
                   help="coarse-to-fine: run the LM schedule at image scales start_scale..0 "
                        "(state carried across scales; 0 = single finest-scale run)")
    p.add_argument("--point_level", type=int, default=-1,
                   help="restrict the joint rows to ONE multi-res point level (-1 = all "
                        "levels, per-point footprint radii)")
    p.add_argument("--max_corr_distance", type=float, default=0.1,
                   help="ICP correspondence gate (normalized units); 0 disables ICP rows")
    p.add_argument("--icp_weight", type=float, default=30.0)
    p.add_argument("--normal_estimation_neighbor_count", type=int, default=8)
    p.add_argument("--fix_intrinsics", action="store_true")
    p.add_argument("--devices", type=int, default=0,
                   help="1-D mesh size, one rank per device (0 = all available devices)")
    p.add_argument("--mesh", default="",
                   help='2-axis topology "HxD" (hosts x devices); overrides --devices. '
                        "Example: --mesh 2x4")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    return args, Parameters.from_args(args)


def _scene_images(sc, pose_q, pose_t, base: int, state_params, extr, fix_intrinsics: bool,
                  rig_mode: bool):
    """{image id: (q, t, camera)} of one scene's images under the result."""
    out = {}
    groups = sorted(sc.problem.groups, key=lambda g_: g_.rig_cam_index)
    if not rig_mode:
        g = groups[0]
        cam = g.camera if fix_intrinsics else g.camera.with_params(state_params)
        for k, iid in enumerate(g.image_ids):
            out[iid] = (pose_q[base + k], pose_t[base + k], cam)
        return out
    eq, et = extr
    for c, g in enumerate(groups):
        cam = g.camera if fix_intrinsics else g.camera.with_params(state_params[c])
        for k, iid in enumerate(g.image_ids):
            slot = base + k if c == 0 else base + int(g.ref_slots[k])
            q_, t_ = pose_q[slot], pose_t[slot]
            if c > 0:
                Re = quat_to_matrix_np(eq[c])
                M = np.eye(4)
                M[:3, :3] = Re @ quat_to_matrix_np(q_)
                M[:3, 3] = Re @ t_ + et[c]
                # the dependent pose goes through SE3.from_matrix in float32, as in JAX
                se = SE3.from_matrix(torch.as_tensor(M[None], dtype=torch.float32))
                q_ = se.q[0].double().numpy()
                t_ = se.t[0].double().numpy()
            out[iid] = (q_, t_, cam)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args, params = parse_args(argv)
    device = resolve_device(args.device)
    n_ranks = ranks_to_launch(args.devices, args.mesh, device)
    if n_ranks:
        return max(rc for rc, _ in launch(main, n_ranks, (argv,), device))
    mesh = cli_mesh(args.devices, args.mesh, device)
    writes = mesh is None or mesh.rank == 0
    if mesh is None:
        print(f"device: {device}")
    else:
        device = mesh.device
        print(f"mesh {dict(zip(mesh.axis_names, mesh.shape))} over {mesh.backend}, one rank per "
              f"device ({device} here)")
    timer = StageTimer(device)

    scenes, metas, clouds = [], [], {}
    for spec in args.scene:
        parts = spec.split(",")
        if len(parts) != 3:
            raise SystemExit(f"--scene must be MLP,STATE_DIR,IMAGE_BASE: {spec}")
        with timer.stage("build_scene"):
            sc, scans, state, scan_pts, normals = build_scene(
                parts[0], parts[1], parts[2], params, args.point_level, args.max_corr_distance,
                args.icp_weight, args.normal_estimation_neighbor_count, device, timer)
        si = len(scenes)
        if normals is not None:
            for s in range(len(scan_pts)):
                clouds[(si, s)] = (scan_pts[s], normals[s])
        scenes.append(sc)
        metas.append((scans, state))
        n_icp = 0 if sc.icp is None else len(sc.icp[0])
        print(f"scene {si}: {sc.num_scans} scans, {sc.num_images} images, "
              f"{sum(int(l.points.shape[0]) for l in sc.problem.levels)} points "
              f"({len(sc.problem.levels)} levels), {n_icp} ICP correspondences")

    rig_mode = any(len(sc.problem.groups) > 1 for sc in scenes)
    cam0 = scenes[0].problem.groups[0].camera
    for sc in scenes[1:]:
        c = sc.problem.groups[0].camera
        if c.model != cam0.model or c.width != cam0.width or c.height != cam0.height:
            raise SystemExit("joint_ba: scenes must share one camera model/size "
                             "(shared-intrinsics kept block)")

    with timer.stage("pack_scenes"):
        pack_fn = pack_rig_scenes if rig_mode else pack_scenes
        pack = pack_fn(device if mesh is None else mesh, scenes,
                       optimize_intrinsics=not args.fix_intrinsics,
                       occlusion_radius=params.splat_radius,
                       occlusion_depth_threshold=params.occlusion_depth_threshold)
    if rig_mode:
        print(f"packed (rig): n_keep={pack.n_keep} cams={pack.n_cams} frames={pack.n_frames} "
              f"(pad {pack.f_pad}) icp_rows={2 * pack.n_icp}")
    else:
        print(f"packed: n_keep={pack.n_keep} images={pack.n_images} (pad {pack.m_pad}) "
              f"icp_rows={2 * pack.n_icp}")

    icp_refresh = None
    if clouds and args.max_corr_distance > 0 and pack.n_icp > 0:
        def icp_refresh(pk, st):
            refresh_icp_correspondences(pk, st, clouds, args.max_corr_distance)

    if writes:
        os.makedirs(args.output_folder_path, exist_ok=True)

    def write_mlps(st):
        # rewritten every iteration, so that a killed run leaves usable scan poses
        if not writes:
            return
        cq = st["corr_q"].double().cpu().numpy()
        ct = st["corr_t"].double().cpu().numpy()
        for si2, (scans2, _) in enumerate(metas):
            out2 = os.path.join(args.output_folder_path, f"scene_{si2}")
            os.makedirs(out2, exist_ok=True)
            mats = []
            for s in range(len(scans2.infos)):
                Cm = np.eye(4)
                Cm[:3, :3] = quat_to_matrix_np(cq[si2, s])
                Cm[:3, 3] = ct[si2, s]
                mats.append(Cm @ scans2.global_matrix(s))
            write_scan_poses(os.path.join(out2, "scan_alignment.mlp"), scans2, mats)

    with timer.stage("joint_ba"):
        state, costs_all = None, []
        for scale in range(max(args.start_scale, 0), -1, -1):
            if args.start_scale > 0:
                print(f"scale {scale}:")
            kw = dict(max_iterations=args.max_iterations, lam0=args.lambda0,
                      icp_refresh_fn=icp_refresh, print_progress=True, timer=timer,
                      on_iteration=lambda it, st, c: write_mlps(st))
            if rig_mode:
                res = run_joint_ba(pack, system=RigJointBASystem(pack, float(scale), timer),
                                   state=state or make_rig_state(pack), apply_fn=apply_rig_delta,
                                   **kw)
            else:
                res = run_joint_ba(pack, current_scale=float(scale), state=state, **kw)
            state = res.state
            costs_all += res.costs
        res.costs = costs_all
    print(f"joint BA: {res.iterations} iterations, {res.rows} rows, "
          f"cost {res.costs[0]:.6f} -> {res.costs[-1]:.6f}")

    write_mlps(res.state)
    if not writes:
        return 0
    pose_q = res.state["pose_q"].double().cpu().numpy()
    pose_t = res.state["pose_t"].double().cpu().numpy()
    extr = ((res.state["extr_q"].double().cpu().numpy(), res.state["extr_t"].double().cpu().numpy())
            if rig_mode else None)
    img_base_idx = 0
    for si, (sc, (scans, state)) in enumerate(zip(scenes, metas)):
        out = os.path.join(args.output_folder_path, f"scene_{si}")
        os.makedirs(out, exist_ok=True)
        by_id = _scene_images(sc, pose_q, pose_t, img_base_idx, res.state["params"], extr,
                              args.fix_intrinsics, rig_mode)
        rows, cams = [], dict(state.cameras)
        for im in state.images:
            if im.image_id not in by_id:
                continue
            q_, t_, cam = by_id[im.image_id]
            rows.append(ImageState(im.image_id, im.camera_id, im.name, q_, t_))
            cams[im.camera_id] = cam
        save_colmap_state(out, ModelState(cams, rows, state.scale_factor))
        with open(os.path.join(out, "metadata.txt"), "w") as f:
            f.write(f"iterations {res.iterations}\n")
            f.write(f"rows {res.rows}\n")
            f.write("costs " + " ".join(f"{c:.8g}" for c in res.costs) + "\n")
            for line in params.dump().splitlines():
                f.write(line + "\n")
        img_base_idx += min(sc.problem.groups, key=lambda g_: g_.rig_cam_index).num_images
        print(f"scene {si} -> {out}")
    print("stage timing:\n" + timer.summary())
    timer.dump_json(os.path.join(args.output_folder_path, "timing.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
