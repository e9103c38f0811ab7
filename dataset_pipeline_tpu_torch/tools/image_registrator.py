"""ImageRegistrator: dense photometric pose + intrinsics refinement.

Port of ``dataset_pipeline_tpu/tools/image_registrator.py`` with the same
flags plus ``--device`` (default ``cuda``; it raises when CUDA is absent
instead of running on the CPU). Loads the scan alignment (.mlp), the
occlusion geometry (splat points, or a mesh with ``--occlusion_mesh_path``,
whose faces ``--occlusion_splats_path`` extends), camera groups and poses from
a COLMAP state dir (with camera rigs when the dir holds ``rigs.json``),
builds the multi-resolution point cloud (or loads it from
``--multi_res_point_cloud_directory_path``, which also caches the point
neighbours), and runs the coarse-to-fine photometric optimizer, exporting a
COLMAP state dir ``scale_<f>_state`` with a ``metadata.txt`` parameter dump
(and ``rigs.json``) after every completed image scale, and ``timing.json`` at
the end (each scale's optimisation is traced with ``torch.profiler`` into
``$DPT_TRACE_DIR`` when that is set, the optimizer's stages and the spans
inside its H,b accumulation timed and named in the trace).
``--cache_observations`` compacts each
image's candidate points after the first scale (kept beside the cloud cache
when there is one);
``--write_debug_point_clouds`` writes ``initial_point_cloud.ply`` coloured
from the initial state. ``--depth_residuals_weight`` is passed to the
optimizer, which, as in the JAX tool, is given no depth maps here.

``--devices N`` (0 = every card of the host) or ``--mesh HxD`` shard each
image chunk's H,b accumulation over N (H x D) ranks, one process per device
(``parallel/photometric.py``); visibility, costs and the solve stay
replicated. Without the ``DPT_*`` environment the tool starts the ranks on
this host itself and returns when they end; under it, this process is one
rank of a run launched elsewhere, and ``--devices`` must be 0 or the world
size. Rank 0 alone writes the output states, the debug cloud, the caches
and ``timing.json`` (each JAX process writes them); with a cache dir the
other ranks set up after it, from its files.

Run: ``python -m dataset_pipeline_tpu_torch.tools.image_registrator
--scan_alignment_path scans.mlp --image_base_path images --state_path state
--output_folder_path out [--device cpu] [--devices 2]``.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.io.colmap import read_rigs_json, write_rigs_json
from dataset_pipeline_tpu_torch.io.image import read_gray, read_rgb
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.io.scans import load_scan_set
from dataset_pipeline_tpu_torch.io.state import ImageState, ModelState, load_colmap_state, save_colmap_state
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3, quat_to_matrix
from dataset_pipeline_tpu_torch.ops.mesh_raster import build_occlusion_mesh
from dataset_pipeline_tpu_torch.parallel.mesh import cli_mesh, launch, ranks_to_launch
from dataset_pipeline_tpu_torch.photometric.cache import (
    load_multiscale_cache,
    load_photo_levels_cache,
    save_multiscale_cache,
    save_photo_levels_cache,
)
from dataset_pipeline_tpu_torch.photometric.masks import build_mask_pyramid, combined_mask
from dataset_pipeline_tpu_torch.photometric.multiscale import build_multiscale_cloud
from dataset_pipeline_tpu_torch.photometric.optimizer import PhotometricOptimizer
from dataset_pipeline_tpu_torch.photometric.rig import assign_rigs, mark_rig_groups
from dataset_pipeline_tpu_torch.photometric.problem import (
    ImageGroup,
    PhotoProblem,
    build_image_pyramid,
    build_photo_level,
    image_scale_count,
)
from dataset_pipeline_tpu_torch.utils.params import Parameters
from dataset_pipeline_tpu_torch.utils.profiling import device_trace
from dataset_pipeline_tpu_torch.utils.timing import StageTimer


def _pose_matrix(im: ImageState) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix(torch.as_tensor(np.asarray(im.qvec, np.float32))).numpy()
    T[:3, 3] = im.tvec
    return T


def load_groups(state: ModelState, image_base_path: str, device):
    """Group images by camera id; load grayscale pyramids onto ``device``."""
    by_cam = defaultdict(list)
    for im in state.images:
        if not os.path.exists(os.path.join(image_base_path, im.name)):
            print(f"warning: image file missing, skipping: {im.name}")
            continue
        by_cam[im.camera_id].append(im)

    group_descs = []
    global_count = 1
    for cid in sorted(by_cam):
        cam = state.cameras[cid]
        count = image_scale_count(cam.width, cam.height)
        global_count = max(global_count, count)
        group_descs.append((cid, cam, by_cam[cid], count))

    groups = []
    for cid, cam, ims, count in group_descs:
        grays, poses_mats, ids, masks = [], [], [], []
        any_mask = False
        for im in ims:
            img = read_gray(os.path.join(image_base_path, im.name))
            if img.shape != (cam.height, cam.width):
                raise ValueError(f"{im.name}: image is {img.shape}, camera expects "
                                 f"({cam.height},{cam.width})")
            grays.append(img.astype(np.uint8))
            poses_mats.append(_pose_matrix(im))
            ids.append(im.image_id)
            m = combined_mask(image_base_path, im.name, img.shape)
            any_mask |= m is not None
            masks.append(m if m is not None else np.zeros(img.shape, np.uint8))
        pyramid = build_image_pyramid(np.stack(grays), count, device=device)
        poses = SE3.from_matrix(torch.as_tensor(np.stack(poses_mats), dtype=torch.float32,
                                                device=device))
        mask_pyr = build_mask_pyramid(np.stack(masks), count, device=device) if any_mask else None
        groups.append(ImageGroup(camera=cam.to(device), pyramid=pyramid, poses=poses,
                                 image_ids=ids, min_image_scale=global_count - count,
                                 mask_pyramid=mask_pyr))
    return groups, global_count


def export_state(path: str, opt: PhotometricOptimizer, state: ModelState, metadata: dict):
    cam_by_id = dict(state.cameras)
    id_to_group = {}
    for g in opt.p.groups:
        for bi, iid in enumerate(g.image_ids):
            id_to_group[iid] = (g, bi)
    img_rows = []
    for im in state.images:
        g, bi = id_to_group[im.image_id]
        q = g.poses.q[bi].detach().cpu().numpy().astype(np.float64)
        t = g.poses.t[bi].detach().cpu().numpy().astype(np.float64)
        img_rows.append(ImageState(im.image_id, im.camera_id, im.name, q, t))
        cam_by_id[im.camera_id] = g.camera
    save_colmap_state(path, ModelState(cam_by_id, img_rows, state.scale_factor))
    with open(os.path.join(path, "metadata.txt"), "w") as f:
        for k, v in metadata.items():
            f.write(f"{k} {v}\n")


def write_debug_colored_cloud(path: str, opt: PhotometricOptimizer, points: np.ndarray,
                              image_base_path: str, state: ModelState) -> None:
    """Coloured debug point cloud under the current state: every occlusion
    point is projected into every image (with the occlusion z-test), the
    colour photograph is sampled bilinearly and averaged over the observing
    images (host float64, as in the JAX tool); unobserved points stay black."""
    id_to_name = {im.image_id: im.name for im in state.images}
    pts = torch.as_tensor(np.asarray(points, np.float32), device=opt.device)
    n = len(points)
    sums = np.zeros((n, 3), np.float64)
    counts = np.zeros(n, np.int64)
    occl = opt._occlusion_depths()
    thresh = opt.p.occlusion_depth_threshold
    for gi, g in enumerate(opt.p.groups):
        cam = g.camera
        for b, iid in enumerate(g.image_ids):
            rgb = read_rgb(os.path.join(image_base_path, id_to_name[iid])).astype(np.float64)
            p_cam = SE3(g.poses.q[b], g.poses.t[b]).apply(pts)
            pix, ok = cm.project(cam, p_cam)
            p_cam, pix, ok = p_cam.cpu().numpy(), pix.cpu().numpy(), ok.cpu().numpy()
            z = p_cam[:, 2]
            x, y = pix[:, 0], pix[:, 1]
            x0 = np.floor(x).astype(np.int64)
            y0 = np.floor(y).astype(np.int64)
            vis = (ok & (z > 0) & (x0 >= 0) & (y0 >= 0)
                   & (x0 + 1 < cam.width) & (y0 + 1 < cam.height))
            od = occl[gi][b].cpu().numpy()
            ix = np.clip(np.floor(x + 0.5).astype(np.int64), 0, cam.width - 1)
            iy = np.clip(np.floor(y + 0.5).astype(np.int64), 0, cam.height - 1)
            vis &= np.nan_to_num(od[iy, ix], nan=-np.inf) + thresh >= z
            fx_ = (x - x0)[vis, None]
            fy_ = (y - y0)[vis, None]
            xv, yv = x0[vis], y0[vis]
            sums[vis] += ((1 - fx_) * (1 - fy_) * rgb[yv, xv] + fx_ * (1 - fy_) * rgb[yv, xv + 1]
                          + (1 - fx_) * fy_ * rgb[yv + 1, xv] + fx_ * fy_ * rgb[yv + 1, xv + 1])
            counts[vis] += 1
    colors = np.zeros((n, 3), np.uint8)
    obs = counts > 0
    colors[obs] = np.clip(sums[obs] / counts[obs, None] + 0.5, 0, 255).astype(np.uint8)
    write_ply(path, PointCloud(np.asarray(points, np.float32), None, colors))


def parse_args(argv=None):
    """The CLI's (args, Parameters)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scan_alignment_path", required=True)
    p.add_argument("--occlusion_mesh_path", default="")
    p.add_argument("--occlusion_splats_path", default="")
    p.add_argument("--image_base_path", required=True)
    p.add_argument("--state_path", required=True)
    p.add_argument("--output_folder_path", required=True)
    p.add_argument("--max_iterations", type=int, default=400)
    p.add_argument("--initial_scaling_factor", type=float, default=0.0,
                   help="resume: start the schedule at this scaling factor (e.g. 0.25);"
                        " 0 = coarsest usable scale")
    p.add_argument("--target_scaling_factor", type=float, default=1.0,
                   help="stop after optimizing this scaling factor")
    p.add_argument("--camera_ids_to_ignore", default="")
    p.add_argument("--fix_intrinsics", action="store_true")
    p.add_argument("--multi_res_point_cloud_directory_path", default="",
                   help="cache dir for the multi-resolution point cloud")
    p.add_argument("--write_debug_point_clouds", action="store_true",
                   help="write initial_point_cloud.ply coloured from the initial state")
    p.add_argument("--cache_observations", action="store_true",
                   help="after the first scale, compact per-image candidate point views and "
                        "persist them next to the multi-res cloud cache")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the photometric H,b accumulation over a mesh of this many "
                        "devices, one rank each (0 = all available); images are the sharded "
                        "axis (parallel/photometric.py)")
    p.add_argument("--mesh", default="",
                   help='2-axis mesh topology "HxD" (hosts x devices per host): shards the '
                        "image axis over both axes; overrides --devices. E.g. 2x4")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    return args, Parameters.from_args(args)


def _occlusion_geometry(args, all_pts, device):
    """(occlusion mesh or None, occlusion points): the mesh (with the faces
    of ``--occlusion_splats_path`` added) when one is given, else the splat
    points or the scans' points."""
    if args.occlusion_mesh_path:
        mesh_pc = read_ply(args.occlusion_mesh_path)
        verts, faces = [mesh_pc.positions], [mesh_pc.faces]
        if args.occlusion_splats_path:
            sp = read_ply(args.occlusion_splats_path)
            if sp.faces is not None:
                faces.append(sp.faces + len(np.concatenate(verts)))
                verts.append(sp.positions)
        mesh = build_occlusion_mesh(np.concatenate(verts), np.concatenate(faces), device=device)
        print(f"occlusion mesh: {sum(len(v) for v in verts)} vertices, "
              f"{sum(len(f) for f in faces)} faces")
        return mesh, all_pts
    if args.occlusion_splats_path:
        return None, read_ply(args.occlusion_splats_path).positions
    return None, all_pts


def build_problem(args, params: Parameters, device, timer: StageTimer,
                  stats: dict | None = None, writes: bool = True):
    """The set-up stages: scans, rigs, images and poses, the occlusion
    geometry, the multi-resolution cloud and the point levels (from the
    cache dir when it holds them; ``writes`` saves what was built there).
    Returns (problem, state, scans, the rig configurations of ``rigs.json``
    or [])."""
    ignore = {int(v) for v in args.camera_ids_to_ignore.split(",") if v}
    with timer.stage("load_scans"):
        scans = load_scan_set(args.scan_alignment_path)
    state = load_colmap_state(args.state_path, scans.scale_factor, ignore, device=device)

    # rigs: make the poses consistent before the groups copy them
    rigs_path = os.path.join(args.state_path, "rigs.json")
    rig_configs = read_rigs_json(rigs_path) if os.path.exists(rigs_path) else []
    rig_infos = assign_rigs(state, rig_configs) if rig_configs else []
    if rig_infos:
        print(f"{len(rig_infos)} rig(s) assigned")
    groups, global_count = load_groups(state, args.image_base_path, device)
    rig_extrinsics = mark_rig_groups(state, groups, rig_infos, device) if rig_infos else []
    print(f"{len(groups)} camera groups, {sum(g.num_images for g in groups)} images, "
          f"{global_count} image scales")

    scan_pts = [scans.global_positions(i) for i in range(len(scans.infos))]
    scan_cols = [scans.clouds[i].colors if scans.clouds[i].colors is not None
                 else np.zeros((len(scan_pts[i]), 3), np.uint8)
                 for i in range(len(scans.infos))]
    all_pts = np.concatenate(scan_pts)
    all_cols = np.concatenate(scan_cols)
    scan_idx = np.concatenate([np.full(len(p_), i, np.uint8) for i, p_ in enumerate(scan_pts)])
    occlusion_mesh, occl = _occlusion_geometry(args, all_pts, device)

    # multi-scale cloud: radii judged against all images, largest camera
    all_poses = SE3(torch.cat([g.poses.q for g in groups]),
                    torch.cat([g.poses.t for g in groups]))
    largest = max((g.camera for g in groups), key=lambda c: c.width * c.height)
    cache_dir = args.multi_res_point_cloud_directory_path
    cache_params = {"num_points": int(len(all_pts)), "scale_count": int(global_count),
                    "num_images": int(sum(g.num_images for g in groups))}
    levels_raw = load_multiscale_cache(cache_dir, cache_params) if cache_dir else None
    if levels_raw is not None:
        print("loaded multi-resolution point cloud from cache")
    else:
        with timer.stage("build_multiscale_cloud"):
            levels_raw = build_multiscale_cloud(
                all_pts, all_cols, scan_idx, all_poses, largest, global_count,
                min_radius_bias=params.min_radius_bias,
                merge_distance_factor=params.merge_distance_factor,
                occlusion_threshold=params.occlusion_depth_threshold)
        if cache_dir and writes:
            save_multiscale_cache(cache_dir, levels_raw, cache_params)
    levels = load_photo_levels_cache(cache_dir, cache_params, device) if cache_dir else None
    if levels is not None:
        print("loaded point neighbors/descriptors from cache")
    else:
        levels = []
        with timer.stage("determine_point_neighbors"):
            for i, lv in enumerate(levels_raw):
                pl = build_photo_level(lv, k=params.point_neighbor_count, seed=i,
                                       num_candidates=params.point_neighbor_candidate_count,
                                       min_mean_diff=params.min_mean_intensity_difference_for_points,
                                       device=device)
                if pl is not None:
                    levels.append(pl)
        if cache_dir and writes:
            save_photo_levels_cache(cache_dir, levels, cache_params)
    print(f"{len(levels)} point levels: " + ", ".join(str(len(l.points)) for l in levels))
    if stats is not None:
        stats.update(levels=[len(l.points) for l in levels], scales=[])

    problem = PhotoProblem(
        groups=groups, levels=levels,
        occlusion_points=torch.as_tensor(np.asarray(occl, np.float32), device=device),
        occlusion_radius=params.splat_radius, scale_count=global_count,
        max_valid_intensity=params.maximum_valid_intensity,
        occlusion_depth_threshold=params.occlusion_depth_threshold,
        rig_extrinsics=rig_extrinsics, occlusion_mesh=occlusion_mesh)
    return problem, state, scans, rig_configs


def make_optimizer(problem: PhotoProblem, args, params: Parameters,
                   timings: dict | None = None, mesh=None) -> PhotometricOptimizer:
    return PhotometricOptimizer(
        problem, optimize_intrinsics=not args.fix_intrinsics,
        fixed_weight=params.fixed_residuals_weight,
        variable_weight=params.variable_residuals_weight,
        depth_weight=params.depth_residuals_weight, timings=timings, mesh=mesh)


def _rank(argv):
    """One rank of a run that ``main`` started: (exit code, timings, stats)."""
    timings, stats = {}, {}
    return main(argv, timings, stats), timings, stats


def main(argv=None, timings: dict | None = None, stats: dict | None = None) -> int:
    """Run the tool. ``timings``, if given, collects the optimizer's
    per-stage seconds (occlusion, visibility, hb_accumulate, ...); ``stats``
    receives the level sizes and, per scale, the observations and entry
    cost of every iteration, the optimum cost and the observations cache's
    hit rate. In a rank of a mesh ``stats["collectives"]`` holds the
    backend and the mesh's collective calls and seconds. When this call
    starts the ranks itself, both come from rank 0, and ``stats["ranks"]``
    holds every rank's timings, kernel launches and collectives."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args, params = parse_args(argv)
    device = resolve_device(args.device)
    n_ranks = ranks_to_launch(args.devices, args.mesh, device)
    if n_ranks:
        results = launch(_rank, n_ranks, (argv,), device)
        (rc, t0, s0), _ = results[0]
        if timings is not None:
            timings.update(t0)
        if stats is not None:
            stats.update(s0, ranks=[dict(timings=t, launches=launches, collectives=s["collectives"])
                                    for (_, t, s), launches in results])
        return max(r[0][0] for r in results)
    mesh = cli_mesh(args.devices, args.mesh, device)
    writes = mesh is None or mesh.rank == 0
    if mesh is not None:
        device = mesh.device
        if writes:
            print(f"mesh {dict(zip(mesh.axis_names, mesh.shape))} over {mesh.backend}, "
                  f"one rank per device ({device} here)")
    timer = StageTimer(device)
    # caches: rank 0 writes them, and with a cache dir the others load its files
    staged = mesh is not None and mesh.size > 1 and bool(args.multi_res_point_cloud_directory_path)
    if staged and not writes:
        mesh.barrier()
    problem, state, scans, rig_configs = build_problem(args, params, device, timer, stats,
                                                       writes)
    if staged and writes:
        mesh.barrier()
    global_count = problem.scale_count
    if timings is None and os.environ.get("DPT_TRACE_DIR"):
        timings = {}  # so that the trace holds the optimizer's stages and spans
    opt = make_optimizer(problem, args, params, timings, mesh)
    os.makedirs(args.output_folder_path, exist_ok=True)

    if args.write_debug_point_clouds and writes:
        dbg_path = os.path.join(args.output_folder_path, "initial_point_cloud.ply")
        if os.path.exists(dbg_path):
            print("not writing initial point cloud: already exists")
        else:
            write_debug_colored_cloud(dbg_path, opt, problem.occlusion_points.cpu().numpy(),
                                      args.image_base_path, state)
            print(f"wrote {dbg_path}")

    def on_scale_done(o: PhotometricOptimizer, report):
        if not writes:
            return
        factor = 2.0 ** (-o.current_scale)
        out = os.path.join(args.output_folder_path, f"scale_{factor:g}_state")
        meta = {"optimum_cost": report.optimum_cost, "iterations": report.iterations,
                "image_scale": o.current_scale, "scale_factor": scans.scale_factor}
        if o.obs_cache_hit_log:
            # the last core hit rate of the observations cache at this scale
            meta["obs_cache_hit_rate"] = round(o.obs_cache_hit_log[-1], 5)
        meta.update(dict(line.split(" ", 1) for line in params.dump().splitlines()))
        export_state(out, o, state, meta)
        if rig_configs:
            write_rigs_json(os.path.join(out, "rigs.json"), rig_configs)
        print(f"scale {o.current_scale} done (cost {report.optimum_cost:.6f}) -> {out}")

    # coarse-to-fine schedule with optional resume window
    start_scale = global_count - 2
    if args.initial_scaling_factor > 0:
        start_scale = max(0, int(round(-np.log2(args.initial_scaling_factor))))
    end_scale = max(0, int(round(-np.log2(args.target_scaling_factor))))
    opt.current_scale = min(start_scale, global_count - 2)
    first_scale_done = False
    while True:
        costs, observations = [], []
        with device_trace(), timer.stage(f"optimize_scale_{opt.current_scale}"):
            report = opt.run_on_current_scale(args.max_iterations, print_progress=writes,
                                              iteration_costs=costs, observations=observations)
        on_scale_done(opt, report)
        if stats is not None:
            stats["scales"].append(dict(scale=opt.current_scale, iteration_costs=costs,
                                        observations=observations,
                                        optimum_cost=report.optimum_cost,
                                        iterations=report.iterations,
                                        obs_cache_hit_log=list(opt.obs_cache_hit_log)))
        if args.cache_observations and not first_scale_done:
            cache_path = (os.path.join(args.multi_res_point_cloud_directory_path,
                                       "observations_cache.npz")
                          if args.multi_res_point_cloud_directory_path else None)
            with timer.stage("observations_cache"):
                opt.build_observations_cache(save_path=cache_path, load_path=cache_path)
            real, _ = opt.obs_cache.stats()
            total = sum(len(l.points) for l in problem.levels) * problem.num_images
            print(f"observations cache: {real} candidate rows "
                  f"({100.0 * real / max(total, 1):.1f}% of dense)")
        first_scale_done = True
        if opt.current_scale <= end_scale or not opt.next_scale():
            break
    if stats is not None and mesh is not None:
        stats["collectives"] = dict(backend=mesh.backend, calls=mesh.calls, seconds=mesh.seconds)
    if writes:
        print("stage timing:\n" + timer.summary())
        timer.dump_json(os.path.join(args.output_folder_path, "timing.json"))
        print("finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
