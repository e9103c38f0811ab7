"""DatasetInspector (offline): per-image diagnostic renderings and the GUI's
editing tools, headless.

Port of ``dataset_pipeline_tpu/tools/dataset_inspector.py`` (the reference's
Qt DatasetInspector, ``dataset_inspector/gui_main_window.h:47-61``) with the
same flags plus ``--device`` (default ``cuda``; it raises when CUDA is
absent instead of running on the CPU). Writes ``<image>.<mode>.png`` per
image for the ``--modes`` asked:

- ``depth``: the scan points' depths, colormapped (2nd to 98th percentile);
- ``overlay``: the depth points over the photograph;
- ``occlusion``: the splat occlusion depth map;
- ``scan``: the scan colours reprojected (the GUI's scan rendering mode);
- ``cost`` / ``cost_variable`` / ``cost_combined``: the robust per-point
  photometric residuals (fixed / variable / combined) splatted into the
  image, colormapped up to the 98th percentile. They build the
  multi-resolution cloud and the optimizer as the ImageRegistrator does
  (its ``--min_radius_bias``, ``--merge_distance_factor`` and point-level
  flags, whose defaults are the values the JAX tool always uses) and sample
  the pyramids with B3 (``csrc/pyramid_sample.cu``) on the card;
- ``points``: the optimization points visible in the image, one palette
  colour per point scale.

The GUI's tools: ``--localize_image NAME --correspondences FILE`` ("x y X Y Z"
lines, >= 6) refines that image's pose and re-saves the state;
``--nudge_image NAME --nudge "tx ty tz pitch yaw roll"`` applies
``exp(delta) . image_T_global``; ``--transfer_source A --transfer_target B
[--transfer_eval_obs]`` transfers A's mask labels to B through the scan and
writes B's ``masks_for_images`` file. Masks are drawn programmatically with
``photometric.masks.draw_mask_polygons``.

Run: ``python -m dataset_pipeline_tpu_torch.tools.dataset_inspector
--scan_alignment_path s.mlp --state_path state --image_base_path images
--output_folder_path out --modes depth,scan,cost,points [--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.io.image import read_rgb
from dataset_pipeline_tpu_torch.io.scans import load_scan_set
from dataset_pipeline_tpu_torch.io.state import load_colmap_state, save_colmap_state
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3, quat_to_matrix
from dataset_pipeline_tpu_torch.ops.splat import (
    render_points_depth,
    render_points_depth_color,
    render_splats_depth,
)
from dataset_pipeline_tpu_torch.utils.params import Parameters

COST_MODES = {"cost": "fixed", "cost_variable": "variable", "cost_combined": "combined"}
# the GUI's point-scale colours (gui_main_window.h:47-61)
POINT_PALETTE = np.asarray([[66, 135, 245], [52, 199, 89], [255, 204, 0],
                            [255, 59, 48], [175, 82, 222], [90, 200, 250]], np.uint8)


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _colormap(values: torch.Tensor, vmin, vmax) -> np.ndarray:
    """Simple turbo-ish colormap of a (H,W) tensor to uint8 RGB (numpy);
    invalid -> black. The JAX tool's numpy formula, run on the tensor's
    device in the dtypes numpy's promotion picks for these ``vmin`` /
    ``vmax`` types (float64 after a numpy percentile, float32 with Python
    floats), op by op and with true division, so the bytes equal the JAX
    tool's on either device."""
    div = max(vmax - vmin, 1e-9)
    n1 = (np.where([True], np.zeros(1, np.float32), vmin) - vmin).dtype
    d1, d2 = _TORCH_DTYPE[n1], _TORCH_DTYPE[(np.zeros(1, n1) / div).dtype]
    finite = torch.isfinite(values)
    t = torch.clamp(torch.where(finite, values.to(d1), float(vmin)) - float(vmin), min=0)
    # a divisor on the tensor's device: CUDA divides by a host scalar as a product with its
    # reciprocal, which rounds otherwise than numpy's division
    t = torch.clamp(t.to(d2) / torch.tensor(float(div), dtype=d2, device=t.device), 0, 1)
    r = torch.clamp(1.5 - torch.abs(2.0 * t - 1.5), 0, 1)
    g = torch.clamp(1.5 - torch.abs(2.0 * t - 1.0), 0, 1)
    b = torch.clamp(1.5 - torch.abs(2.0 * t - 0.5), 0, 1)
    rgb = (torch.stack([r, g, b], -1) * 255).to(torch.uint8)
    rgb[~finite] = 0
    return rgb.cpu().numpy()


def _percentiles(values: torch.Tensor, q):
    """numpy's percentiles of the finite values (on the host, as the JAX tool)."""
    finite = values[torch.isfinite(values)].cpu().numpy()
    return np.percentile(finite, q) if finite.size else None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scan_alignment_path", required=True)
    p.add_argument("--state_path", required=True)
    p.add_argument("--image_base_path", default="")
    p.add_argument("--output_folder_path", required=True)
    p.add_argument("--modes", default="depth,overlay,occlusion",
                   help="comma list: depth,overlay,occlusion,scan,cost,cost_variable,"
                        "cost_combined,points")
    p.add_argument("--localize_image", default="",
                   help="image name whose pose to refine from clicked 2D-3D correspondences")
    p.add_argument("--correspondences", default="",
                   help="text file of 'x y X Y Z' lines for --localize_image")
    p.add_argument("--transfer_source", default="", help="source image name for label transfer")
    p.add_argument("--transfer_target", default="", help="target image name for label transfer")
    p.add_argument("--transfer_eval_obs", action="store_true")
    p.add_argument("--nudge_image", default="",
                   help="image whose pose to nudge (the GUI's arrow buttons, "
                        "gui_main_window.cc:850-865)")
    p.add_argument("--nudge", default="",
                   help="'tx ty tz pitch yaw roll' se(3) delta applied as "
                        "exp(delta) . image_T_global (camera frame)")
    p.add_argument("--occlusion_depth_saturation", type=float, default=20.0,
                   help="depth at which the occlusion-depth visualization saturates "
                        "(dataset_inspector.cc:78-79)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain-PyTorch route)")
    # the ImageRegistrator's knob set (the reference passes the same flags to both tools)
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    return args, Parameters.from_args(args)


def image_pose(im, device) -> SE3:
    T = torch.eye(4, dtype=torch.float32)
    T[:3, :3] = quat_to_matrix(torch.as_tensor(np.asarray(im.qvec, np.float32)))
    T[:3, 3] = torch.as_tensor(np.asarray(im.tvec, np.float32))
    return SE3.from_matrix(T.to(device))


def _find_image(state, name):
    for im in state.images:
        if im.name == name or os.path.basename(im.name) == name:
            return im
    raise SystemExit(f"image '{name}' not found in state")


def _localize(args, state, device):
    from dataset_pipeline_tpu_torch.photometric.localize import localize_image

    im = _find_image(state, args.localize_image)
    corr = np.loadtxt(args.correspondences, ndmin=2)
    if corr.shape[1] != 5:
        raise SystemExit("--correspondences needs 'x y X Y Z' lines")
    refined = localize_image(state.cameras[im.camera_id], corr[:, 2:5], corr[:, :2],
                             image_pose(im, device))
    im.qvec = refined.q.cpu().numpy().astype(np.float64)
    im.tvec = refined.t.cpu().numpy().astype(np.float64)
    save_colmap_state(args.state_path, state)
    print(f"localized {im.name}: pose refined from {len(corr)} correspondences, state saved")


def _nudge(args, state):
    from dataset_pipeline_tpu_torch.icp.moments import quat_mul_np, se3_exp_np
    from dataset_pipeline_tpu_torch.models.lie import quat_to_matrix_np

    im = _find_image(state, args.nudge_image)
    d = np.asarray([float(v) for v in args.nudge.split()])
    if len(d) != 6:
        raise SystemExit("--nudge needs 6 values: tx ty tz pitch yaw roll")
    dq, dt = se3_exp_np(d)
    im.qvec = quat_mul_np(dq, np.asarray(im.qvec, np.float64))
    im.qvec /= np.linalg.norm(im.qvec)
    im.tvec = quat_to_matrix_np(dq) @ np.asarray(im.tvec, np.float64) + dt
    save_colmap_state(args.state_path, state)
    print(f"nudged {im.name} by {d.tolist()}, state saved")


def _transfer(args, params, state, pts_t, pts, device):
    from dataset_pipeline_tpu_torch.photometric.localize import transfer_labels
    from dataset_pipeline_tpu_torch.photometric.masks import (
        combined_mask, image_mask_path, save_mask)

    src = _find_image(state, args.transfer_source)
    tgt = _find_image(state, args.transfer_target)
    scam, tcam = state.cameras[src.camera_id], state.cameras[tgt.camera_id]
    spose, tpose = image_pose(src, device), image_pose(tgt, device)
    smask = combined_mask(args.image_base_path, src.name, (scam.height, scam.width))
    if smask is None:
        raise SystemExit(f"no mask found for source image {src.name}")
    radii = torch.full((len(pts),), params.splat_radius, dtype=torch.float32, device=device)

    def occlusion(cam, pose):
        return render_splats_depth(pose.apply(pts_t)[None], radii, cam)[0].cpu().numpy()

    existing = combined_mask(args.image_base_path, tgt.name, (tcam.height, tcam.width))
    merged = transfer_labels(pts, scam, spose, smask, occlusion(scam, spose), tcam, tpose,
                             occlusion(tcam, tpose), existing_target_mask=existing,
                             transfer_eval_obs=args.transfer_eval_obs,
                             occlusion_depth_threshold=params.occlusion_depth_threshold)
    out_path = image_mask_path(args.image_base_path, tgt.name)
    save_mask(out_path, merged)
    print(f"label transfer {src.name} -> {tgt.name}: wrote {out_path}")


def _cost_optimizer(args, params, state, scans, pts, pts_t, device):
    """The registrator's problem at full resolution for the cost and points
    displays: (optimizer, visibility, {image_id: (group, index)})."""
    from dataset_pipeline_tpu_torch.photometric.multiscale import build_multiscale_cloud
    from dataset_pipeline_tpu_torch.photometric.optimizer import PhotometricOptimizer
    from dataset_pipeline_tpu_torch.photometric.problem import PhotoProblem, build_photo_level
    from dataset_pipeline_tpu_torch.tools.image_registrator import load_groups

    groups, global_count = load_groups(state, args.image_base_path, device)
    n = [len(c.positions) for c in scans.clouds]
    scan_cols = np.concatenate([c.colors if c.colors is not None else np.zeros((k, 3), np.uint8)
                                for c, k in zip(scans.clouds, n)])
    scan_idx = np.concatenate([np.full(k, i, np.uint8) for i, k in enumerate(n)])
    all_poses = SE3(torch.cat([g.poses.q for g in groups]), torch.cat([g.poses.t for g in groups]))
    largest = max((g.camera for g in groups), key=lambda c: c.width * c.height)
    # the two functions' defaults, as JAX's inspector: the registrator's cloud flags do not reach them
    levels_raw = build_multiscale_cloud(pts, scan_cols, scan_idx, all_poses, largest, global_count)
    levels = [pl for i, lv in enumerate(levels_raw)
              if (pl := build_photo_level(lv, seed=i, device=device)) is not None]
    problem = PhotoProblem(groups=groups, levels=levels, occlusion_points=pts_t,
                           occlusion_radius=params.splat_radius, scale_count=global_count)
    opt = PhotometricOptimizer(problem, optimize_intrinsics=False, variable_weight=1.0)
    opt.current_scale = 0  # display at full resolution
    vis = opt._visibility(opt._occlusion_depths())
    id_to_gb = {iid: (gi, b) for gi, g in enumerate(groups) for b, iid in enumerate(g.image_ids)}
    return opt, vis, id_to_gb


def _points_image(opt, vis, gi: int, b: int) -> np.ndarray:
    """The optimization points visible in image ``b`` of group ``gi``, one
    palette colour per point scale, nearest pixel ``floor(x + 0.5)``."""
    g = opt.p.groups[gi]
    cam = g.camera
    pimg = np.zeros((cam.height, cam.width, 3), np.uint8)
    pose = SE3(g.poses.q[b], g.poses.t[b])
    bi, j = opt._batch_row[gi][b]
    for l in range(len(opt.p.levels)):
        pts_l = opt._geom(gi, b, l)[0]
        mask = vis[gi][l][bi][0][j][:pts_l.shape[0]]  # a view padded to its chunk's largest
        pix, pv = cm.project(cam, pose.apply(pts_l))
        sel = (mask & pv).cpu().numpy()
        pix = pix.cpu().numpy()
        ix = np.floor(pix[:, 0] + 0.5).astype(np.int64)
        iy = np.floor(pix[:, 1] + 0.5).astype(np.int64)
        sel &= (ix >= 0) & (iy >= 0) & (ix < cam.width) & (iy < cam.height)
        pimg[iy[sel], ix[sel]] = POINT_PALETTE[l % len(POINT_PALETTE)]
    return pimg


def main(argv=None) -> int:
    args, params = parse_args(argv)
    device = resolve_device(args.device)
    from PIL import Image

    modes = set(args.modes.split(","))
    cost_modes = sorted(m for m in modes if m.startswith("cost"))
    unknown = [m for m in cost_modes if m not in COST_MODES]
    if unknown:
        raise SystemExit(f"unknown cost mode: {unknown[0]}")
    scans = load_scan_set(args.scan_alignment_path)
    state = load_colmap_state(args.state_path, scans.scale_factor, device=device)
    pts = np.concatenate([scans.global_positions(i) for i in range(len(scans.infos))])
    colors = np.concatenate([
        c.colors if c.colors is not None else np.full((len(c.positions), 3), 128, np.uint8)
        for c in scans.clouds])
    pts_t = torch.as_tensor(np.asarray(pts, np.float32), device=device)
    os.makedirs(args.output_folder_path, exist_ok=True)

    if args.localize_image:
        _localize(args, state, device)
    if args.nudge_image:
        _nudge(args, state)
    if args.transfer_source and args.transfer_target:
        _transfer(args, params, state, pts_t, pts, device)

    cost_opt = vis = None
    id_to_gb = {}
    if cost_modes or "points" in modes:
        cost_opt, vis, id_to_gb = _cost_optimizer(args, params, state, scans, pts, pts_t, device)
        if {"cost_variable", "cost_combined"} & modes:
            # every image's variable and combined display reads the same descriptors
            cost_opt._var_desc = cost_opt._compute_variable_descriptors(vis)
    pending = set(id_to_gb)
    colors_t = torch.as_tensor(colors, dtype=torch.uint8, device=device)
    radii = torch.full((len(pts),), params.splat_radius, dtype=torch.float32, device=device)

    # PNG encoding overlaps the next image's renders (PIL releases the GIL)
    with ThreadPoolExecutor(max_workers=4) as writer:
        written = []

        def save(rgb, base, mode):
            path = os.path.join(args.output_folder_path, f"{base}.{mode}.png")
            written.append(writer.submit(lambda: Image.fromarray(rgb).save(path)))

        for im in state.images:
            cam = state.cameras[im.camera_id]
            p_cam = image_pose(im, device).apply(pts_t)[None]
            base = os.path.splitext(os.path.basename(im.name))[0]
            depth = render_points_depth(p_cam, cam.width, cam.height, cam.fx, cam.fy, cam.cx,
                                        cam.cy)[0]
            pct = _percentiles(depth, [2, 98])
            vmin, vmax = pct if pct is not None else (0, 1)
            depth_rgb = (_colormap(depth, vmin, vmax)
                         if {"depth", "overlay"} & modes else None)

            if "depth" in modes:
                save(depth_rgb, base, "depth")
            if "occlusion" in modes:
                od = render_splats_depth(p_cam, radii, cam)[0]
                save(_colormap(od, 0.0, args.occlusion_depth_saturation), base, "occlusion")
            if "scan" in modes:
                _, rgb = render_points_depth_color(p_cam, colors_t, cam.width, cam.height,
                                                   cam.fx, cam.fy, cam.cx, cam.cy)
                save(rgb[0].cpu().numpy(), base, "scan")
            if im.image_id in pending:
                gi, b = id_to_gb[im.image_id]
                if "points" in modes:
                    save(_points_image(cost_opt, vis, gi, b), base, "points")
                for cmode in cost_modes:
                    cimg = torch.as_tensor(
                        cost_opt.render_cost_image(gi, b, COST_MODES[cmode], vis=vis),
                        device=device)
                    cmax = _percentiles(cimg, 98)
                    save(_colormap(cimg, 0.0, max(cmax if cmax is not None else 1.0, 1e-6)),
                         base, cmode)
                pending.discard(im.image_id)
                if not pending:  # the registrator's whole problem: free it now
                    cost_opt = vis = None
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
            if "overlay" in modes and args.image_base_path:
                img_path = os.path.join(args.image_base_path, im.name)
                if os.path.exists(img_path):
                    photo = read_rgb(img_path)
                    over = photo.copy()
                    m = np.isfinite(depth.cpu().numpy())
                    over[m] = (0.35 * photo[m] + 0.65 * depth_rgb[m]).astype(np.uint8)
                    save(over, base, "overlay")
            print(f"{im.name}: wrote {sorted(modes)}")
        for f in written:
            f.result()
    return 0


if __name__ == "__main__":
    sys.exit(main())
