"""GroundTruthCreator: per-image ground-truth depth maps + 2-view-filtered clouds.

Port of ``dataset_pipeline_tpu/tools/ground_truth_creator.py`` with the same
flags plus ``--device`` (default ``cuda``; it raises when CUDA is absent
instead of running on the CPU):

- loads the scan alignment (.mlp) + COLMAP state; optionally rotates the
  world so the first scan is upright;
- occlusion geometry: splats at every scan point (or at the points of
  ``--occlusion_splats_path``), or the triangle mesh of
  ``--occlusion_mesh_path`` (plus the splat quads of the splats file);
- counts, per scan point, in how many images it is visible (projection,
  occlusion z-test with a threshold slack, eval mask);
- writes trimmed per-scan PLYs keeping the points seen in >= 2 images and
  their ``scan_alignment.mlp``; per-image ground-truth depth (min z per
  rounded pixel over visible >= 2-view points, raw float32, optional gzip),
  occlusion depth and scan-rendering overlays.

The JAX tool's visibility, depth and overlay functions run inside ``jit``,
so the port rotates and projects the points in their fused forms
(``quat_rotate_fused``, ``project(..., fused=True)``); occlusion geometry and
poses are computed op by op, as the JAX tool does. The overlay's colliding
writes keep the JAX CPU scatter's last writer (the highest point index of a
pass, later passes over earlier ones), found with a ``scatter_reduce_`` so
the card writes the same pixels.

Run: ``python -m dataset_pipeline_tpu_torch.tools.ground_truth_creator
--scan_alignment_path s.mlp --state_path state --output_folder_path out
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.io.depthmap import write_depth_raw
from dataset_pipeline_tpu_torch.io.meshlab import MeshInfo, write_meshlab_project
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.io.scans import load_scan_set
from dataset_pipeline_tpu_torch.io.state import ImageState, ModelState, load_colmap_state, save_colmap_state
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3, quat_rotate_fused, quat_to_matrix
from dataset_pipeline_tpu_torch.ops.mesh_raster import build_occlusion_mesh, render_occlusion_mesh_depth
from dataset_pipeline_tpu_torch.ops.splat import render_splats_depth, zbuffer_min
from dataset_pipeline_tpu_torch.photometric.masks import MASK_EVAL_OBS, image_mask_path, load_mask
from dataset_pipeline_tpu_torch.utils.params import Parameters
from dataset_pipeline_tpu_torch.utils.timing import stage

DEFAULT_SPLAT_RADIUS = 0.03  # opt/parameters.h
OCCLUSION_DEPTH_THRESHOLD = 0.01
MIN_OCCLUSION_DEPTH = 0.05
MAX_OCCLUSION_DEPTH = 100.0


def _visible_mask(camera, pose_q, pose_t, points, occl_depth, width: int, height: int,
                  eval_mask=None):
    """Visibility of each point in one image (projection + z-test + optional
    eval mask: pixels whose mask value is ``MASK_EVAL_OBS`` are excluded).
    Returns (vis, ix, iy, z)."""
    p_cam = quat_rotate_fused(pose_q[None], points) + pose_t[None]
    z = p_cam[:, 2]
    pix, valid = cm.project(camera, p_cam, fused=True)
    # float bounds first: a huge coordinate must not wrap in the int cast
    ix = torch.clamp(torch.floor(pix[:, 0] + 0.5), -1, width).long()
    iy = torch.clamp(torch.floor(pix[:, 1] + 0.5), -1, height).long()
    inside = valid & (ix >= 0) & (iy >= 0) & (ix < width) & (iy < height)
    ixc = torch.clamp(ix, 0, width - 1)
    iyc = torch.clamp(iy, 0, height - 1)
    occ = occl_depth[iyc, ixc]
    vis = inside & (z > 0) & (occ + OCCLUSION_DEPTH_THRESHOLD >= z)
    if eval_mask is not None:
        vis = vis & (eval_mask[iyc, ixc] != MASK_EVAL_OBS)
    return vis, ix, iy, z


def _gt_depth_image(camera, pose_q, pose_t, points, keep, occl_depth, width: int, height: int,
                    eval_mask=None):
    vis, ix, iy, z = _visible_mask(camera, pose_q, pose_t, points, occl_depth, width, height,
                                   eval_mask)
    ok = vis & keep
    flat = torch.where(ok, iy * width + ix, -1)
    return zbuffer_min(flat, torch.where(ok, z, float("inf")), height * width).reshape(height, width)


def _scan_rendering(camera, pose_q, pose_t, points, colors, keep, occl_depth, base_image,
                    width: int, height: int, radius: int, eval_mask=None):
    """Overlay each visible kept point as a (2 radius + 1)^2 square of its
    colour on ``base_image`` (H,W,3) uint8."""
    vis, ix, iy, _ = _visible_mask(camera, pose_q, pose_t, points, occl_depth, width, height,
                                   eval_mask)
    ok = vis & keep
    n_px = height * width
    idx = torch.arange(points.shape[0], device=points.device)
    img = base_image.reshape(-1, 3).clone()
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            jx, jy = ix + dx, iy + dy
            inside = ok & (jx >= 0) & (jy >= 0) & (jx < width) & (jy < height)
            last = torch.full((n_px,), -1, dtype=torch.long, device=points.device)
            last.scatter_reduce_(0, (jy * width + jx)[inside], idx[inside], reduce="amax",
                                 include_self=True)
            hit = torch.nonzero(last >= 0)[:, 0]
            img[hit] = colors[last[hit]]
    return img.reshape(height, width, 3)


def render_occlusion_depth(camera, pose: SE3, occlusion_points, splat_radius: float,
                           max_radius_px: int = 3, occlusion_mesh=None):
    """(H,W) occlusion depth of one image: the mesh's (0 = background, -1
    near occlusion boundaries) or the splats' (inf = empty), centred
    through the camera's lens (``render_splats_depth``)."""
    if occlusion_mesh is not None:
        return render_occlusion_mesh_depth(
            camera, pose, occlusion_mesh, splat_radius=splat_radius,
            min_depth=MIN_OCCLUSION_DEPTH, max_depth=MAX_OCCLUSION_DEPTH)
    p_cam = pose.apply(occlusion_points)
    z = p_cam[:, 2]
    in_range = (z >= MIN_OCCLUSION_DEPTH) & (z <= MAX_OCCLUSION_DEPTH)
    behind = torch.tensor([0.0, 0.0, -1.0], dtype=p_cam.dtype, device=p_cam.device)
    p_cam = torch.where(in_range[:, None], p_cam, behind)
    radii = torch.full((p_cam.shape[0],), splat_radius, dtype=torch.float32, device=p_cam.device)
    return render_splats_depth(p_cam[None], radii, camera, max_radius_px=max_radius_px)[0]


def _image_pose(im: ImageState, up_inv: np.ndarray, device) -> SE3:
    """image_T_global' = image_T_global . upright^-1, through the JAX tool's
    precisions: rotation matrix in float32, product in float64, the pose
    from the float32 matrix."""
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix(torch.as_tensor(im.qvec, dtype=torch.float32)).numpy()
    T[:3, 3] = im.tvec
    T = T @ up_inv
    pose = SE3.from_matrix(torch.as_tensor(T, dtype=torch.float32))
    return SE3(pose.q.to(device), pose.t.to(device))


def _write_depth(root: str, folder: str, name: str, depth, compress: bool) -> None:
    os.makedirs(os.path.join(root, folder, os.path.dirname(name)), exist_ok=True)
    write_depth_raw(os.path.join(root, folder, name), depth.cpu().numpy(), compress)


def main(argv=None, timings: dict | None = None) -> int:
    """Run the tool; ``timings``, if given, collects per-stage seconds
    (``occlusion``, ``visibility``, ``gt_depth``, ``scan_rendering``,
    ``writes``, ``setup``)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scan_alignment_path", required=True)
    p.add_argument("--occlusion_mesh_path", default="")
    p.add_argument("--occlusion_splats_path", default="")
    p.add_argument("--image_base_path", default="")
    p.add_argument("--state_path", required=True)
    p.add_argument("--output_folder_path", required=True)
    p.add_argument("--rotate_first_scan_upright", action="store_true")
    p.add_argument("--scan_point_radius", type=int, default=2)
    p.add_argument("--write_point_cloud", type=int, default=1)
    p.add_argument("--write_depth_maps", type=int, default=1)
    p.add_argument("--write_occlusion_depth", type=int, default=0)
    p.add_argument("--write_scan_renderings", type=int, default=0)
    p.add_argument("--compress_depth_maps", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    params = Parameters.from_args(args)
    device = resolve_device(args.device)
    out_root = args.output_folder_path
    compress = bool(args.compress_depth_maps)

    with stage(timings, "setup", device):
        scans = load_scan_set(args.scan_alignment_path)
        state = load_colmap_state(args.state_path, scans.scale_factor, device=device)
        os.makedirs(out_root, exist_ok=True)

        # world rotation so the first scan is upright
        upright = np.eye(4)
        if args.rotate_first_scan_upright:
            M0 = scans.global_matrix(0)
            R0 = M0[:3, :3] / np.cbrt(max(np.linalg.det(M0[:3, :3]), 1e-30))
            Rinv = R0.T
            upright[:3, :3] = Rinv
            upright[:3, 3] = M0[:3, 3] - Rinv @ M0[:3, 3]

        # scan points in the (possibly rotated) normalized global frame
        scan_pts, scan_cols = [], []
        for i in range(len(scans.infos)):
            gp = scans.global_positions(i)
            gp = gp @ upright[:3, :3].T + upright[:3, 3]
            scan_pts.append(gp.astype(np.float32))
            c = scans.clouds[i].colors
            scan_cols.append(c if c is not None else np.zeros((len(gp), 3), np.uint8))

        occl_points = torch.from_numpy(np.concatenate(scan_pts)).to(device)
        occlusion_mesh = None
        if args.occlusion_mesh_path:
            mesh_pc = read_ply(args.occlusion_mesh_path)
            verts = [mesh_pc.positions @ upright[:3, :3].T + upright[:3, 3]]
            faces = [mesh_pc.faces]
            if args.occlusion_splats_path:
                sp = read_ply(args.occlusion_splats_path)
                if sp.faces is not None:
                    faces.append(sp.faces + len(verts[0]))
                    verts.append(sp.positions @ upright[:3, :3].T + upright[:3, 3])
            occlusion_mesh = build_occlusion_mesh(
                np.concatenate(verts).astype(np.float32), np.concatenate(faces), device=device)
        elif args.occlusion_splats_path:
            sp = read_ply(args.occlusion_splats_path).positions
            sp = sp @ upright[:3, :3].T + upright[:3, 3]
            occl_points = torch.from_numpy(sp.astype(np.float32)).to(device)

        up_inv = np.linalg.inv(upright)
        images = state.images
        print(f"{len(images)} images, {sum(len(x) for x in scan_pts)} scan points")
        poses = {im.image_id: _image_pose(im, up_inv, device) for im in images}

        # export the rotated calibration
        rot_images = [ImageState(im.image_id, im.camera_id, im.name,
                                 poses[im.image_id].q.cpu().numpy(),
                                 poses[im.image_id].t.cpu().numpy()) for im in images]
        save_colmap_state(os.path.join(out_root, "calibration"),
                          ModelState(state.cameras, rot_images, scans.scale_factor))
        pts_dev = [torch.from_numpy(x).to(device) for x in scan_pts]

    counts = [torch.zeros(len(x), dtype=torch.int32, device=device) for x in scan_pts]
    occl_cache, eval_masks = {}, {}
    for im in images:
        cam = state.cameras[im.camera_id]
        pose = poses[im.image_id]
        with stage(timings, "occlusion", device):
            od = render_occlusion_depth(cam, pose, occl_points, params.splat_radius,
                                        occlusion_mesh=occlusion_mesh)
        occl_cache[im.image_id] = od
        em = None
        if args.image_base_path:
            m = load_mask(image_mask_path(args.image_base_path, im.name))
            if m is not None:
                em = torch.from_numpy(m if m.ndim == 2 else m.max(-1)).to(device)
        eval_masks[im.image_id] = em
        with stage(timings, "visibility", device):
            for si, pts in enumerate(pts_dev):
                vis, _, _, _ = _visible_mask(cam, pose.q, pose.t, pts, od, cam.width,
                                             cam.height, em)
                counts[si] += vis.to(torch.int32)
        if args.write_occlusion_depth:
            with stage(timings, "writes", device):
                _write_depth(out_root, "occlusion_depth", im.name, od, compress)
    counts = [c.cpu().numpy() for c in counts]

    if args.write_point_cloud:
        with stage(timings, "writes", device):
            infos_out = []
            for si in range(len(scan_pts)):
                keep = counts[si] >= 2
                name = f"scan{si}.ply"
                # written in the scan's LOCAL frame so the .mlp poses apply
                M = upright @ scans.global_matrix(si)
                Minv = np.linalg.inv(M)
                local = scan_pts[si][keep] @ Minv[:3, :3].T + Minv[:3, 3]
                write_ply(os.path.join(out_root, name),
                          PointCloud(local.astype(np.float32), None, scan_cols[si][keep]))
                Mout = M.copy()
                Mout[:3, :] /= scans.scale_factor
                infos_out.append(MeshInfo(scans.infos[si].label, name, Mout))
                print(f"scan {si}: kept {int(keep.sum())}/{len(keep)} points (>=2 obs)")
            write_meshlab_project(os.path.join(out_root, "scan_alignment.mlp"), infos_out)

    if args.write_depth_maps or args.write_scan_renderings:
        all_pts = torch.cat(pts_dev)
        all_cols = torch.from_numpy(np.concatenate(scan_cols).astype(np.uint8)).to(device)
        all_keep = torch.from_numpy(np.concatenate([c >= 2 for c in counts])).to(device)
        for im in images:
            cam = state.cameras[im.camera_id]
            pose = poses[im.image_id]
            od = occl_cache[im.image_id]
            if args.write_depth_maps:
                with stage(timings, "gt_depth", device):
                    d = _gt_depth_image(cam, pose.q, pose.t, all_pts, all_keep, od,
                                        cam.width, cam.height, eval_masks[im.image_id])
                with stage(timings, "writes", device):
                    _write_depth(out_root, "ground_truth_depth", im.name, d, compress)
            if args.write_scan_renderings and args.image_base_path:
                img_path = os.path.join(args.image_base_path, im.name)
                if os.path.exists(img_path):
                    from PIL import Image

                    with stage(timings, "scan_rendering", device):
                        base = torch.from_numpy(
                            np.asarray(Image.open(img_path).convert("RGB"))).to(device)
                        out = _scan_rendering(cam, pose.q, pose.t, all_pts, all_cols, all_keep,
                                              od, base, cam.width, cam.height,
                                              args.scan_point_radius, eval_masks[im.image_id])
                    with stage(timings, "writes", device):
                        folder = os.path.join(out_root, "scan_rendering", os.path.dirname(im.name))
                        os.makedirs(folder, exist_ok=True)
                        Image.fromarray(out.cpu().numpy()).save(
                            os.path.join(out_root, "scan_rendering", im.name))
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
