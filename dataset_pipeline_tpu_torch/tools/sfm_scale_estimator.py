"""SfMScaleEstimator: metric scale + initial scan poses from SfM on cube maps.

Port of ``dataset_pipeline_tpu/tools/sfm_scale_estimator.py``, the same flags;
it runs on the host (numpy, and torch on the CPU for the float32 rotation
matrix the JAX tool computes), so it takes no ``--device``. Given a
COLMAP SfM model reconstructed from cube-map face images (rendered by
CubeMapRenderer from the laser scans), compares each SfM keypoint's
reconstructed depth with the laser ``.depth`` value at that pixel; the model
scale is ``exp(mean log(measured/estimated))`` (``:423-494,558``). Scan poses
follow from the face image poses by un-applying the face rotation
(``:496-555``). Writes a scaled ``meshlab_project.mlp`` plus a scaled COLMAP
model (``:244-385``).

Cube-map filenames follow ``<scan>.ply.<face>.png`` with sidecars
``<scan>.ply.intrinsics.txt`` and ``<scan>.ply.<face>.depth``.

Run: ``python -m dataset_pipeline_tpu_torch.tools.sfm_scale_estimator -s sfm
-si cube_maps -i scans -o out``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
import torch

from dataset_pipeline_tpu_torch.io import colmap as cio
from dataset_pipeline_tpu_torch.io.depthmap import read_cube_intrinsics, read_depth_raw
from dataset_pipeline_tpu_torch.io.meshlab import MeshInfo, write_meshlab_project
from dataset_pipeline_tpu_torch.models.lie import quat_to_matrix
from dataset_pipeline_tpu_torch.ops.splat import CUBE_FACE_NAMES, CUBE_FACE_ROTATIONS
from dataset_pipeline_tpu_torch.utils.params import Parameters

FACE_ROTATION = {name: CUBE_FACE_ROTATIONS[i] for i, name in enumerate(CUBE_FACE_NAMES)}


def face_name_from_image(filename: str) -> str:
    base = filename[: filename.rfind(".")]  # strip .png
    return base[base.rfind(".") + 1 :]


def scan_name_from_image(filename: str) -> str:
    name = os.path.basename(filename)
    ply = name.find(".ply")
    if ply < 0:
        raise ValueError(f"{filename}: expected '<scan>.ply.<face>.png' naming")
    return name[: ply + 4]


def intrinsics_path_from_image(filename: str) -> str:
    base = filename[: filename.rfind(".")]
    return base[: base.rfind(".") + 1] + "intrinsics.txt"


def depth_path_from_image(filename: str) -> str:
    return filename[: filename.rfind(".") + 1] + "depth"


def estimate_scale_and_poses(model: cio.ColmapModel, sfm_image_path: str,
                             cube_map_face_camera_id: int):
    log_sum = 0.0
    count = 0
    scan_poses = {}
    for iid in sorted(model.images):
        im = model.images[iid]
        if im.camera_id != cube_map_face_camera_id:
            continue
        face = face_name_from_image(im.name)
        if face not in FACE_ROTATION:
            continue
        ipath = os.path.join(sfm_image_path, intrinsics_path_from_image(im.name))
        w, h, fx, fy, cx, cy = read_cube_intrinsics(ipath)
        depth = read_depth_raw(os.path.join(sfm_image_path, depth_path_from_image(im.name)), h, w)

        R = quat_to_matrix(torch.as_tensor(im.qvec, dtype=torch.float32)).numpy()
        t = np.asarray(im.tvec)

        # keypoints with an SfM point and a laser depth at the same pixel
        for (x, y), pid in zip(im.xys, im.point3d_ids):
            if pid < 0 or model.points is None or pid not in model.points:
                continue
            ix, iy = int(x), int(y)
            if ix < 0 or iy < 0 or ix >= w or iy >= h:
                continue
            measured = depth[iy, ix]
            if not np.isfinite(measured) or measured <= 0:
                continue
            p = R @ model.points[pid].xyz + t
            if p[2] <= 0:
                continue
            log_sum += np.log(measured / p[2])
            count += 1

        # derive the scan pose from the first face seen per scan
        scan = scan_name_from_image(im.name)
        if scan not in scan_poses:
            g_R = R.T
            g_t = -R.T @ t
            scan_poses[scan] = (g_R @ FACE_ROTATION[face], g_t)

    if count == 0:
        raise ValueError("no SfM observation had a laser depth — cannot estimate scale")
    scale = float(np.exp(log_sum / count))
    return scale, scan_poses, count


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-s", "--sfm_model_path", required=True, help="COLMAP text model dir")
    p.add_argument("-si", "--sfm_image_path", required=True,
                   help="dir with cube-map images/.depth/.intrinsics.txt")
    p.add_argument("-i", "--scans_path", required=True, help="dir with scan PLYs")
    p.add_argument("-o", "--output_path", required=True)
    p.add_argument("--cube_map_face_camera_id", type=int, default=1)
    # shared pipeline knob set (opt/parameters.h): every tool accepts
    # the identical flags so one knob set drives the whole pipeline
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    params = Parameters.from_args(args)  # noqa: F841 (dump/consume)

    model = cio.read_model(args.sfm_model_path, read_points=True)
    scale, scan_poses, count = estimate_scale_and_poses(
        model, args.sfm_image_path, args.cube_map_face_camera_id)
    print(f"scale factor {scale:.6f} from {count} observations")

    os.makedirs(args.output_path, exist_ok=True)
    infos = []
    for scan, (R, t) in sorted(scan_poses.items()):
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = scale * t
        rel = os.path.relpath(os.path.join(args.scans_path, scan), args.output_path)
        infos.append(MeshInfo(scan, rel, M))
    write_meshlab_project(os.path.join(args.output_path, "meshlab_project.mlp"), infos)

    # scaled COLMAP model
    scaled_dir = os.path.join(args.output_path, "colmap_model")
    os.makedirs(scaled_dir, exist_ok=True)
    shutil.copy(os.path.join(args.sfm_model_path, "cameras.txt"),
                os.path.join(scaled_dir, "cameras.txt"))
    rigs = os.path.join(args.sfm_model_path, "rigs.json")
    if os.path.exists(rigs):
        shutil.copy(rigs, os.path.join(scaled_dir, "rigs.json"))
    for im in model.images.values():
        im.tvec = im.tvec * scale
    cio.write_images_txt(os.path.join(scaled_dir, "images.txt"), model.images)
    if model.points is not None:
        for pt in model.points.values():
            pt.xyz = pt.xyz * scale
        cio.write_points3d_txt(os.path.join(scaled_dir, "points3D.txt"), model.points)

    # warn about scans that were not aligned
    aligned = set(scan_poses)
    missing = [f for f in sorted(os.listdir(args.scans_path))
               if f.endswith(".ply") and f not in aligned]
    for m in missing:
        print(f"warning: scan {m} was not covered by any SfM cube-map image")
    print(f"wrote {args.output_path}/meshlab_project.mlp and colmap_model/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
