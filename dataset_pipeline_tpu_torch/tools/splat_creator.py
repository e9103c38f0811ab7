"""SplatCreator: normal-aligned splat quads where the mesh misses geometry.

Port of ``dataset_pipeline_tpu/tools/splat_creator.py`` with the same flags
plus ``--device`` (default ``cuda``; it raises when CUDA is absent instead
of running on the CPU): for every point with a valid normal, the splat
radius is the distance to its 4th nearest neighbour (capped at
``--max_splat_size``); a 2-triangle quad oriented by the normal is emitted
iff the centre or any of the 4 corners lies farther than
``--distance_threshold`` from the surface mesh (a threshold-bounded query on
the triangle grid of ``ops/tridist.py``). The kNN is the port's
``knn_bruteforce`` / ``knn_grid``, index for index the JAX one's.

Run: ``python -m dataset_pipeline_tpu_torch.tools.splat_creator
--point_normal_cloud_path merged.ply --mesh_path mesh.ply --output_path
splats.ply [--device cpu]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device, resolve_device
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.ops.knn import build_grid, knn_bruteforce, knn_grid
from dataset_pipeline_tpu_torch.ops.tridist import build_triangle_grid, min_dist_sq_within
from dataset_pipeline_tpu_torch.utils.params import Parameters
from dataset_pipeline_tpu_torch.utils.timing import stage

TRIDIST_CHUNK_CUDA = 1 << 17  # queries per pass on the card (8192 on the CPU, as in JAX)


def unit_orthogonal(n: np.ndarray) -> np.ndarray:
    """Eigen's unitOrthogonal(): perpendicular unit vector, batched (N,3)."""
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    use_xy = ~((np.abs(x) <= np.abs(z) * 2**-26) & (np.abs(y) <= np.abs(z) * 2**-26))
    inv_xy = 1.0 / np.maximum(np.sqrt(x * x + y * y), 1e-30)
    inv_yz = 1.0 / np.maximum(np.sqrt(y * y + z * z), 1e-30)
    out = np.where(
        use_xy[:, None],
        np.stack([-y * inv_xy, x * inv_xy, np.zeros_like(x)], -1),
        np.stack([np.zeros_like(x), -z * inv_yz, y * inv_yz], -1),
    )
    return out.astype(np.float32)


def create_splats(points: np.ndarray, normals: np.ndarray,
                  mesh_vertices: np.ndarray, mesh_faces: np.ndarray,
                  distance_threshold: float, max_splat_size: float, device=None,
                  timings: dict | None = None):
    """(vertices (4S,3), faces (2S,3), S) of the splats. ``timings`` collects
    the ``knn`` and ``tridist`` seconds."""
    dev = default_device(device)
    valid_n = np.isfinite(normals).all(1) & (np.linalg.norm(normals, axis=1) > 1e-6)
    pts = points[valid_n].astype(np.float32)
    nrm = normals[valid_n].astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    # splat radius = distance to the 4th nearest neighbour, capped
    k = 4
    with stage(timings, "knn", dev):
        p_dev = torch.from_numpy(pts).to(dev)
        if len(pts) > 200_000:
            sample = p_dev[:: max(1, len(pts) // 20000)]
            d2s, _ = knn_bruteforce(sample, sample, 2)
            typical = float(np.sqrt(max(float(np.median(d2s[:, 1].cpu().numpy())), 1e-12)))
            grid = build_grid(p_dev, max(typical * 4.0, 1e-6))
            d2, _, _ = knn_grid(grid, p_dev, k + 1, max_per_cell=64)
        else:
            d2, _ = knn_bruteforce(p_dev, p_dev, k + 1)
        radius = np.minimum(np.sqrt(d2[:, k].cpu().numpy()), max_splat_size).astype(np.float32)

    right = unit_orthogonal(nrm)
    up = np.cross(nrm, right)
    r = radius[:, None]
    corners = np.stack(
        [
            pts + r * (right + up),  # top right
            pts + r * (right - up),  # bottom right
            pts + r * (-right - up),  # bottom left
            pts + r * (-right + up),  # top left
        ],
        1,
    )  # (N,4,3)

    with stage(timings, "tridist", dev):
        tri_grid = build_triangle_grid(mesh_vertices, mesh_faces, distance_threshold, device=dev)
        thr2 = distance_threshold * distance_threshold
        queries = np.concatenate([pts[:, None, :], corners], 1).reshape(-1, 3)
        d2m = min_dist_sq_within(tri_grid, torch.from_numpy(queries).to(dev),
                                 chunk=TRIDIST_CHUNK_CUDA if dev.type == "cuda" else 8192)
        far = (d2m.cpu().numpy() > thr2).reshape(-1, 5).any(1)

    sel = corners[far]  # (S,4,3)
    S = len(sel)
    verts = sel.reshape(-1, 3)
    base = np.arange(S, dtype=np.int32) * 4
    faces = np.concatenate(
        [
            np.stack([base + 2, base + 1, base + 0], -1),
            np.stack([base + 0, base + 3, base + 2], -1),
        ],
        0,
    )
    return verts.astype(np.float32), faces.astype(np.int32), int(S)


def main(argv=None, timings: dict | None = None) -> int:
    """Run the tool; ``timings`` collects the ``knn`` and ``tridist`` seconds."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--point_normal_cloud_path", required=True)
    p.add_argument("--mesh_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--distance_threshold", type=float, default=0.02)
    p.add_argument("--max_splat_size", type=float, default=0.25)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    # shared pipeline knob set: every tool accepts the identical flags
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    Parameters.from_args(args)
    device = resolve_device(args.device)

    cloud = read_ply(args.point_normal_cloud_path)
    if cloud.normals is None:
        print("error: input cloud has no normals", file=sys.stderr)
        return 1
    mesh = read_ply(args.mesh_path)
    if mesh.faces is None:
        print("error: mesh has no faces", file=sys.stderr)
        return 1
    verts, faces, count = create_splats(
        cloud.positions, cloud.normals, mesh.positions, mesh.faces,
        args.distance_threshold, args.max_splat_size, device, timings)
    write_ply(args.output_path, PointCloud(verts, faces=faces))
    print(f"added {count} splats -> {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
