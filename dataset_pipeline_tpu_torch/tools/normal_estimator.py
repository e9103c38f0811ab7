"""NormalEstimator: per-scan PCA normals in the global frame.

Port of ``dataset_pipeline_tpu/tools/normal_estimator.py`` with the same
flags plus ``--device`` (default ``cuda``; it raises when CUDA is absent
instead of running on the CPU): loads a scan alignment ``.mlp``, estimates
per-scan normals with the port's ``ops/knn.py`` and ``ops/normals.py``
(viewpoint = scan origin), merges all scans, and writes a single PLY with
x, y, z, nx, ny, nz, rgb, positions restored to the original units.

Run: ``python -m dataset_pipeline_tpu_torch.tools.normal_estimator -i s.mlp
-o merged.ply [--device cpu]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
from dataset_pipeline_tpu_torch.io.scans import load_scan_set
from dataset_pipeline_tpu_torch.ops.knn import build_grid, knn_bruteforce
from dataset_pipeline_tpu_torch.ops.normals import estimate_normals
from dataset_pipeline_tpu_torch.utils.params import Parameters
from dataset_pipeline_tpu_torch.utils.timing import stage


def main(argv=None, timings: dict | None = None) -> int:
    """Run the tool; ``timings`` collects the ``knn_cell``, ``normals`` and
    ``io`` seconds."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input", required=True, help="scan_alignment.mlp")
    p.add_argument("-o", "--output", required=True, help="merged output PLY")
    p.add_argument("--neighbor_count", type=int, default=8)
    p.add_argument("--neighbor_radius", type=float, default=0.0,
                   help="if >0, grid cell size for the neighbor search; "
                        "otherwise derived from data")
    p.add_argument("--grid_above", type=int, default=200_000,
                   help="use the voxel-grid search above this many points")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    # shared pipeline knob set: every tool accepts the identical flags
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    Parameters.from_args(args)
    device = resolve_device(args.device)

    with stage(timings, "io", device):
        scans = load_scan_set(args.input)
    all_pos, all_normals, all_colors = [], [], []
    for i in range(len(scans.infos)):
        pos = scans.global_positions(i)
        vp = torch.from_numpy(scans.scan_origin(i)).to(device)
        print(f"scan {i} ({scans.infos[i].label}): {len(pos)} points")
        pts = torch.from_numpy(pos).to(device)
        if len(pos) > args.grid_above:
            with stage(timings, "knn_cell", device):
                if args.neighbor_radius > 0:
                    cell = args.neighbor_radius
                else:
                    sample = pts[:: max(1, len(pos) // 20000)]
                    d2, _ = knn_bruteforce(sample, sample, 2)
                    typical = float(np.sqrt(max(float(np.median(d2[:, 1].cpu().numpy())), 1e-12)))
                    cell = max(typical * (args.neighbor_count ** (1 / 3)) * 2.0, 1e-6)
            with stage(timings, "normals", device):
                normals, _ = estimate_normals(pts, vp, k=args.neighbor_count,
                                              grid=build_grid(pts, cell))
        else:
            with stage(timings, "normals", device):
                normals, _ = estimate_normals(pts, vp, k=args.neighbor_count)
        all_pos.append(pos / scans.scale_factor)  # back to the original units
        all_normals.append(normals.cpu().numpy())
        c = scans.clouds[i].colors
        all_colors.append(c if c is not None else np.zeros((len(pos), 3), np.uint8))

    merged = PointCloud(
        np.concatenate(all_pos).astype(np.float32),
        np.concatenate(all_normals).astype(np.float32),
        np.concatenate(all_colors),
    )
    with stage(timings, "io", device):
        write_ply(args.output, merged)
    print(f"wrote {len(merged)} points with normals -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
