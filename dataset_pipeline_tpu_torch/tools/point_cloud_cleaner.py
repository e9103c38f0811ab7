"""PointCloudCleaner: iterated local statistical outlier removal.

Port of ``dataset_pipeline_tpu/tools/point_cloud_cleaner.py`` with the same
flags plus ``--device`` (default ``cuda``; it raises when CUDA is absent
instead of running on the CPU): ``--in X.ply`` and repeated ``--filter
k,factor`` write ``X.inliers.ply`` and ``X.outliers.ply`` next to the input
(the ETH3D recipe is ``--filter 270,1.15 --filter 20,1.15``). Above 200,000
points a filter's neighbours come from the native host kNN, below from the
brute force on the device (``ops/outlier.py:remove_outliers``).

Run: ``python -m dataset_pipeline_tpu_torch.tools.point_cloud_cleaner --in
scan.ply --filter 270,1.15 --filter 20,1.15 [--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
from dataset_pipeline_tpu_torch.ops.outlier import remove_outliers
from dataset_pipeline_tpu_torch.utils.params import Parameters
from dataset_pipeline_tpu_torch.utils.timing import stage


def _subset(pc: PointCloud, mask: np.ndarray) -> PointCloud:
    return PointCloud(
        pc.positions[mask],
        pc.normals[mask] if pc.normals is not None else None,
        pc.colors[mask] if pc.colors is not None else None,
        None,
        {k: v[mask] for k, v in pc.extras.items()},
    )


def main(argv=None, timings: dict | None = None) -> int:
    """Run the tool; ``timings`` collects the seconds of ``read``,
    ``knn_host``, ``knn_device``, ``filter`` and ``write``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in", dest="input", required=True, help="input PLY")
    p.add_argument("--filter", action="append", default=[], metavar="K,FACTOR",
                   help="neighbor count and distance factor; repeatable, applied in order")
    p.add_argument("--out_prefix", default=None, help="output prefix (default: input path)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    # shared pipeline knob set: every tool accepts the identical flags
    Parameters().add_to_argparser(p)
    args = p.parse_args(argv)
    Parameters.from_args(args)
    device = resolve_device(args.device)

    filters = []
    for f in args.filter:
        k_s, factor_s = f.split(",")
        filters.append((int(k_s), float(factor_s)))
    if not filters:
        print("warning: no --filter given; all points are inliers", file=sys.stderr)

    with stage(timings, "read", device):
        cloud = read_ply(args.input)
    print(f"loaded {len(cloud)} points from {args.input}")
    mask = remove_outliers(cloud.positions, filters, device=device, timings=timings)

    prefix = args.out_prefix or os.path.splitext(args.input)[0]
    inl, outl = prefix + ".inliers.ply", prefix + ".outliers.ply"
    with stage(timings, "write", device):
        write_ply(inl, _subset(cloud, mask))
        write_ply(outl, _subset(cloud, ~mask))
    print(f"kept {int(mask.sum())} inliers -> {inl}")
    print(f"removed {int((~mask).sum())} outliers -> {outl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
