"""Local statistical outlier removal.

Port of ``dataset_pipeline_tpu/ops/outlier.py``: two passes, (1) per point
the mean distance to its k nearest neighbours, (2) keep a point iff that mean
is at most ``factor`` times the mean of its neighbours' means (local
statistics, not global).

Every function runs on the device of the points it is given. Above
``use_grid_above`` points ``remove_outliers`` takes the exact neighbours from
the native threaded grid kNN on the host (``native.grid_knn``, which raises
without g++), as the JAX package does; ``_outliers_from_adaptive_knn`` is the
exact search on the device (``ops/knn.py:knn_adaptive``).
"""

from __future__ import annotations

import numpy as np
import torch

from dataset_pipeline_tpu_torch import native
from dataset_pipeline_tpu_torch.ops.knn import VoxelGrid, knn_adaptive, knn_bruteforce, knn_grid
from dataset_pipeline_tpu_torch.utils.timing import stage


_ROWS = 1 << 20  # rows per pass of the filter (bounds its temporaries)


def _filter_from_knn(d2, idx):
    """(mean_dist, local_mean) (Q,) from (Q,k+1) self-inclusive sorted kNN
    results (the first column is the point itself). Rows are independent:
    they are taken ``_ROWS`` at a time, which changes no result."""
    Q = d2.shape[0]
    mean_dist = torch.empty(Q, dtype=torch.float32, device=d2.device)
    for s in range(0, Q, _ROWS):
        d2n, idxn = d2[s:s + _ROWS, 1:], idx[s:s + _ROWS, 1:]
        valid = idxn >= 0
        dist = torch.where(valid, torch.sqrt(torch.clamp(d2n, min=0.0)), 0.0)
        mean_dist[s:s + _ROWS] = torch.sum(dist, -1) / torch.clamp(torch.sum(valid, -1), min=1)

    # pass 2: mean of the neighbours' mean distances
    local_mean = torch.empty_like(mean_dist)
    for s in range(0, Q, _ROWS):
        idxn = idx[s:s + _ROWS, 1:].long()
        valid = idxn >= 0
        nbr = mean_dist[torch.clamp(idxn, min=0)]
        nbr_valid = valid & (nbr > 0)
        n_count = torch.clamp(torch.sum(nbr_valid, -1), min=1)
        local_mean[s:s + _ROWS] = torch.sum(torch.where(nbr_valid, nbr, 0.0), -1) / n_count
    return mean_dist, local_mean


def _inliers(d2, idx, factor: float):
    mean_dist, local_mean = _filter_from_knn(d2, idx)
    return mean_dist <= local_mean * factor


def local_statistical_outliers_bruteforce(points, k: int, factor: float):
    """Inlier mask via the exact brute-force kNN."""
    d2, idx = knn_bruteforce(points, points, k + 1)
    return _inliers(d2, idx, factor)


def local_statistical_outliers_grid(grid: VoxelGrid, points, k: int, factor: float,
                                    max_per_cell: int = 32, rings: int = 1):
    """Inlier mask via the capped grid kNN (inexact where a cell hits the cap)."""
    d2, idx, _ = knn_grid(grid, points, k + 1, max_per_cell, rings=rings)
    return _inliers(d2, idx, factor)


def _outliers_from_adaptive_knn(points, k: int, factor: float, stats: dict | None = None):
    """Inlier mask via the checked adaptive grid search on the points' device
    (exact; supports the reference cleaner's k = 270). ``stats`` receives
    ``knn_adaptive``'s sizing and repair counts."""
    points = torch.as_tensor(points, dtype=torch.float32)
    d2, idx = knn_adaptive(points, points, k + 1, stats=stats)
    return _inliers(d2, idx, factor)


def remove_outliers(points, filters, use_grid_above: int = 200_000, device=None,
                    timings: dict | None = None, masks: list | None = None):
    """Iterated filtering like the reference PointCloudCleaner CLI:
    ``filters`` is a list of (k, factor) applied in sequence to the points
    that survived the previous ones; returns the final inlier mask (numpy
    bool) into the original array. ``points`` (numpy or a tensor) is taken
    to ``device`` (default: the tensor's own, or the CPU for numpy); at or
    below ``use_grid_above`` points a filter's kNN is the brute force on that
    device, above it the native host kNN. ``timings``, if given, collects the
    seconds of ``knn_host``, ``knn_device`` and ``filter``; ``masks``, if
    given, receives the inlier mask into the original array after each
    filter."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    if device is not None:
        pts = pts.to(device)
    dev = pts.device
    alive = torch.arange(pts.shape[0], device=dev)
    for k, factor in filters:
        cur = pts[alive]
        if cur.shape[0] > use_grid_above:
            with stage(timings, "knn_host", dev):
                cur_np = cur.cpu().numpy()
                d2, idx = native.grid_knn(cur_np, cur_np, k + 1)
            with stage(timings, "filter", dev):
                mask = _inliers(torch.from_numpy(d2).to(dev), torch.from_numpy(idx).to(dev),
                                factor)
                del d2, idx
        else:
            with stage(timings, "knn_device", dev):
                d2, idx = knn_bruteforce(cur, cur, k + 1)
            with stage(timings, "filter", dev):
                mask = _inliers(d2, idx, factor)
        alive = alive[mask]
        if masks is not None:
            masks.append(_as_mask(alive, pts.shape[0]))
    return _as_mask(alive, pts.shape[0])


def _as_mask(alive, n: int) -> np.ndarray:
    out = np.zeros(n, bool)
    out[alive.cpu().numpy()] = True
    return out
