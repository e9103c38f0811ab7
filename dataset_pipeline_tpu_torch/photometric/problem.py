"""Photometric alignment problem state.

Port of ``dataset_pipeline_tpu/photometric/problem.py``: multi-scale point
levels with per-point K-neighbor indices and fixed descriptors, image
pyramids per camera group, per-image poses, and the occlusion splat points.
All tensors live on one device; images are one (B, H_s, W_s) float32 tensor
per scale; optionally camera rigs, fixed depth maps for the inverse-depth
residual, and an occlusion mesh.

``problem_from_numpy`` carries a problem state (the JAX package's, as numpy
arrays) into the port, so both optimizers can start from the same state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device, native
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.ops.knn import knn_bruteforce
from dataset_pipeline_tpu_torch.photometric.multiscale import PointLevel

DEFAULT_NEIGHBOR_COUNT = 5
DEFAULT_NEIGHBOR_CANDIDATES = 25
DEFAULT_MIN_MEAN_INTENSITY_DIFFERENCE = 5.0
BRUTEFORCE_NEIGHBOR_LIMIT = 200_000


def image_scale_count(width: int, height: int, max_initial_image_area: int = 200 * 160) -> int:
    """max(2, 1 + ceil(log4(area / max_initial_area)))."""
    area = width * height
    if area <= max_initial_image_area:
        return 2
    return max(2, 1 + int(np.ceil(np.log(area / max_initial_image_area) / np.log(4.0))))


def build_image_pyramid(images_u8, scale_count: int, device=None) -> List[torch.Tensor]:
    """(B,H,W) uint8 -> list of (B,H_s,W_s) float32 per scale (0 = full res),
    halving by 2x2 box averaging (odd sizes crop their last row/column). The
    averages are exact in float32 at every level, so the result does not
    depend on the summation order."""
    img = torch.as_tensor(np.asarray(images_u8), device=default_device(device)).to(torch.float32)
    pyr = [img]
    for _ in range(1, scale_count):
        b, h, w = pyr[-1].shape
        h2, w2 = h // 2, w // 2
        cropped = pyr[-1][:, : h2 * 2, : w2 * 2]
        pyr.append(cropped.reshape(b, h2, 2, w2, 2).mean((2, 4)))
    return pyr


@dataclass
class PhotoLevel:
    """One point scale on the device, with neighbors and descriptors."""

    points: torch.Tensor  # (N,3)
    intensities: torch.Tensor  # (N,)
    scan_indices: torch.Tensor  # (N,)
    neighbors: torch.Tensor  # (N,K) int64 indices into this level
    fixed_descriptors: torch.Tensor  # (N,K) neighbor minus center scan intensity
    radius: float


@dataclass
class ImageGroup:
    """All images sharing one intrinsics. ``min_image_scale`` is the global
    scale index of the group's finest pyramid level."""

    camera: cm.Camera  # camera of the group's finest level
    pyramid: List[torch.Tensor]  # per group level (B,H_l,W_l) float32
    poses: SE3  # (B,) image_T_global (derived for rig-dependent groups)
    image_ids: List[int]
    min_image_scale: int = 0
    mask_pyramid: Optional[List[torch.Tensor]] = None  # per scale (B,H_s,W_s) uint8
    # rig role: a group whose camera is a rig camera other than the
    # reference has its poses derived as image_T_rig . reference pose
    rig_id: int = -1
    rig_cam_index: int = 0
    ref_group: int = -1  # index of the reference camera's group
    ref_slots: Optional[np.ndarray] = None  # per image: index into the reference group

    @property
    def num_images(self) -> int:
        return int(self.poses.q.shape[0])

    @property
    def level_count(self) -> int:
        return len(self.pyramid)


@dataclass
class PhotoProblem:
    groups: List[ImageGroup]
    levels: List[PhotoLevel]
    occlusion_points: torch.Tensor  # (M,3) splat points (global frame)
    occlusion_radius: float  # splat world radius
    scale_count: int  # global image scale count
    max_valid_intensity: float = 252.0
    occlusion_depth_threshold: float = 0.01
    rig_extrinsics: List[SE3] = field(default_factory=list)  # per rig: (ncams,) image_T_rig
    occlusion_mesh: Optional[object] = None  # ops.mesh_raster.OcclusionMesh
    # fixed per-image depth maps of the inverse-depth residual: per group, per
    # group scale, (B,H_s,W_s) (build_image_pyramid of the depth maps)
    depth_map_pyramids: Optional[List[List[torch.Tensor]]] = None

    @property
    def num_images(self) -> int:
        return sum(g.num_images for g in self.groups)


def _neighbor_candidates(points: np.ndarray, cand: int, device=None) -> np.ndarray:
    """(N, cand) nearest-neighbor candidate indices (self excluded), -1 for
    missing slots: the native grid kNN above ``BRUTEFORCE_NEIGHBOR_LIMIT``
    points, the exact brute force on ``device`` below."""
    n = len(points)
    pts_np = np.ascontiguousarray(points, np.float32)
    if n > BRUTEFORCE_NEIGHBOR_LIMIT:
        return native.grid_knn(pts_np, pts_np, min(cand, n - 1), skip_self=True)[1]
    pts = torch.from_numpy(pts_np).to(default_device(device))
    _, idx = knn_bruteforce(pts, pts, min(cand + 1, n))
    idx = idx.cpu().numpy()
    # drop self matches, then stable-compact each row so valid candidates lead
    idx = np.where(idx == np.arange(n)[:, None], -1, idx)
    order = np.argsort(idx < 0, axis=1, kind="stable")
    return np.take_along_axis(idx, order, axis=1)[:, :cand]


def determine_point_neighbors(points: np.ndarray, scan_indices: np.ndarray,
                              k: int = DEFAULT_NEIGHBOR_COUNT,
                              num_candidates: int = DEFAULT_NEIGHBOR_CANDIDATES,
                              same_scan_only: bool = True,
                              seed: int = 0, device=None) -> np.ndarray:
    """K seeded-random picks from the nearest ``num_candidates`` neighbors,
    with the JAX package's ``RandomState`` draws (identical neighbors):
    uniform keys ranked per row, invalid slots last, cross-scan candidates
    after every same-scan one whenever >= k same-scan candidates exist."""
    n = len(points)
    idx = _neighbor_candidates(np.asarray(points), num_candidates, device)
    scan = np.asarray(scan_indices)
    valid = idx >= 0
    safe = np.maximum(idx, 0)
    same = (scan[safe] == scan[:, None]) & valid

    rng = np.random.RandomState(seed)
    keys = rng.rand(n, idx.shape[1])
    keys = np.where(valid, keys, np.inf)
    if same_scan_only:
        enough_same = same.sum(1) >= k
        keys = keys + np.where(enough_same[:, None] & valid & ~same, 2.0, 0.0)

    order = np.argsort(keys, axis=1, kind="stable")[:, :k]
    out = np.take_along_axis(safe, order, axis=1).astype(np.int32)
    picked_invalid = np.take_along_axis(~valid, order, axis=1)
    # rows with fewer than k candidates: repeat the first pick (edge-pad)
    return np.where(picked_invalid, out[:, :1], out)


def gradient_filter_mask(intensities: np.ndarray, neighbors: np.ndarray,
                         min_mean_diff: float = DEFAULT_MIN_MEAN_INTENSITY_DIFFERENCE,
                         dilate: bool = True):
    """Keep points whose mean |descriptor| is at least ``min_mean_diff``;
    with ``dilate`` every K-neighbor of a kept point is kept too."""
    d = intensities[neighbors] - intensities[:, None]
    keep = np.abs(d).mean(1) >= min_mean_diff
    if not dilate:
        return keep
    dilated = keep.copy()
    dilated[neighbors[keep].ravel()] = True
    return dilated


def _level_to_device(pts, inten, scans, neighbors, desc, radius, device) -> PhotoLevel:
    device = default_device(device)

    def dev(a, dtype):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    return PhotoLevel(dev(pts, torch.float32), dev(inten, torch.float32),
                      dev(scans, torch.uint8), dev(neighbors, torch.int64),
                      dev(desc, torch.float32), float(radius))


def build_photo_level(level: PointLevel, k: int = DEFAULT_NEIGHBOR_COUNT,
                      apply_gradient_filter: bool = True, seed: int = 0,
                      num_candidates: int = DEFAULT_NEIGHBOR_CANDIDATES,
                      min_mean_diff: float = DEFAULT_MIN_MEAN_INTENSITY_DIFFERENCE,
                      device=None) -> Optional[PhotoLevel]:
    pts, inten, scans = level.points, level.intensities, level.scan_indices
    if len(pts) <= k + 1:
        return None
    neighbors = determine_point_neighbors(pts, scans, k=k, num_candidates=num_candidates,
                                          seed=seed, device=device)
    if apply_gradient_filter:
        keep = gradient_filter_mask(inten, neighbors, min_mean_diff)
        if keep.sum() < k + 1:
            return None
        # restrict to kept points; re-pick neighbors among the kept ones
        pts, inten, scans = pts[keep], inten[keep], scans[keep]
        neighbors = determine_point_neighbors(pts, scans, k=k, num_candidates=num_candidates,
                                              seed=seed + 1, device=device)
    desc = (inten[neighbors] - inten[:, None]).astype(np.float32)
    return _level_to_device(pts, inten, scans, neighbors, desc, level.radius, device)


def problem_from_numpy(levels, groups, occlusion_points, occlusion_radius: float,
                       scale_count: int, max_valid_intensity: float = 252.0,
                       occlusion_depth_threshold: float = 0.01,
                       device=None, rig_extrinsics=(), depth_map_pyramids=None) -> PhotoProblem:
    """A :class:`PhotoProblem` on ``device`` from numpy state.

    ``levels``: per level a dict with ``points, intensities, scan_indices,
    neighbors, fixed_descriptors, radius``. ``groups``: per camera group a
    dict with ``model, width, height, params, radius_cutoff_sq`` (the
    camera, cutoff carried as is), ``pyramid`` (per scale (B,H_s,W_s)),
    ``q (B,4)`` wxyz and ``t (B,3)`` (image_T_global), ``image_ids``,
    ``min_image_scale`` and optionally ``mask_pyramid`` and the rig role
    (``rig_id``, ``rig_cam_index``, ``ref_group``, ``ref_slots``).
    ``rig_extrinsics``: per rig (q (ncams,4), t (ncams,3));
    ``depth_map_pyramids``: per group, per scale (B,H_s,W_s)."""
    device = default_device(device)
    lv = [_level_to_device(d["points"], d["intensities"], d["scan_indices"],
                           d["neighbors"], d["fixed_descriptors"], d["radius"], device)
          for d in levels]

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    gs = []
    for d in groups:
        cam = cm.Camera(d["model"], int(d["width"]), int(d["height"]), f32(d["params"]),
                        f32(d["radius_cutoff_sq"]))
        masks = d.get("mask_pyramid")
        gs.append(ImageGroup(
            camera=cam, pyramid=[f32(p) for p in d["pyramid"]],
            poses=SE3(f32(d["q"]), f32(d["t"])), image_ids=list(d["image_ids"]),
            min_image_scale=int(d.get("min_image_scale", 0)),
            mask_pyramid=None if masks is None else
            [torch.as_tensor(np.array(m, np.uint8), device=device) for m in masks],
            rig_id=int(d.get("rig_id", -1)), rig_cam_index=int(d.get("rig_cam_index", 0)),
            ref_group=int(d.get("ref_group", -1)),
            ref_slots=None if d.get("ref_slots") is None else np.asarray(d["ref_slots"], np.int32)))
    depth = None if depth_map_pyramids is None else [[f32(p) for p in per_group]
                                                     for per_group in depth_map_pyramids]
    return PhotoProblem(groups=gs, levels=lv, occlusion_points=f32(occlusion_points),
                        occlusion_radius=float(occlusion_radius), scale_count=int(scale_count),
                        max_valid_intensity=float(max_valid_intensity),
                        occlusion_depth_threshold=float(occlusion_depth_threshold),
                        rig_extrinsics=[SE3(f32(q), f32(t)) for q, t in rig_extrinsics],
                        depth_map_pyramids=depth)
