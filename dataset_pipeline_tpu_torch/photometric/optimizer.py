"""Photometric joint pose + intrinsics Gauss-Newton/LM optimizer.

Port of ``dataset_pipeline_tpu/photometric/optimizer.py`` (the main path:
one or more camera groups, fixed and variable descriptor residuals, splat
occlusion; rigs, depth residuals, the occlusion mesh and the observations
cache wait for later slices):

- **Visibility**: project every point of every level into every image; z-test
  against the splat occlusion depth with slack; the continuous observation
  scale ``log2(2 * radius_px)`` must lie in [current_scale, scale_count-1);
  border, mask and oversaturation checks at the coarser interpolation scale.
- **Residuals**: a point contributes iff its center and all K neighbors are
  observed; component k is (I(neighbor_k) - I(center)) - descriptor_k,
  Huber-weighted on the component-vector norm.
- **Jacobians**: one trilinear sample with analytic derivatives per
  observation (``ops/pyramid_sample.py``, the CUDA kernel on the card) chained
  with forward-mode derivatives (``torch.func.jvp`` over the variables) of the
  gather-free projection and footprint-scale math.
- **LM**: H diagonal *= (1+lambda), accept if the cost decreases with frozen
  visibility, lambda halve/double, 10 tries, force-apply the last try.
  Variables: the intrinsics blocks first, then 6 dof per image.

The JAX ``vmap`` over an image chunk becomes an explicit leading image
dimension (``nb``). Each chunk's flat pyramid is built once, when its
:class:`ImageBatch` is made. The small solve runs on the host in float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.ops.pyramid_sample import (
    PyramidLayout,
    flatten_pyramid,
    pair_rows,
    pyramid_sample,
)
from dataset_pipeline_tpu_torch.ops.robust import DEFAULT_COLOR_HUBER, huber_rho, huber_weight
from dataset_pipeline_tpu_torch.ops.splat import render_splats_depth
from dataset_pipeline_tpu_torch.photometric.problem import PhotoProblem
from dataset_pipeline_tpu_torch.utils.timing import stage

_INVALID_INTENSITY = 3.0e8  # neighbor-validity sentinel, exact in float32
_JVP_ELEMENTS = 1 << 25  # (tangent, image, point) triples per vmapped jvp pass
_GRAM_ROWS = 8192  # rows per batch entry of the split Gram products


# ---------------------------------------------------------------------------
# Differentiable projection helpers
# ---------------------------------------------------------------------------


def _scaled_params(camera: cm.Camera, params, scale: int):
    """Full-res params -> params of the 2^-scale camera, differentiably
    (the formula of ``scaled_by``; linear in the originals)."""
    factor = 2.0 ** (-scale)
    if camera.spec.unique_focal:
        head = torch.stack([params[0] * factor, factor * (params[1] + 0.5) - 0.5,
                            factor * (params[2] + 0.5) - 0.5])
        return torch.cat([head, params[3:]])
    head = torch.stack([params[0] * factor, params[1] * factor,
                        factor * (params[2] + 0.5) - 0.5, factor * (params[3] + 0.5) - 0.5])
    return torch.cat([head, params[4:]])


def _project_full(camera: cm.Camera, params, p_cam):
    """Project with explicit params at scale 0: (pix, valid)."""
    return cm.project(camera.with_params(params), p_cam)


def _exp2(k):
    """2^k for integer-valued float ``k``, exact (``pow`` of 2)."""
    return torch.pow(2.0, k)


def _batch_pose(q, t) -> SE3:
    """(nb,) poses shaped to broadcast against (M,3) points: (nb,1,·)."""
    return SE3(q[:, None, :], t[:, None, :])


def _footprint_scale(camera, params, pose: SE3, points, radius):
    """Continuous observation scale log2(2 radius_px) as a differentiable
    function of intrinsics and pose (the formula of the visibility pass, so
    values coincide at the linearization point)."""
    c = camera.with_params(params)
    p_cam = pose.apply(points)
    pix, _ = cm.project(c, p_cam)
    z = p_cam[..., 2]
    eps = 1e-3 * torch.clamp(z, min=1e-6)
    p2 = p_cam + torch.stack([eps, torch.zeros_like(eps), torch.zeros_like(eps)], -1)
    pix2, _ = cm.project(c, p2)
    px_per_m = torch.sqrt(cm._sqnorm(pix2 - pix, keepdim=False)) / eps
    return torch.log2(torch.clamp(2.0 * radius * px_per_m, min=1e-12))


# ---------------------------------------------------------------------------
# Visibility: observation masks and frozen observation scales
# ---------------------------------------------------------------------------


def _visibility_core(camera: cm.Camera, pose_q, pose_t, points, radius, occl_depth,
                     current_scale, scale_count: int, width: int, height: int,
                     depth_slack=0.01, min_depth=0.05):
    """(visible (nb,M), obs_scale (nb,M)) of points (M,3) in a chunk of
    images with poses (nb,4)/(nb,3) and full-res occlusion depths (nb,H,W)."""
    p_cam = _batch_pose(pose_q, pose_t).apply(points)
    pix, valid = cm.project(camera, p_cam)
    z = p_cam[..., 2]

    # occlusion z-test with slack (float bounds before the int cast)
    ix = torch.clamp(torch.round(pix[..., 0]).nan_to_num(0.0), 0, width - 1).long()
    iy = torch.clamp(torch.round(pix[..., 1]).nan_to_num(0.0), 0, height - 1).long()
    occ = torch.gather(occl_depth.reshape(occl_depth.shape[0], -1), 1, iy * width + ix)
    valid = valid & (z <= occ + depth_slack) & (z > min_depth)

    # footprint scale
    eps = 1e-3 * torch.clamp(z, min=1e-6)
    p2 = p_cam + torch.stack([eps, torch.zeros_like(eps), torch.zeros_like(eps)], -1)
    pix2, _ = cm.project(camera, p2)
    px_per_m = torch.sqrt(cm._sqnorm(pix2 - pix, keepdim=False)) / eps
    obs_scale = torch.log2(torch.clamp(2.0 * (radius * px_per_m), min=1e-12))

    valid = (valid & (obs_scale >= current_scale)
             & (torch.floor(obs_scale) < scale_count - 1) & (obs_scale >= 0))

    # border check at the coarser interpolation scale
    factor = _exp2(-(torch.floor(obs_scale) + 1))
    xs = factor * (pix[..., 0] + 0.5) - 0.5
    ys = factor * (pix[..., 1] + 0.5) - 0.5
    w_si = torch.floor(width * factor + 0.5)
    h_si = torch.floor(height * factor + 0.5)
    border = 1.0
    valid = (valid & (xs + 0.5 >= border) & (ys + 0.5 >= border)
             & (xs + 0.5 < w_si - border) & (ys + 0.5 < h_si - border))
    return valid, obs_scale


def _mask_filter_core(camera: cm.Camera, pose_q, pose_t, points, obs_scale, valid,
                      flat, layout: PyramidLayout, mask_flat, max_valid_intensity):
    """Reject observations whose pixel at the coarser interpolation level is
    masked or oversaturated: one flat-pyramid lookup per observation.
    ``mask_flat`` is None (no masks) or the (nb, total) uint8 mask pyramid."""
    L = layout.levels
    if L <= 1:
        return valid
    p_cam = _batch_pose(pose_q, pose_t).apply(points)
    pix, _ = cm.project(camera, p_cam)
    si = torch.floor(obs_scale).nan_to_num(0.0) + 1
    sic = torch.clamp(si, 1, L - 1).long()
    dev = flat.device
    H_l = torch.tensor(layout.hs, device=dev)[sic]
    W_l = torch.tensor(layout.ws, device=dev)[sic]
    o_l = torch.tensor(layout.offs, device=dev)[sic]
    f = _exp2(-sic.to(torch.float32))
    xs = f * (pix[..., 0] + 0.5) - 0.5
    ys = f * (pix[..., 1] + 0.5) - 0.5
    ix = torch.minimum(torch.clamp(torch.floor(xs + 0.5).nan_to_num(0.0), min=0.0),
                       (W_l - 1).to(xs.dtype)).long()
    iy = torch.minimum(torch.clamp(torch.floor(ys + 0.5).nan_to_num(0.0), min=0.0),
                       (H_l - 1).to(ys.dtype)).long()
    idx = o_l + iy * W_l + ix
    bad = torch.gather(flat, 1, idx) > max_valid_intensity
    if mask_flat is not None:
        bad = bad | (torch.gather(mask_flat, 1, idx) != 0)
    in_range = (si >= 1) & (si <= L - 1)
    return valid & ~(in_range & bad)


# ---------------------------------------------------------------------------
# Intensities, cost and descriptors
# ---------------------------------------------------------------------------


def _nbr_inten_ok(inten, ok, neighbors):
    """Neighbor (intensity, validity) in one gather: validity rides as the
    3e8 sentinel inside the intensity plane (intensities live in [0, 255]).
    ``inten``/``ok`` (nb,M), ``neighbors`` (M,K) -> (nb,M,K) each."""
    enc = torch.where(ok, inten, torch.full_like(inten, _INVALID_INTENSITY))
    ge = enc[:, neighbors]
    nbr_ok = ge < 1.5e8
    return torch.where(nbr_ok, ge, torch.zeros_like(ge)), nbr_ok


def _point_intensities(camera, params, pose_q, pose_t, points, flat, layout, obs_scale,
                       pairs=None):
    """(intensity, valid) (nb,M) of every point under the given state.
    ``pairs``: the row-paired copy of ``flat`` that the sampling kernel reads
    on the card (``ImageBatch.pairs``)."""
    p_cam = _batch_pose(pose_q, pose_t).apply(points)
    pix, valid = _project_full(camera, params, p_cam)
    val, ok = pyramid_sample(flat, layout, pix.contiguous(), obs_scale.contiguous(),
                             with_derivs=False, pairs=pairs)
    return val, valid & ok


def _cost_batch(camera, params, pose_q, pose_t, points, neighbors, desc, flat, layout,
                obs_scale, contrib, pairs=None):
    """Summed (cost, count) of a chunk of images on one level (tensors)."""
    inten, ok = _point_intensities(camera, params, pose_q, pose_t, points, flat, layout,
                                   obs_scale, pairs)
    nbr_inten, nbr_ok = _nbr_inten_ok(inten, ok, neighbors)
    all_ok = ok & torch.all(nbr_ok, -1) & contrib
    r = (nbr_inten - inten[..., None]) - desc
    r = torch.where(all_ok[..., None], r, torch.zeros_like(r))
    norm = torch.sqrt(torch.clamp(torch.sum(r * r, -1), min=1e-20))
    rho = huber_rho(norm, DEFAULT_COLOR_HUBER)
    cost = torch.sum(torch.where(all_ok, rho, torch.zeros_like(rho)), 1)
    return torch.sum(cost), torch.sum(all_ok)


def _imgdesc_batch(camera, params, pose_q, pose_t, points, neighbors, flat, layout,
                   obs_scale, contrib, pairs=None):
    """A chunk's contribution to the variable-descriptor mean: image-space
    descriptors of fully observed points summed over the chunk's images
    (desc_sum (M,K), count (M,) int32)."""
    inten, ok = _point_intensities(camera, params, pose_q, pose_t, points, flat, layout,
                                   obs_scale, pairs)
    nbr_inten, nbr_ok = _nbr_inten_ok(inten, ok, neighbors)
    all_ok = ok & torch.all(nbr_ok, -1) & contrib
    d = nbr_inten - inten[..., None]
    d = torch.where(all_ok[..., None], d, torch.zeros_like(d))
    return torch.sum(d, 0), torch.sum(all_ok.to(torch.int32), 0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# H, b
# ---------------------------------------------------------------------------


def _gram(x, y):
    """Per-image x^T y: (nb,M,a), (nb,M,b) -> (nb,a,b) in strict fp32.

    The row axis is cut into slices of ``_GRAM_ROWS`` that become separate
    batch entries, summed afterwards: one (a x M)(M x b) product per image
    with M ~ 10^6 and a, b <= 10 leaves cuBLAS a handful of output tiles, so
    it ran on a few SMs (~18 ms per product on the H100, 75 % of the
    registrator's device time)."""
    nb, M, a = x.shape
    S = M // _GRAM_ROWS
    n = S * _GRAM_ROWS
    out = None
    if S:
        out = torch.bmm(x[:, :n].reshape(nb * S, _GRAM_ROWS, a).transpose(1, 2),
                        y[:, :n].reshape(nb * S, _GRAM_ROWS, y.shape[-1])
                        ).view(nb, S, a, -1).sum(1)
    if n < M:
        rest = torch.bmm(x[:, n:].transpose(1, 2), y[:, n:])
        out = rest if out is None else out + rest
    return out


def _gram_assemble(J, inten, ok, neighbors, desc, contrib_mask):
    """H (nb,V,V), b (nb,V), cost, count from the per-point intensity
    Jacobian J (nb,M,V).

    The residual rows r_nk = I[nbr_nk] - I[n] - d_nk have Jacobian
    J[nbr_nk] - J[n]; the Gram sum is expanded per neighbor slot k with
    A_k = J[nbr_:,k] (one gather each, then strict-fp32 batched products,
    :func:`_gram`):

      H = sum_k [A_k^T W A_k - A_k^T W J - (A_k^T W J)^T] + K J^T W J
      b = sum_k A_k^T (w r_k)  -  J^T (w sum_k r_k)
    """
    nbr_inten, nbr_ok = _nbr_inten_ok(inten, ok, neighbors)
    all_ok = ok & torch.all(nbr_ok, -1) & contrib_mask
    r = (nbr_inten - inten[..., None]) - desc
    r = torch.where(all_ok[..., None], r, torch.zeros_like(r))
    norm = torch.sqrt(torch.clamp(torch.sum(r * r, -1), min=1e-20))
    rho = huber_rho(norm, DEFAULT_COLOR_HUBER)
    w = torch.where(all_ok, huber_weight(norm, DEFAULT_COLOR_HUBER), torch.zeros_like(norm))
    # invalid points carry no weight but may hold non-finite J entries
    J = torch.where(ok[..., None], J, torch.zeros_like(J))
    K = neighbors.shape[1]
    H = K * _gram(w[..., None] * J, J)
    b = -_gram(J, (w * torch.sum(r, -1))[..., None])[..., 0]
    for k in range(K):
        Ak = J[:, neighbors[:, k]]
        WAk = w[..., None] * Ak
        M = _gram(WAk, J)
        H = H + _gram(WAk, Ak) - M - M.transpose(1, 2)
        b = b + _gram(Ak, (w * r[..., k])[..., None])[..., 0]
    cost = torch.sum(torch.sum(torch.where(all_ok, rho, torch.zeros_like(rho)), 1))
    return H, b, cost, torch.sum(all_ok)


def _hb_batch(camera, params, pose_q, pose_t, points, neighbors, desc, flat, layout,
              obs_scale, contrib, radius, optimize_intrinsics: bool, dynamic_scale: bool,
              pairs=None):
    """Per-image H (nb,V,V), b (nb,V) and the chunk's summed cost/count on
    one level. Variable layout of a block: [P intrinsics | 6 pose].

    One sample with analytic derivatives per observation (dI/dpix, dI/dscale)
    chained with forward-mode Jacobians of the gather-free projection and
    footprint math: each image's pixel depends only on its own pose, so one
    shared 6-vector tangent gives every image's pose Jacobian at once."""
    pose0 = _batch_pose(pose_q, pose_t)

    def geom(eps, prm):
        pose = SE3.exp(eps).compose(pose0)
        pix, _ = _project_full(camera, prm, pose.apply(points))
        if dynamic_scale:
            fp = _footprint_scale(camera, prm, pose, points, radius)
        else:
            fp = torch.zeros(pix.shape[:-1], dtype=pix.dtype, device=pix.device)
        return pix, fp

    eps0 = torch.zeros(6, dtype=torch.float32, device=points.device)
    pix, _ = geom(eps0, params)
    _, valid = _project_full(camera, params, pose0.apply(points))
    inten, dpx, dpy, dvds, okS = pyramid_sample(flat, layout, pix.contiguous(),
                                                obs_scale.contiguous(), with_derivs=True,
                                                pairs=pairs)
    ok = valid & okS

    # forward mode over the 6+P tangents (what jacfwd computes), vmapped in
    # chunks so that no intermediate holds more than ~_JVP_ELEMENTS points
    P = params.shape[0]
    basis = torch.eye(6 + P, dtype=torch.float32, device=eps0.device)
    if not optimize_intrinsics:
        basis = basis[P:]

    def column(t):
        _, (dpix, dfp) = torch.func.jvp(geom, (eps0, params), (t[P:], t[:P]))
        col = dpx * dpix[..., 0] + dpy * dpix[..., 1]
        return col + dvds * dfp if dynamic_scale else col

    chunk = max(1, _JVP_ELEMENTS // max(pix.shape[0] * pix.shape[1], 1))
    J = torch.func.vmap(column, out_dims=-1, chunk_size=chunk)(basis)  # (nb, M, V)
    return _gram_assemble(J, inten, ok, neighbors, desc, contrib)


# ---------------------------------------------------------------------------
# Per-chunk passes over every level (the JAX package fuses these into one
# relay dispatch; here they are plain loops with the same results)
# ---------------------------------------------------------------------------


def _visibility_mask_levels(camera, pose_q, pose_t, occl, level_args, current_scale,
                            scale_count: int, width: int, height: int, depth_slack,
                            min_depth, max_valid_intensity, flat, layout, mask_flat):
    """All levels' visibility + mask filter for one image chunk.
    ``level_args``: per level (points, radius). Returns per level (mask, obs_scale)."""
    outs = []
    for points, radius in level_args:
        m, sc = _visibility_core(camera, pose_q, pose_t, points, radius, occl,
                                 current_scale, scale_count, width, height,
                                 depth_slack, min_depth)
        m = _mask_filter_core(camera, pose_q, pose_t, points, sc, m, flat, layout,
                              mask_flat, max_valid_intensity)
        outs.append((m, sc))
    return tuple(outs)


def _hb_batch_levels(camera, params, pose_q, pose_t, entries, flat, layout,
                     optimize_intrinsics: bool, dynamic_scale: bool, pairs=None):
    """A chunk's H,b accumulations, one per (level, residual type) entry of
    (points, neighbors, desc, obs_scale, contrib, radius)."""
    return tuple(_hb_batch(camera, params, pose_q, pose_t, pts, nbr, d, flat, layout, sc,
                           m, rad, optimize_intrinsics, dynamic_scale, pairs)
                 for (pts, nbr, d, sc, m, rad) in entries)


def _cost_batch_levels(camera, params, pose_q, pose_t, entries, flat, layout, pairs=None):
    """A chunk's cost evaluations, one per (points, neighbors, desc,
    obs_scale, contrib) entry."""
    return tuple(_cost_batch(camera, params, pose_q, pose_t, pts, nbr, d, flat, layout,
                             sc, m, pairs)
                 for (pts, nbr, d, sc, m) in entries)


def _chunk_indices(n: int, chunk: int):
    """Split range(n) into chunks of at most ``chunk`` image indices. (The
    JAX package pads the last chunk to a power of two to bound its compiled
    shapes; nothing is compiled per shape here, so the remainder stays as is.)"""
    return [np.arange(start, min(start + chunk, n)) for start in range(0, n, chunk)]


@dataclass
class ImageBatch:
    """One image chunk of one group: indices and the chunk's flat pyramid,
    built once (the level geometry is shared by every image), and on the card
    the row-paired copy that the sampling kernel reads."""

    idx: np.ndarray  # (nb,) image indices within the group
    idx_dev: torch.Tensor  # (nb,) device copy of ``idx``
    flat: torch.Tensor  # (nb, total) float32 pyramid
    layout: PyramidLayout
    mask_flat: Optional[torch.Tensor] = None  # (nb, total) uint8 or None
    pairs: Optional[torch.Tensor] = None  # (nb, layout.pair_total) float32 on CUDA, else None

    @property
    def nb(self) -> int:
        return len(self.idx)


# ---------------------------------------------------------------------------
# Scale schedule and LM iterations
# ---------------------------------------------------------------------------


@dataclass
class OptimizerReport:
    iterations: int
    optimum_cost: float
    converged: bool


class PhotometricOptimizer:
    """Coarse-to-fine scale schedule of LM iterations over image groups.

    Variable layout: one intrinsics block per group first, then 6 pose dofs
    per image, ordered by group then image. ``timings``, if given, collects
    per-stage seconds (the card is synchronized around each stage).
    """

    def __init__(self, problem: PhotoProblem, optimize_intrinsics: bool = True,
                 max_radius_px: int = 3, fixed_weight: float = 1.0,
                 variable_weight: float = 0.0, image_chunk: int = 8,
                 scale_jacobian: bool = True, timings: Optional[dict] = None):
        self.p = problem
        self.optimize_intrinsics = optimize_intrinsics
        self.max_radius_px = max_radius_px
        self.fixed_weight = fixed_weight
        self.variable_weight = variable_weight
        self.scale_jacobian = scale_jacobian
        self.image_chunk = image_chunk
        self.timings = timings
        self.device = problem.occlusion_points.device
        self.current_scale = problem.scale_count - 1
        self.lam = 64.0
        self._var_desc = None
        self._frozen_vis = None
        self.observations = 0  # visible (image, point) pairs of the last refresh
        self._build_batches()

    def _stage(self, name: str):
        return stage(self.timings, name, self.device)

    # -- image chunking --------------------------------------------------------

    def _build_batches(self):
        """Per group, the image chunks with their flat pyramids (and on the
        card their row-paired copies; the plain sampler reads ``flat``)."""
        self._batches = []
        for g in self.p.groups:
            batches = []
            for idx in _chunk_indices(g.num_images, self.image_chunk):
                idx_dev = torch.as_tensor(idx, dtype=torch.long, device=self.device)
                flat, layout = flatten_pyramid([g.pyramid[s][idx_dev]
                                                for s in range(g.level_count)])
                mask_flat = None
                if g.mask_pyramid:
                    mask_flat, _ = flatten_pyramid([m[idx_dev] for m in g.mask_pyramid])
                pairs = pair_rows(flat, layout) if flat.is_cuda else None
                batches.append(ImageBatch(idx, idx_dev, flat, layout, mask_flat, pairs))
            self._batches.append(batches)

    # -- variable indexing ---------------------------------------------------

    def _var_layout(self):
        """[intrinsics blocks][6 per image]: (offsets_int, offsets_pose, V)."""
        offsets_int = []
        off = 0
        if self.optimize_intrinsics:
            for g in self.p.groups:
                offsets_int.append(off)
                off += int(g.camera.params.shape[0])
        else:
            offsets_int = [None] * len(self.p.groups)
        offsets_pose = []
        for g in self.p.groups:
            offsets_pose.append(off)
            off += 6 * g.num_images
        return offsets_int, offsets_pose, off

    # -- occlusion ----------------------------------------------------------

    def _occlusion_depths(self):
        """Splat occlusion depth per group, (B,H,W) at full resolution,
        ``image_chunk`` images per render."""
        out = []
        radii = torch.full((self.p.occlusion_points.shape[0],), self.p.occlusion_radius,
                           dtype=torch.float32, device=self.device)
        for gi, g in enumerate(self.p.groups):
            cam = g.camera
            chunks = []
            for b in self._batches[gi]:
                p_cam = _batch_pose(g.poses.q[b.idx_dev], g.poses.t[b.idx_dev]).apply(
                    self.p.occlusion_points)
                chunks.append(render_splats_depth(p_cam, radii, cam.width, cam.height, cam.fx,
                                                  cam.fy, cam.cx, cam.cy,
                                                  max_radius_px=self.max_radius_px))
            out.append(torch.cat(chunks, 0))
        return out

    # -- visibility ----------------------------------------------------------

    def _visibility(self, occl):
        """vis[gi][l][bi] = (mask (nb,M), obs_scale (nb,M)), aligned with the
        group's chunks."""
        vis = []
        for gi, g in enumerate(self.p.groups):
            cam = g.camera
            local_current = float(max(self.current_scale - g.min_image_scale, 0))
            per_level = [[] for _ in self.p.levels]
            level_args = [(lv.points, lv.radius) for lv in self.p.levels]
            for b in self._batches[gi]:
                outs = _visibility_mask_levels(
                    cam, g.poses.q[b.idx_dev], g.poses.t[b.idx_dev], occl[gi][b.idx_dev],
                    level_args, local_current, g.level_count, cam.width, cam.height,
                    self.p.occlusion_depth_threshold, 0.05, self.p.max_valid_intensity,
                    b.flat, b.layout, b.mask_flat)
                for l, o in enumerate(outs):
                    per_level[l].append(o)
            vis.append(per_level)
        return vis

    # -- variable descriptors (ColorOptimizer alternation) --------------------

    def _compute_variable_descriptors(self, vis):
        """Mean image-space descriptor per point-neighbor edge over all images
        that fully observe the point. Per level (desc (N,K), mask (N,):
        observed by at least two images)."""
        out = []
        for l, level in enumerate(self.p.levels):
            n, k = level.fixed_descriptors.shape
            desc_sum = torch.zeros((n, k), dtype=torch.float32, device=self.device)
            count = torch.zeros((n,), dtype=torch.int32, device=self.device)
            for gi, g in enumerate(self.p.groups):
                for bi, b in enumerate(self._batches[gi]):
                    mask, s = vis[gi][l][bi]
                    d, ok = _imgdesc_batch(g.camera, g.camera.params, g.poses.q[b.idx_dev],
                                           g.poses.t[b.idx_dev], level.points, level.neighbors,
                                           b.flat, b.layout, s, mask, b.pairs)
                    desc_sum = desc_sum + d
                    count = count + ok
            desc = desc_sum / torch.clamp(count, min=1)[:, None]
            out.append((desc, count >= 2))
        return out

    def _residual_weights(self):
        """Static weights of the active residual types, in set order."""
        weights = []
        if self.fixed_weight > 0:
            weights.append(self.fixed_weight)
        if self.variable_weight > 0 and self._var_desc is not None:
            weights.append(self.variable_weight)
        return weights

    def _residual_sets(self, level_idx: int):
        """[(descriptors (N,K), extra mask (N,) or None, weight)] per active type."""
        sets = []
        if self.fixed_weight > 0:
            sets.append((self.p.levels[level_idx].fixed_descriptors, None, self.fixed_weight))
        if self.variable_weight > 0 and self._var_desc is not None:
            desc, mask2 = self._var_desc[level_idx]
            sets.append((desc, mask2, self.variable_weight))
        return sets

    # -- cost -----------------------------------------------------------------

    def _total_cost(self, group_params, group_poses, vis) -> float:
        """Weighted mean cost per residual type, summed; every term is
        evaluated first and fetched in one transfer."""
        keys, terms = [], []
        for gi, g in enumerate(self.p.groups):
            for bi, b in enumerate(self._batches[gi]):
                q = group_poses[gi].q[b.idx_dev]
                t = group_poses[gi].t[b.idx_dev]
                entries = []
                for l, level in enumerate(self.p.levels):
                    mask, sc = vis[gi][l][bi]
                    for ti, (desc, extra, _) in enumerate(self._residual_sets(l)):
                        m = mask if extra is None else (mask & extra)
                        entries.append((level.points, level.neighbors, desc, sc, m))
                        keys.append(ti)
                for c, n in _cost_batch_levels(g.camera, group_params[gi], q, t, entries,
                                               b.flat, b.layout, b.pairs):
                    terms.extend([c.double(), n.double()])
        fetched = torch.stack(terms).cpu().numpy() if terms else np.zeros(0)
        sums, counts = {}, {}
        for i, key in enumerate(keys):
            sums[key] = sums.get(key, 0.0) + float(fetched[2 * i])
            counts[key] = counts.get(key, 0) + int(fetched[2 * i + 1])
        weights = self._residual_weights() if self.p.levels else []
        return sum(weights[ti] * sums[ti] / max(counts[ti], 1) for ti in sums)

    # -- LM step --------------------------------------------------------------

    def _candidate_state(self, x, offsets_int, offsets_pose):
        """Per-group intrinsics and poses after applying the (inverted)
        update vector ``x``."""
        new_params, new_poses = [], []
        for gi, g in enumerate(self.p.groups):
            P = int(g.camera.params.shape[0])
            prm = g.camera.params
            if self.optimize_intrinsics:
                oi = offsets_int[gi]
                prm = prm - torch.as_tensor(x[oi:oi + P], dtype=torch.float32,
                                            device=self.device)
            new_params.append(prm)
            op = offsets_pose[gi]
            deltas = -x[op:op + 6 * g.num_images].reshape(g.num_images, 6)
            dT = SE3.exp(torch.as_tensor(deltas.astype(np.float32), device=self.device))
            new_poses.append(dT.compose(g.poses))
        return new_params, new_poses

    def _lm_accumulate(self, vis):
        """Every (chunk, level, type) H,b accumulation, assembled into the big
        float64 system on the host, and the weighted-mean entry cost (the
        quantity ``_total_cost`` computes, from the same passes)."""
        offsets_int, offsets_pose, V = self._var_layout()
        H = np.zeros((V, V), np.float64)
        bb = np.zeros(V, np.float64)
        cost_sums = [(0.0, 0) for _ in self._residual_weights()]

        pend = []
        for gi, g in enumerate(self.p.groups):
            P = int(g.camera.params.shape[0])
            nint = P if self.optimize_intrinsics else 0
            for bi, b in enumerate(self._batches[gi]):
                entries, metas = [], []
                for l, level in enumerate(self.p.levels):
                    mask, sc = vis[gi][l][bi]
                    for ti, (desc, extra, w_t) in enumerate(self._residual_sets(l)):
                        m = mask if extra is None else (mask & extra)
                        entries.append((level.points, level.neighbors, desc, sc, m,
                                        level.radius))
                        metas.append(dict(gi=gi, ti=ti, w=w_t, batch=b, nint=nint, P=P))
                outs = _hb_batch_levels(g.camera, g.camera.params, g.poses.q[b.idx_dev],
                                        g.poses.t[b.idx_dev], entries, b.flat, b.layout,
                                        self.optimize_intrinsics, self.scale_jacobian, b.pairs)
                pend.extend(zip(metas, outs))

        # one transfer, then assemble the big system in numpy
        flat = torch.cat([torch.cat([Hc.reshape(-1).double(), bc.reshape(-1).double(),
                                     c.double()[None], n.double()[None]])
                          for _, (Hc, bc, c, n) in pend]).cpu().numpy() if pend else None
        pos = 0
        for meta, (Hc_t, bc_t, _, _) in pend:
            nh, nbv = Hc_t.numel(), bc_t.numel()
            Hc = flat[pos:pos + nh].reshape(Hc_t.shape)
            bc = flat[pos + nh:pos + nh + nbv].reshape(bc_t.shape)
            c, n = flat[pos + nh + nbv], flat[pos + nh + nbv + 1]
            pos += nh + nbv + 2
            gi, b = meta["gi"], meta["batch"]
            nint, P, w_t = meta["nint"], meta["P"], meta["w"]
            oi = offsets_int[gi]
            for j in range(b.nb):
                slices = []
                if nint:
                    slices.append((slice(oi, oi + P), 0, P))
                op = offsets_pose[gi] + 6 * int(b.idx[j])
                slices.append((slice(op, op + 6), nint, 6))
                for (sa, a0, la) in slices:
                    bb[sa] += w_t * bc[j][a0:a0 + la]
                    for (sb, b0, lb) in slices:
                        H[sa, sb] += w_t * Hc[j][a0:a0 + la, b0:b0 + lb]
            ti = meta["ti"]
            cost_sums[ti] = (cost_sums[ti][0] + float(c), cost_sums[ti][1] + int(n))
        initial = sum(w * s_ / max(n_, 1)
                      for w, (s_, n_) in zip(self._residual_weights(), cost_sums))
        return H, bb, initial, (offsets_int, offsets_pose)

    def _lm_solve_apply(self, H, bb, initial, offsets, vis):
        """The damped accept/reject ladder over the assembled system."""
        offsets_int, offsets_pose = offsets
        for lm_try in range(10):
            Hlm = H.copy()
            np.fill_diagonal(Hlm, np.diag(H) * (1.0 + self.lam))
            try:
                x = np.linalg.solve(Hlm, bb)
            except np.linalg.LinAlgError:
                self.lam *= 2.0
                continue
            new_params, new_poses = self._candidate_state(x, offsets_int, offsets_pose)
            cand_cost = self._total_cost(new_params, new_poses, vis)
            if cand_cost < initial or lm_try == 9:  # force-apply the last try
                for gi, g in enumerate(self.p.groups):
                    g.camera = g.camera.with_params(new_params[gi])
                    g.poses = new_poses[gi]
                self.lam *= 0.5
                return True, float(np.max(np.abs(x))) if len(x) else 0.0
            self.lam *= 2.0
        return False, 0.0

    # -- schedule --------------------------------------------------------------

    def refresh(self):
        """Occlusion renders, frozen visibility and (with variable residuals)
        the variable descriptors for the current state."""
        with self._stage("occlusion"):
            occl = self._occlusion_depths()
        with self._stage("visibility"):
            self._frozen_vis = self._visibility(occl)
            del occl
            self.observations = int(sum(int(m.sum()) for per_level in self._frozen_vis
                                        for per_batch in per_level for (m, _) in per_batch))
        if self.variable_weight > 0:
            with self._stage("variable_descriptors"):
                self._var_desc = self._compute_variable_descriptors(self._frozen_vis)

    def run_on_current_scale(self, max_iterations: int = 100,
                             max_change_threshold: float = 1e-6,
                             iterations_without_new_optimum_threshold: int = 15,
                             print_progress: bool = False,
                             iteration_costs: Optional[List[float]] = None,
                             observations: Optional[List[int]] = None) -> OptimizerReport:
        """LM iterations at ``current_scale`` (never the coarsest scale):
        refresh -> [accumulate(H,b,cost) -> track optimum -> ladder ->
        refresh]* -> final-state cost -> restore the optimum.
        ``iteration_costs`` / ``observations``, if given, receive each
        iteration's entry cost and visible (image, point) pairs."""
        self.current_scale = max(0, min(self.current_scale, self.p.scale_count - 2))
        self.lam = 64.0
        optimum_cost = math.inf
        optimum_state = None
        without_new = 0
        converged = False
        it = 0

        def snapshot():
            return [(g.camera.params, g.poses) for g in self.p.groups]

        self.refresh()
        state_dirty = False
        max_change = math.inf
        for it in range(max_iterations):
            with self._stage("hb_accumulate"):
                H, bb, cost, offsets = self._lm_accumulate(self._frozen_vis)
            state_dirty = False
            if iteration_costs is not None:
                iteration_costs.append(cost)
            if observations is not None:
                observations.append(self.observations)
            if print_progress:
                print(f"  scale {self.current_scale} iter {it}: cost {cost:.6f}"
                      f" lam {self.lam:.3g} max_change {max_change:.3g}"
                      f" observations {self.observations}")
            if cost < optimum_cost:
                optimum_cost = cost
                optimum_state = snapshot()
                without_new = 0
            else:
                without_new += 1
            if without_new >= iterations_without_new_optimum_threshold:
                converged = True
                break
            with self._stage("lm_ladder"):
                applied, max_change = self._lm_solve_apply(H, bb, cost, offsets,
                                                           self._frozen_vis)
            state_dirty = applied
            self.refresh()
            if (not applied) or max_change < max_change_threshold:
                converged = True
                break
        if state_dirty:
            # the final applied state has not been cost-evaluated yet
            with self._stage("final_cost"):
                cost = self._total_cost([g.camera.params for g in self.p.groups],
                                        [g.poses for g in self.p.groups], self._frozen_vis)
            if print_progress:
                print(f"  scale {self.current_scale} final: cost {cost:.6f}")
            if cost < optimum_cost:
                optimum_cost = cost
                optimum_state = snapshot()
        if optimum_state is not None:
            for g, (prm, poses) in zip(self.p.groups, optimum_state):
                g.camera = g.camera.with_params(prm)
                g.poses = poses
        return OptimizerReport(it + 1, optimum_cost, converged)

    def next_scale(self) -> bool:
        if self.current_scale == 0:
            return False
        self.current_scale -= 1
        return True
