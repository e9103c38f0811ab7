"""Photometric joint pose + intrinsics Gauss-Newton/LM optimizer.

Port of ``dataset_pipeline_tpu/photometric/optimizer.py``: one or more
camera groups, fixed and variable descriptor residuals, inverse-depth
residuals against fixed depth maps, camera rigs, splat or mesh occlusion, and
the observations cache (per-image compacted views of the point levels).

- **Visibility**: project every point of every level into every image; z-test
  against the splat occlusion depth with slack; the continuous observation
  scale ``log2(2 * radius_px)`` must lie in [current_scale, scale_count-1);
  border, mask and oversaturation checks at the coarser interpolation scale.
- **Residuals**: a point contributes iff its center and all K neighbors are
  observed; component k is (I(neighbor_k) - I(center)) - descriptor_k,
  Huber-weighted on the component-vector norm.
- **Jacobians**: one trilinear sample with analytic derivatives per
  observation (``ops/pyramid_sample.py``, the CUDA kernel on the card) chained
  with forward-mode derivatives of the gather-free projection and
  footprint-scale math (``ops/hb_geometry.py``: ``_hb_batch``'s in a CUDA
  kernel on the card, ``torch.func.jvp`` over the variables otherwise); the
  residuals and Gram products in ``ops/hb_gram.py`` (a CUDA kernel on the
  card). Each op chooses between its kernel and its plain version; the
  functions here are the per-chunk skeletons and the LM loop.
- **LM**: H diagonal *= (1+lambda), accept if the cost decreases with frozen
  visibility, lambda halve/double, 10 tries, force-apply the last try.
  Variables: the intrinsics blocks first, then 6 dof per rig camera other
  than the reference, then 6 dof per image of a group that is not
  rig-dependent (a dependent image's pose is extrinsics . reference pose).

The JAX ``vmap`` over an image chunk becomes an explicit leading image
dimension (``nb``). Each chunk's flat pyramids (images, and depth maps when
given) are built once, when its :class:`ImageBatch` is made. With the
observations cache a chunk's geometry is per image (``(nb, M, ...)``, the
views stacked): the JAX package groups images by view size so that a vmapped
chunk has one shape; here a chunk keeps its images and pads its views to the
largest (padding rows are never visible, so every sum is the same). The small
solve runs on the host in float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3
# the ops' dispatchers (project, jacobian, gram_assemble) are looked up on their modules at
# call time, so that a caller may wrap them; their helpers are imported by name
from dataset_pipeline_tpu_torch.ops import hb_geometry, hb_gram
from dataset_pipeline_tpu_torch.ops.hb_geometry import (
    batch_pose,
    footprint_scale,
    forward_jacobian,
    geom_fn,
    intensity_chain,
    project_full,
    tangent_basis,
)
from dataset_pipeline_tpu_torch.ops.hb_gram import (
    descriptor_residuals,
    gram,
    huber_terms,
    inverse_depths,
)
from dataset_pipeline_tpu_torch.ops.pyramid_sample import (
    PyramidLayout,
    flatten_pyramid,
    pair_rows,
    pyramid_sample,
)
from dataset_pipeline_tpu_torch.ops.mesh_raster import render_occlusion_mesh_depth_batch
from dataset_pipeline_tpu_torch.ops.robust import (
    DEFAULT_DEPTH_TUKEY,
    tukey_rho,
    tukey_weight,
)
from dataset_pipeline_tpu_torch.ops.splat import render_splats_depth
from dataset_pipeline_tpu_torch.photometric.obs_cache import ObservationsCache
from dataset_pipeline_tpu_torch.photometric.problem import PhotoProblem
from dataset_pipeline_tpu_torch.utils.timing import count, span, stage, within_stage


def _exp2(k):
    """2^k for integer-valued float ``k``, exact (``pow`` of 2)."""
    return torch.pow(2.0, k)


# ---------------------------------------------------------------------------
# Visibility: observation masks and frozen observation scales
# ---------------------------------------------------------------------------


def _visibility_core(camera: cm.Camera, pose_q, pose_t, points, radius, occl_depth,
                     current_scale, scale_count: int, width: int, height: int,
                     depth_slack=0.01, min_depth=0.05):
    """(visible (nb,M), obs_scale (nb,M), pix (nb,M,2)) of points (M,3) in a
    chunk of images with poses (nb,4)/(nb,3) and full-res occlusion depths
    (nb,H,W)."""
    p_cam = batch_pose(pose_q, pose_t).apply(points)
    pix, valid = cm.project(camera, p_cam)
    z = p_cam[..., 2]

    # occlusion z-test with slack (float bounds before the int cast)
    ix = torch.clamp(torch.round(pix[..., 0]).nan_to_num(0.0), 0, width - 1).long()
    iy = torch.clamp(torch.round(pix[..., 1]).nan_to_num(0.0), 0, height - 1).long()
    occ = torch.gather(occl_depth.reshape(occl_depth.shape[0], -1), 1, iy * width + ix)
    valid = valid & (z <= occ + depth_slack) & (z > min_depth)

    obs_scale = footprint_scale(camera, p_cam, pix, radius)
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
    return valid, obs_scale, pix


def _mask_filter_core(pix, obs_scale, valid, flat, layout: PyramidLayout, mask_flat,
                      max_valid_intensity):
    """Reject observations whose pixel at the coarser interpolation level is
    masked or oversaturated: one flat-pyramid lookup per observation at its
    full-res ``pix`` (``_visibility_core``'s). ``mask_flat`` is None (no
    masks) or the (nb, total) uint8 mask pyramid."""
    L = layout.levels
    if L <= 1:
        return valid
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


def _point_intensities(camera, params, pose_q, pose_t, points, flat, layout, obs_scale,
                       pairs=None):
    """(intensity, valid) (nb,M) of every point under the given state.
    ``pairs``: the row-paired copy of ``flat`` that the sampling kernel reads
    on the card (``ImageBatch.pairs``)."""
    p_cam = batch_pose(pose_q, pose_t).apply(points)
    pix, valid = project_full(camera, params, p_cam)
    val, ok = pyramid_sample(flat, layout, pix.contiguous(), obs_scale.contiguous(),
                             with_derivs=False, pairs=pairs)
    return val, valid & ok


def _cost_batch(camera, params, pose_q, pose_t, points, neighbors, desc, flat, layout,
                obs_scale, contrib, pairs=None):
    """Summed (cost, count) of a chunk of images on one level (tensors)."""
    inten, ok = _point_intensities(camera, params, pose_q, pose_t, points, flat, layout,
                                   obs_scale, pairs)
    r, all_ok = descriptor_residuals(inten, ok, neighbors, desc, contrib)
    _, rho = huber_terms(r)
    cost = torch.sum(torch.where(all_ok, rho, torch.zeros_like(rho)), 1)
    return torch.sum(cost), torch.sum(all_ok)


def _imgdesc_batch(camera, params, pose_q, pose_t, points, neighbors, flat, layout,
                   obs_scale, contrib, pairs=None):
    """A chunk's contribution to the variable-descriptor mean: image-space
    descriptors of fully observed points. Shared geometry: summed over the
    chunk's images (desc_sum (M,K), count (M,) int32); per-image geometry
    (the cache's views): per image (nb,M,K) and (nb,M) bool, for the caller
    to scatter into the level."""
    inten, ok = _point_intensities(camera, params, pose_q, pose_t, points, flat, layout,
                                   obs_scale, pairs)
    d, all_ok = descriptor_residuals(inten, ok, neighbors, None, contrib)
    if points.dim() == 3:
        return d, all_ok
    return torch.sum(d, 0), torch.sum(all_ok.to(torch.int32), 0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# H, b
# ---------------------------------------------------------------------------


def _hb_spans(timings, device):
    """The child spans of ``hb_accumulate`` in the ``_hb_*`` functions:
    geometry (host seconds too), B3's sample, residuals and Gram products
    (host seconds too). No-ops with ``timings=None``."""
    return (lambda: span(timings, "hb_accumulate.geometry", device, host=True),
            lambda: span(timings, "hb_accumulate.sample", device),
            lambda: span(timings, "hb_accumulate.gram", device, host=True))


def _hb_batch(camera, params, pose_q, pose_t, points, neighbors, desc, flat, layout,
              obs_scale, contrib, radius, optimize_intrinsics: bool, dynamic_scale: bool,
              pairs=None, *, timings=None):
    """Per-image H (nb,V,V), b (nb,V) and the chunk's summed cost/count on
    one level. Variable layout of a block: [P intrinsics | 6 pose].

    One sample with analytic derivatives per observation (dI/dpix, dI/dscale)
    chained with forward-mode Jacobians of the gather-free projection and
    footprint math (``ops/hb_geometry.py``), then the residuals and Gram
    products (``ops/hb_gram.py``); each op chooses its kernel or its plain
    version itself. ``timings``, if given, collects the child spans of
    ``hb_accumulate`` and counts ``hb_accumulate.geometry_kernel_rows`` and
    ``.gram_kernel_rows``, the rows whose geometry or Gram products the
    kernels computed."""
    geometry, sample, gram_span = _hb_spans(timings, points.device)
    with geometry():
        pix, valid = hb_geometry.project(camera, params, pose_q, pose_t, points)
    with sample():
        inten, dpx, dpy, dvds, okS = pyramid_sample(flat, layout, pix.contiguous(),
                                                    obs_scale.contiguous(), with_derivs=True,
                                                    pairs=pairs)
    with geometry():
        J = hb_geometry.jacobian(camera, params, pose_q, pose_t, points, radius, dpx, dpy, dvds,
                                 optimize_intrinsics, dynamic_scale)  # (nb, M, V)
    if hb_geometry.uses_kernel(camera, points):
        count(timings, "hb_accumulate.geometry_kernel_rows", pix.shape[0] * pix.shape[1])
    return _gram_counted(J, inten, valid & okS, neighbors, desc, contrib, gram_span, timings)


def _gram_counted(J, inten, ok, neighbors, desc, contrib, gram_span, timings):
    """``hb_gram.gram_assemble`` inside the ``gram`` span, counting
    ``hb_accumulate.gram_kernel_rows`` (nb x M) where the kernel takes J."""
    if hb_gram.uses_kernel(J):
        count(timings, "hb_accumulate.gram_kernel_rows", J.shape[0] * J.shape[1])
    with gram_span():
        return hb_gram.gram_assemble(J, inten, ok, neighbors, desc, contrib)


def _hb_rig_batch(camera, params, extr_q, extr_t, ref_q, ref_t, points, neighbors, desc, flat,
                  layout, obs_scale, contrib, radius, optimize_intrinsics: bool,
                  dynamic_scale: bool, pairs=None, *, timings=None):
    """A chunk of rig-dependent images: pose = image_T_rig . reference pose,
    the extrinsics (4,)/(3,) shared, the reference poses (nb,4)/(nb,3) per
    image. Per-image H, b over [P intrinsics | 6 extrinsics | 6 reference
    pose], and the summed cost/count; ``timings`` as in ``_hb_batch``."""
    geometry, sample, gram_span = _hb_spans(timings, points.device)
    with geometry():
        extr0 = SE3(extr_q, extr_t)
        ref0 = batch_pose(ref_q, ref_t)
        geom = geom_fn(camera, points, radius, dynamic_scale,
                       lambda eps_e, eps_r: SE3.exp(eps_e).compose(extr0).compose(
                           SE3.exp(eps_r).compose(ref0)))
        z6 = torch.zeros(6, dtype=torch.float32, device=points.device)
        pix, _ = geom(z6, z6, params)
        pose0 = SE3.exp(z6).compose(extr0).compose(SE3.exp(z6).compose(ref0))
        _, valid = project_full(camera, params, pose0.apply(points))
    with sample():
        inten, dpx, dpy, dvds, okS = pyramid_sample(flat, layout, pix.contiguous(),
                                                    obs_scale.contiguous(), with_derivs=True,
                                                    pairs=pairs)
    with geometry():
        P = params.shape[0]
        J = forward_jacobian(geom, (z6, z6, params), lambda t: (t[P:P + 6], t[P + 6:], t[:P]),
                             tangent_basis(P, 12, optimize_intrinsics, z6.device),
                             intensity_chain(dpx, dpy, dvds, dynamic_scale),
                             pix.shape[0] * pix.shape[1])
    return _gram_counted(J, inten, valid & okS, neighbors, desc, contrib, gram_span, timings)


def _hb_depth_batch(camera, params, pose_q, pose_t, points, flat, layout, obs_scale, contrib,
                    optimize_intrinsics: bool, pairs=None, *, timings=None):
    """H, b for inverse-depth residuals r = 1/D(pix) - 1/z against a fixed
    depth-map pyramid (``flat``: the chunk's depth maps, ``pairs`` their
    row-paired copy on the card), Tukey-weighted. Per-image H (nb,V,V), b
    (nb,V) over [P intrinsics | 6 pose], and the summed cost/count;
    ``timings`` as in ``_hb_batch``."""
    geometry, sample, gram_span = _hb_spans(timings, points.device)
    pose0 = batch_pose(pose_q, pose_t)

    def geom(eps, prm):
        p_cam = SE3.exp(eps).compose(pose0).apply(points)
        pix, _ = cm.project(camera.with_params(prm), p_cam)
        return pix, p_cam[..., 2]

    with geometry():
        eps0 = torch.zeros(6, dtype=torch.float32, device=points.device)
        pix, z = geom(eps0, params)
        _, valid = cm.project(camera.with_params(params), pose0.apply(points))
    with sample():
        D, dDx, dDy, _, okD = pyramid_sample(flat, layout, pix.contiguous(),
                                             obs_scale.contiguous(), with_derivs=True, pairs=pairs)
    with gram_span():
        inv_D, inv_z, safe_z = inverse_depths(D, z)
        r0 = inv_D - inv_z
        rho = tukey_rho(r0, DEFAULT_DEPTH_TUKEY)
        w = tukey_weight(r0, DEFAULT_DEPTH_TUKEY)
        ok = valid & okD & (D > 0) & contrib
        wfull = torch.where(ok, w, torch.zeros_like(w))

        # dr/dstate = -(1/D^2) dD/dpix . dpix/dstate + (1/z^2) dz/dstate
        dD_coef = -torch.where(D > 0, 1.0 / torch.clamp(D * D, min=1e-18), torch.zeros_like(D))
        dz_coef = torch.where(z != 0, 1.0 / (safe_z * safe_z), torch.zeros_like(z))

    def combine(dout):
        dpix, dz = dout
        return dD_coef * (dDx * dpix[..., 0] + dDy * dpix[..., 1]) + dz_coef * dz

    with geometry():
        P = params.shape[0]
        rows = forward_jacobian(geom, (eps0, params), lambda t: (t[P:], t[:P]),
                                tangent_basis(P, 6, optimize_intrinsics, eps0.device), combine,
                                pix.shape[0] * pix.shape[1])
    with gram_span():
        # invalid points carry zero weight but may hold non-finite J entries
        rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
        sw = torch.sqrt(wfull)
        rows_w = rows * sw[..., None]
        r_w = torch.where(ok, r0, torch.zeros_like(r0)) * sw
        H = gram(rows_w, rows_w)
        b = gram(rows_w, r_w[..., None])[..., 0]
        cost = torch.sum(torch.where(ok, rho, torch.zeros_like(rho)))
        return H, b, cost, torch.sum(ok)


def _cost_depth_batch(camera, params, pose_q, pose_t, points, flat, layout, obs_scale, contrib,
                      pairs=None):
    """Summed Tukey (cost, count) of the inverse-depth residuals of a chunk."""
    p_cam = batch_pose(pose_q, pose_t).apply(points)
    z = p_cam[..., 2]
    pix, valid = cm.project(camera.with_params(params), p_cam)
    D, okD = pyramid_sample(flat, layout, pix.contiguous(), obs_scale.contiguous(),
                            with_derivs=False, pairs=pairs)
    ok = valid & okD & (D > 0) & contrib
    inv_D, inv_z, _ = inverse_depths(D, z)
    rho = tukey_rho(inv_D - inv_z, DEFAULT_DEPTH_TUKEY)
    return torch.sum(torch.where(ok, rho, torch.zeros_like(rho))), torch.sum(ok)


def _point_costs(camera, params, pose_q, pose_t, points, neighbors, desc, flat, layout,
                 obs_scale, contrib, pairs=None):
    """Per-point robust cost rho (nb,M) and validity: the data behind the
    cost display modes (rho of a point that is not valid is that of a zero
    residual)."""
    inten, ok = _point_intensities(camera, params, pose_q, pose_t, points, flat, layout,
                                   obs_scale, pairs)
    r, all_ok = descriptor_residuals(inten, ok, neighbors, desc, contrib)
    return huber_terms(r)[1], all_ok

# ---------------------------------------------------------------------------
# Per-chunk passes over every level (the JAX package fuses these into one
# relay dispatch; here they are plain loops with the same results)
# ---------------------------------------------------------------------------


def _visibility_mask_levels(camera, pose_q, pose_t, occl, level_args, current_scale,
                            scale_count: int, width: int, height: int, depth_slack,
                            min_depth, max_valid_intensity, flat, layout, mask_flat):
    """All levels' visibility + mask filter for one image chunk.
    ``level_args``: per level (points, radius, core): ``core`` (nb,M) marks a
    view's candidate rows, None for a shared level. Returns per level (mask,
    obs_scale)."""
    outs = []
    for points, radius, core in level_args:
        m, sc, pix = _visibility_core(camera, pose_q, pose_t, points, radius, occl,
                                      current_scale, scale_count, width, height,
                                      depth_slack, min_depth)
        if core is not None:
            m = m & core
        m = _mask_filter_core(pix, sc, m, flat, layout, mask_flat, max_valid_intensity)
        outs.append((m, sc))
    return tuple(outs)


def _chunk_indices(n: int, chunk: int):
    """Split range(n) into chunks of at most ``chunk`` image indices. (The
    JAX package pads the last chunk to a power of two to bound its compiled
    shapes; nothing is compiled per shape here, so the remainder stays as is.)"""
    return [np.arange(start, min(start + chunk, n)) for start in range(0, n, chunk)]


@dataclass
class LevelViews:
    """One chunk's observations-cache views of one point level, stacked
    (nb, M, ...) and padded to the chunk's largest view."""

    points: torch.Tensor  # (nb,M,3)
    neighbors: torch.Tensor  # (nb,M,K) indices into the image's view
    fixed_desc: torch.Tensor  # (nb,M,K)
    core: torch.Tensor  # (nb,M) candidate rows
    gather_idx: torch.Tensor  # (nb,M) view -> level index
    scatter_idx: torch.Tensor  # (nb,M) padded with N


def _stack_views(views, n: int) -> LevelViews:
    """Stack per-image views of an ``n``-point level, padding each to the
    largest with rows that no image can see (behind the camera, not core,
    their own neighbours, scattered to ``n``)."""
    M = max(v.size for v in views)
    parts = {k: [] for k in ("points", "neighbors", "fixed_desc", "core", "gather_idx",
                             "scatter_idx")}
    for v in views:
        pad = M - v.size
        dev = v.points.device
        parts["points"].append(torch.cat([v.points, torch.tensor(
            [[0.0, 0.0, -1.0]], dtype=v.points.dtype, device=dev).expand(pad, 3)]))
        parts["neighbors"].append(torch.cat([v.neighbors, torch.arange(
            v.size, M, device=dev)[:, None].expand(pad, v.neighbors.shape[1])]))
        parts["fixed_desc"].append(torch.cat([v.fixed_descriptors, v.fixed_descriptors.new_zeros(
            (pad, v.fixed_descriptors.shape[1]))]))
        parts["core"].append(torch.cat([v.core, v.core.new_zeros(pad)]))
        parts["gather_idx"].append(torch.cat([v.gather_idx, v.gather_idx.new_zeros(pad)]))
        parts["scatter_idx"].append(torch.cat([v.scatter_idx, v.scatter_idx.new_full((pad,), n)]))
    return LevelViews(**{k: torch.stack(p) for k, p in parts.items()})


@dataclass
class ImageBatch:
    """One image chunk of one group: indices and the chunk's flat pyramid,
    built once (the level geometry is shared by every image), on the card
    the row-paired copy that the sampling kernel reads, the depth maps'
    pyramid when the problem has them, and with the observations cache the
    chunk's views of every level."""

    idx: np.ndarray  # (nb,) image indices within the group
    idx_dev: torch.Tensor  # (nb,) device copy of ``idx``
    flat: torch.Tensor  # (nb, total) float32 pyramid
    layout: PyramidLayout
    mask_flat: Optional[torch.Tensor] = None  # (nb, total) uint8 or None
    pairs: Optional[torch.Tensor] = None  # (nb, layout.pair_total) float32 on CUDA, else None
    depth_flat: Optional[torch.Tensor] = None  # (nb, total) depth maps or None
    depth_pairs: Optional[torch.Tensor] = None
    views: Optional[List[LevelViews]] = None  # per level, with the observations cache

    @property
    def nb(self) -> int:
        return len(self.idx)

    def geometry(self, l: int, level):
        """(points, neighbors, fixed descriptors, core or None) of level ``l``:
        the stacked views with the observations cache, the level's otherwise."""
        if self.views is None:
            return level.points, level.neighbors, level.fixed_descriptors, None
        v = self.views[l]
        return v.points, v.neighbors, v.fixed_desc, v.core


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

    Variable layout: one intrinsics block per group first, then 6 dofs per
    rig camera other than each rig's reference, then 6 pose dofs per image
    of the groups that are not rig-dependent, ordered by group then image.
    ``timings``, if given, collects per-stage seconds (the card is
    synchronized around each stage). ``mesh`` (``parallel/mesh.py``) shards
    each chunk's H,b accumulation over its ranks; without one, a one-rank
    mesh on the problem's device takes every chunk whole.
    """

    def __init__(self, problem: PhotoProblem, optimize_intrinsics: bool = True,
                 max_radius_px: int = 3, fixed_weight: float = 1.0,
                 variable_weight: float = 0.0, depth_weight: float = 0.0,
                 image_chunk: int = 8, scale_jacobian: bool = True,
                 timings: Optional[dict] = None, mesh=None):
        self.p = problem
        self.optimize_intrinsics = optimize_intrinsics
        self.max_radius_px = max_radius_px
        self.fixed_weight = fixed_weight
        self.variable_weight = variable_weight
        self.depth_weight = depth_weight
        self.scale_jacobian = scale_jacobian
        self.timings = timings
        self.device = problem.occlusion_points.device
        # each chunk's H,b accumulation is sharded over its image axis
        # (parallel/photometric.py; without a mesh, a one-rank mesh on the
        # problem's device), so the chunk is rounded up to a multiple of the
        # mesh size; visibility, costs and the solve stay replicated, and
        # rank 0 alone writes files
        from dataset_pipeline_tpu_torch.parallel.mesh import as_mesh
        from dataset_pipeline_tpu_torch.parallel.photometric import ShardedPhotometricKernels

        self._kernels = ShardedPhotometricKernels(as_mesh(self.device if mesh is None else mesh))
        nd = self._kernels.mesh.size
        self.image_chunk = max(nd, -(-image_chunk // nd) * nd)
        self._writes = self._kernels.mesh.rank == 0
        self.current_scale = problem.scale_count - 1
        self.lam = 64.0
        self._var_desc = None
        self._frozen_vis = None
        self.observations = 0  # visible (image, point) pairs of the last refresh
        self.obs_cache: Optional[ObservationsCache] = None
        # drift guard of the observations cache (see ``obs_cache_hit_rate``)
        self.obs_cache_min_hit_rate = 0.98
        self.obs_cache_check_interval = 10
        self.obs_cache_hit_log: List[float] = []
        self._obs_cache_save_path = None
        self._sync_dependent_poses()
        self._build_batches()

    def _stage(self, name: str):
        return stage(self.timings, name, self.device)

    # -- image chunking --------------------------------------------------------

    def _build_batches(self):
        """Per group, the image chunks with their flat pyramids (and on the
        card their row-paired copies; the plain sampler reads ``flat``)."""
        self._batches = []
        self._batch_row = []
        depth = self.p.depth_map_pyramids
        for gi, g in enumerate(self.p.groups):
            batches, rowmap = [], {}
            for idx in _chunk_indices(g.num_images, self.image_chunk):
                idx_dev = torch.as_tensor(idx, dtype=torch.long, device=self.device)
                flat, layout = flatten_pyramid([g.pyramid[s][idx_dev]
                                                for s in range(g.level_count)])
                mask_flat = None
                if g.mask_pyramid:
                    mask_flat, _ = flatten_pyramid([m[idx_dev] for m in g.mask_pyramid])
                b = ImageBatch(idx, idx_dev, flat, layout, mask_flat,
                               pair_rows(flat, layout) if flat.is_cuda else None)
                if depth is not None:
                    b.depth_flat, _ = flatten_pyramid([depth[gi][s][idx_dev]
                                                       for s in range(g.level_count)])
                    b.depth_pairs = pair_rows(b.depth_flat, layout) if flat.is_cuda else None
                for j, i in enumerate(idx):
                    rowmap[int(i)] = (len(batches), j)
                batches.append(b)
            self._batches.append(batches)
            self._batch_row.append(rowmap)
        self._attach_views()

    def _attach_views(self):
        """Give every chunk its stacked views of each level (or none without
        the observations cache)."""
        for gi, batches in enumerate(self._batches):
            for b in batches:
                b.views = None if self.obs_cache is None else [
                    _stack_views([self.obs_cache.view(gi, int(i), l) for i in b.idx],
                                 int(level.points.shape[0]))
                    for l, level in enumerate(self.p.levels)]

    # -- observations cache ----------------------------------------------------

    def _candidate_masks(self, occl):
        """Per (group, level, image chunk): the loosest gate's visibility on
        the full level (``current_scale`` 0, doubled occlusion slack, no mask
        filter), (nb, N) bool on the host, with the chunk's image indices."""
        for gi, g in enumerate(self.p.groups):
            cam = g.camera
            for l, level in enumerate(self.p.levels):
                for idx in _chunk_indices(g.num_images, self.image_chunk):
                    idxd = torch.as_tensor(idx, dtype=torch.long, device=self.device)
                    m, _, _ = _visibility_core(cam, g.poses.q[idxd], g.poses.t[idxd], level.points,
                                            level.radius, occl[gi][idxd], 0.0, g.level_count,
                                            cam.width, cam.height,
                                            2.0 * self.p.occlusion_depth_threshold, 0.05)
                    yield gi, l, idx, m.cpu().numpy()

    def build_observations_cache(self, save_path: str = None, load_path: str = None):
        """Compute (or load) per-image candidate views and use them for all
        later iterations (enabled after the first scale by the registrator).
        The candidates come from the loosest gate of the schedule, so they
        are a superset of later observations up to pose drift."""
        if load_path is not None:
            cache = ObservationsCache.load(load_path, self.p.levels)
            if cache is not None:
                # a drift-triggered rebuild overwrites the stale file
                self._obs_cache_save_path = save_path or load_path
                self.obs_cache = cache
                self._frozen_vis = None
                self._attach_views()
                return cache
        self._obs_cache_save_path = save_path
        cache = ObservationsCache()
        for gi, l, idx, m in self._candidate_masks(self._occlusion_depths()):
            for j, b in enumerate(idx):
                cache.set_candidates(gi, int(b), l, self.p.levels[l], m[j])
        self.obs_cache = cache
        self._frozen_vis = None
        self._attach_views()
        if save_path is not None and self._writes:
            cache.save(save_path, self.p.levels)
        return cache

    def obs_cache_hit_rate(self) -> float:
        """Core hit rate of the observations cache: the fraction of points
        that pass a fresh full-level visibility test (the loose gate the cache
        was built with) and are still among the cached candidates. The
        schedule logs it every ``obs_cache_check_interval`` iterations and
        rebuilds the cache below ``obs_cache_min_hit_rate``."""
        if self.obs_cache is None:
            return 1.0
        hit = tot = 0
        for gi, l, idx, m in self._candidate_masks(self._occlusion_depths()):
            for j, b in enumerate(idx):
                cand = self.obs_cache.candidates(gi, int(b), l)
                if cand is None:
                    continue
                tot += int(m[j].sum())
                hit += int((m[j] & cand).sum())
        return hit / tot if tot else 1.0

    def _check_obs_cache_drift(self, print_progress: bool = False) -> None:
        """Log the hit rate; rebuild the cache if pose drift invalidated it."""
        rate = self.obs_cache_hit_rate()
        self.obs_cache_hit_log.append(rate)
        if print_progress:
            print(f"  obs-cache core hit rate: {rate:.4f}")
        if rate < self.obs_cache_min_hit_rate:
            if print_progress:
                print(f"  obs-cache hit rate {rate:.4f} < {self.obs_cache_min_hit_rate}"
                      " - rebuilding cache")
            self.build_observations_cache(save_path=self._obs_cache_save_path)

    def _view(self, gi: int, b: int, l: int):
        return None if self.obs_cache is None else self.obs_cache.view(gi, b, l)

    def _geom(self, gi: int, b: int, l: int):
        """(points, neighbors, fixed_descriptors) of image ``b``: the compacted
        view's with the observations cache, the full level's otherwise."""
        view = self._view(gi, b, l)
        if view is None:
            level = self.p.levels[l]
            return level.points, level.neighbors, level.fixed_descriptors
        return view.points, view.neighbors, view.fixed_descriptors

    # -- variable indexing and rigs -------------------------------------------

    def _var_layout(self):
        """[intrinsics blocks][per rig (ncams-1)*6 extrinsics][6 per image of
        a group that is not rig-dependent]: (offsets_int, offsets_rig,
        offsets_pose, V); a dependent group's pose offset is None."""
        offsets_int = []
        off = 0
        if self.optimize_intrinsics:
            for g in self.p.groups:
                offsets_int.append(off)
                off += int(g.camera.params.shape[0])
        else:
            offsets_int = [None] * len(self.p.groups)
        offsets_rig = []
        for extr in self.p.rig_extrinsics:
            offsets_rig.append(off)
            off += 6 * (int(extr.q.shape[0]) - 1)
        offsets_pose = []
        for g in self.p.groups:
            if g.rig_cam_index > 0:
                offsets_pose.append(None)
            else:
                offsets_pose.append(off)
                off += 6 * g.num_images
        return offsets_int, offsets_rig, offsets_pose, off

    def _dependent_poses(self, g, extrinsics, ref_poses: SE3) -> SE3:
        """A rig-dependent group's poses: its camera's extrinsics composed
        with the reference images' poses."""
        extr = extrinsics[g.rig_id]
        slots = torch.as_tensor(np.asarray(g.ref_slots, np.int64), device=self.device)
        return SE3(extr.q[g.rig_cam_index], extr.t[g.rig_cam_index]).compose(
            SE3(ref_poses.q[slots], ref_poses.t[slots]))

    def _sync_dependent_poses(self):
        """Derive the dependent groups' poses from extrinsics + reference poses."""
        for g in self.p.groups:
            if g.rig_cam_index > 0:
                g.poses = self._dependent_poses(g, self.p.rig_extrinsics,
                                                self.p.groups[g.ref_group].poses)

    # -- occlusion ----------------------------------------------------------

    def _occlusion_depths(self):
        """Occlusion depth per group, (B,H,W) at full resolution,
        ``image_chunk`` images per render: the occlusion mesh (with boundary
        masking) when the problem has one, else the point splats, centred
        through the camera's lens (``render_splats_depth``). Inside a stage,
        ``timings`` gets the span ``occlusion_depths.project`` and the count
        ``occlusion_depths.distorted_points`` of a camera with a lens."""
        timings = within_stage(self.timings)
        out = []
        radii = torch.full((self.p.occlusion_points.shape[0],), self.p.occlusion_radius,
                           dtype=torch.float32, device=self.device)
        for gi, g in enumerate(self.p.groups):
            cam = g.camera
            chunks = []
            for b in self._batches[gi]:
                q, t = g.poses.q[b.idx_dev], g.poses.t[b.idx_dev]
                if self.p.occlusion_mesh is not None:
                    chunks.append(render_occlusion_mesh_depth_batch(
                        cam, q, t, self.p.occlusion_mesh, splat_radius=self.p.occlusion_radius))
                    continue
                p_cam = batch_pose(q, t).apply(self.p.occlusion_points)
                chunks.append(render_splats_depth(p_cam, radii, cam,
                                                  max_radius_px=self.max_radius_px,
                                                  timings=timings))
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
            for b in self._batches[gi]:
                level_args = []
                for l, lv in enumerate(self.p.levels):
                    points, _, _, core = b.geometry(l, lv)
                    level_args.append((points, lv.radius, core))
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
            desc_sum = torch.zeros((n + 1, k), dtype=torch.float32, device=self.device)
            count = torch.zeros((n + 1,), dtype=torch.int32, device=self.device)
            for gi, g in enumerate(self.p.groups):
                for bi, b in enumerate(self._batches[gi]):
                    mask, s = vis[gi][l][bi]
                    points, neighbors, _, _ = b.geometry(l, level)
                    d, ok = _imgdesc_batch(g.camera, g.camera.params, g.poses.q[b.idx_dev],
                                           g.poses.t[b.idx_dev], points, neighbors,
                                           b.flat, b.layout, s, mask, b.pairs)
                    if b.views is None:
                        desc_sum[:n] += d
                        count[:n] += ok
                    else:  # scatter the views' rows back; padding rows go to row n
                        rows = b.views[l].scatter_idx.reshape(-1)
                        desc_sum.index_add_(0, rows, d.reshape(-1, k))
                        count.index_add_(0, rows, ok.reshape(-1).to(torch.int32))
            desc = desc_sum[:n] / torch.clamp(count[:n], min=1)[:, None]
            out.append((desc, count[:n] >= 2))
        return out

    def _residual_weights(self):
        """Static weights of the active descriptor residual types, in set order."""
        weights = []
        if self.fixed_weight > 0:
            weights.append(self.fixed_weight)
        if self.variable_weight > 0 and self._var_desc is not None:
            weights.append(self.variable_weight)
        return weights

    def _residual_sets(self, level_idx: int, b: ImageBatch):
        """[(descriptors, extra mask or None, weight)] per active type, on the
        chunk's geometry (stacked views or the shared level)."""
        sets = []
        if self.fixed_weight > 0:
            sets.append((b.geometry(level_idx, self.p.levels[level_idx])[2], None,
                         self.fixed_weight))
        if self.variable_weight > 0 and self._var_desc is not None:
            desc, mask2 = self._var_desc[level_idx]
            if b.views is not None:
                gather = b.views[level_idx].gather_idx
                desc, mask2 = desc[gather], mask2[gather]
            sets.append((desc, mask2, self.variable_weight))
        return sets

    def _depth_active(self, g) -> bool:
        return (self.depth_weight > 0 and self.p.depth_map_pyramids is not None
                and g.rig_cam_index == 0)

    # -- cost -----------------------------------------------------------------

    def _total_cost(self, group_params, group_poses, vis) -> float:
        """Weighted mean cost per residual type, summed; every term is
        evaluated first and fetched in one transfer."""
        keys, terms = [], []
        for gi, g in enumerate(self.p.groups):
            for bi, b in enumerate(self._batches[gi]):
                q = group_poses[gi].q[b.idx_dev]
                t = group_poses[gi].t[b.idx_dev]
                for l, level in enumerate(self.p.levels):
                    mask, sc = vis[gi][l][bi]
                    points, neighbors, _, _ = b.geometry(l, level)
                    for ti, (desc, extra, _) in enumerate(self._residual_sets(l, b)):
                        m = mask if extra is None else (mask & extra)
                        terms.extend(_cost_batch(g.camera, group_params[gi], q, t, points,
                                                 neighbors, desc, b.flat, b.layout, sc, m,
                                                 b.pairs))
                        keys.append(ti)
                    if self._depth_active(g):
                        terms.extend(_cost_depth_batch(g.camera, group_params[gi], q, t, points,
                                                       b.depth_flat, b.layout, sc, mask,
                                                       b.depth_pairs))
                        keys.append("depth")
        fetched = (torch.stack([x.double() for x in terms]).cpu().numpy()
                   if terms else np.zeros(0))
        sums, counts = {}, {}
        for i, key in enumerate(keys):
            sums[key] = sums.get(key, 0.0) + float(fetched[2 * i])
            counts[key] = counts.get(key, 0) + int(fetched[2 * i + 1])
        weights = self._residual_weights() if self.p.levels else []
        return sum((self.depth_weight if key == "depth" else weights[key]) * sums[key]
                   / max(counts[key], 1) for key in sums)

    # -- LM step --------------------------------------------------------------

    def _candidate_state(self, x, offsets_int, offsets_rig, offsets_pose):
        """Per-group intrinsics, rig extrinsics and poses after applying the
        (inverted) update vector ``x``; dependent groups' poses follow from
        the candidate extrinsics and reference poses."""
        new_extr = []
        for ri, extr in enumerate(self.p.rig_extrinsics):
            orr = offsets_rig[ri]
            ncams = int(extr.q.shape[0])
            deltas = np.zeros((ncams, 6), np.float32)
            deltas[1:] = -x[orr:orr + 6 * (ncams - 1)].reshape(ncams - 1, 6)
            new_extr.append(SE3.exp(torch.as_tensor(deltas, device=self.device)).compose(extr))
        new_params, new_poses = [], []
        for gi, g in enumerate(self.p.groups):
            P = int(g.camera.params.shape[0])
            prm = g.camera.params
            if self.optimize_intrinsics:
                oi = offsets_int[gi]
                prm = prm - torch.as_tensor(x[oi:oi + P], dtype=torch.float32,
                                            device=self.device)
            new_params.append(prm)
            if g.rig_cam_index > 0:
                new_poses.append(None)  # derived below
                continue
            op = offsets_pose[gi]
            deltas = -x[op:op + 6 * g.num_images].reshape(g.num_images, 6)
            dT = SE3.exp(torch.as_tensor(deltas.astype(np.float32), device=self.device))
            new_poses.append(dT.compose(g.poses))
        for gi, g in enumerate(self.p.groups):
            if g.rig_cam_index > 0:
                new_poses[gi] = self._dependent_poses(g, new_extr, new_poses[g.ref_group])
        return new_params, new_extr, new_poses

    def _apply_state(self, params, extrinsics, poses):
        for gi, g in enumerate(self.p.groups):
            g.camera = g.camera.with_params(params[gi])
            g.poses = poses[gi]
        self.p.rig_extrinsics = extrinsics

    def _lm_accumulate(self, vis):
        """Every (chunk, level, type) H,b accumulation, assembled into the big
        float64 system on the host, and the weighted-mean entry cost (the
        quantity ``_total_cost`` computes, from the same passes). With
        ``timings``, the child spans of ``hb_accumulate`` and its counts:
        ``hb_accumulate.rows``, the geometry rows computed (images x points
        of every call), and ``hb_accumulate.residuals``, those that became
        residuals."""
        timings = self.timings
        offsets_int, offsets_rig, offsets_pose, V = self._var_layout()
        pend = []
        for gi, g in enumerate(self.p.groups):
            P = int(g.camera.params.shape[0])
            nint = P if self.optimize_intrinsics else 0
            dependent = g.rig_cam_index > 0
            for bi, b in enumerate(self._batches[gi]):
                q, t = g.poses.q[b.idx_dev], g.poses.t[b.idx_dev]
                batched = b.views is not None  # the geometry is stacked per image
                if dependent:
                    ref_g = self.p.groups[g.ref_group]
                    extr = self.p.rig_extrinsics[g.rig_id]
                    slots = np.asarray(g.ref_slots)[b.idx]
                    slots_dev = torch.as_tensor(slots, dtype=torch.long, device=self.device)
                for l, level in enumerate(self.p.levels):
                    mask, sc = vis[gi][l][bi]
                    points, neighbors, _, _ = b.geometry(l, level)
                    for ti, (desc, extra, w_t) in enumerate(self._residual_sets(l, b)):
                        m = mask if extra is None else (mask & extra)
                        if dependent:
                            out = self._kernels.hb_rig_batch(
                                g.camera, g.camera.params, extr.q[g.rig_cam_index],
                                extr.t[g.rig_cam_index], ref_g.poses.q[slots_dev],
                                ref_g.poses.t[slots_dev], points, neighbors, desc, b.flat,
                                b.layout, sc, m, level.radius, self.optimize_intrinsics,
                                self.scale_jacobian, b.pairs, geom_batched=batched, timings=timings)
                            meta = dict(kind="rig", slots=slots)
                        else:
                            out = self._kernels.hb_batch(
                                g.camera, g.camera.params, q, t, points, neighbors, desc, b.flat,
                                b.layout, sc, m, level.radius, self.optimize_intrinsics,
                                self.scale_jacobian, b.pairs, geom_batched=batched, timings=timings)
                            meta = dict(kind="plain")
                        meta.update(gi=gi, ti=ti, w=w_t, batch=b, nint=nint, P=P)
                        pend.append((meta, out))
                        count(timings, "hb_accumulate.rows", b.nb * points.shape[-2])
                    if self._depth_active(g):
                        out = self._kernels.hb_depth_batch(
                            g.camera, g.camera.params, q, t, points, b.depth_flat, b.layout, sc,
                            mask, self.optimize_intrinsics, b.depth_pairs, geom_batched=batched,
                            timings=timings)
                        pend.append((dict(kind="plain", gi=gi, ti="depth", w=self.depth_weight,
                                          batch=b, nint=nint, P=P), out))
                        count(timings, "hb_accumulate.rows", b.nb * points.shape[-2])

        with span(timings, "hb_accumulate.assemble", self.device):
            return self._assemble(pend, offsets_int, offsets_rig, offsets_pose, V)

    def _assemble(self, pend, offsets_int, offsets_rig, offsets_pose, V):
        """The big float64 system and the entry cost from the pending
        accumulations of ``_lm_accumulate``: one transfer, then numpy."""
        H = np.zeros((V, V), np.float64)
        bb = np.zeros(V, np.float64)
        flat = torch.cat([torch.cat([Hc.reshape(-1).double(), bc.reshape(-1).double(),
                                     c.double()[None], n.double()[None]])
                          for _, (Hc, bc, c, n) in pend]).cpu().numpy() if pend else None
        sums = {}
        pos = 0
        for meta, (Hc_t, bc_t, _, _) in pend:
            nh, nbv = Hc_t.numel(), bc_t.numel()
            Hc = flat[pos:pos + nh].reshape(Hc_t.shape)
            bc = flat[pos + nh:pos + nh + nbv].reshape(bc_t.shape)
            c, n = flat[pos + nh + nbv], flat[pos + nh + nbv + 1]
            pos += nh + nbv + 2
            gi, b = meta["gi"], meta["batch"]
            g = self.p.groups[gi]
            nint, P, w_t = meta["nint"], meta["P"], meta["w"]
            oi = offsets_int[gi]
            for j in range(b.nb):
                slices = []
                if nint:
                    slices.append((slice(oi, oi + P), 0, P))
                if meta["kind"] == "rig":
                    oe = offsets_rig[g.rig_id] + 6 * (g.rig_cam_index - 1)
                    orf = offsets_pose[g.ref_group] + 6 * int(meta["slots"][j])
                    slices.append((slice(oe, oe + 6), nint, 6))
                    slices.append((slice(orf, orf + 6), nint + 6, 6))
                else:
                    op = offsets_pose[gi] + 6 * int(b.idx[j])
                    slices.append((slice(op, op + 6), nint, 6))
                for (sa, a0, la) in slices:
                    bb[sa] += w_t * bc[j][a0:a0 + la]
                    for (sb, b0, lb) in slices:
                        H[sa, sb] += w_t * Hc[j][a0:a0 + la, b0:b0 + lb]
            s_, n_ = sums.get(meta["ti"], (0.0, 0))
            sums[meta["ti"]] = (s_ + float(c), n_ + int(n))
        count(self.timings, "hb_accumulate.residuals", sum(n_ for _, n_ in sums.values()))
        initial = sum(w * sums.get(ti, (0.0, 0))[0] / max(sums.get(ti, (0.0, 0))[1], 1)
                      for ti, w in enumerate(self._residual_weights()))
        if sums.get("depth", (0.0, 0))[1] > 0:
            initial += self.depth_weight * sums["depth"][0] / sums["depth"][1]
        return H, bb, initial, (offsets_int, offsets_rig, offsets_pose)

    def _lm_solve_apply(self, H, bb, initial, offsets, vis):
        """The damped accept/reject ladder over the assembled system."""
        for lm_try in range(10):
            Hlm = H.copy()
            np.fill_diagonal(Hlm, np.diag(H) * (1.0 + self.lam))
            try:
                x = np.linalg.solve(Hlm, bb)
            except np.linalg.LinAlgError:
                self.lam *= 2.0
                continue
            new_params, new_extr, new_poses = self._candidate_state(x, *offsets)
            cand_cost = self._total_cost(new_params, new_poses, vis)
            if cand_cost < initial or lm_try == 9:  # force-apply the last try
                self._apply_state(new_params, new_extr, new_poses)
                self.lam *= 0.5
                return True, float(np.max(np.abs(x))) if len(x) else 0.0
            self.lam *= 2.0
        return False, 0.0

    def _lm_step(self, vis):
        """One full LM step (accumulate + damped ladder)."""
        with self._stage("hb_accumulate"):
            H, bb, initial, offsets = self._lm_accumulate(vis)
        return self._lm_solve_apply(H, bb, initial, offsets, vis)

    # -- numerical optimum check ---------------------------------------------

    def _component_deltas(self, offsets_int, offsets_rig, offsets_pose, V):
        """Per-variable perturbations of the numerical validator: 0.1 for the
        first four intrinsics, 0.01 for distortion, 1e-3 for translations,
        5e-4 for rotations."""
        deltas = np.zeros(V, np.float64)
        if self.optimize_intrinsics:
            for gi, g in enumerate(self.p.groups):
                P = int(g.camera.params.shape[0])
                oi = offsets_int[gi]
                deltas[oi:oi + P] = 0.01
                deltas[oi:oi + min(4, P)] = 0.1
        starts = []
        for ri, extr in enumerate(self.p.rig_extrinsics):
            starts += [offsets_rig[ri] + 6 * c for c in range(int(extr.q.shape[0]) - 1)]
        for gi, g in enumerate(self.p.groups):
            if offsets_pose[gi] is not None:
                starts += [offsets_pose[gi] + 6 * b for b in range(g.num_images)]
        for s in starts:
            deltas[s:s + 3] = 1e-3
            deltas[s + 3:s + 6] = 5e-4
        return deltas

    def check_for_optimum_numerically(self, go_to_optimum: bool = False,
                                      immediate_step_threshold: float = 0.05,
                                      print_errors: bool = True) -> bool:
        """Perturb every variable by its validator delta in both directions
        and check that none decreases the cost (observations stay frozen).
        With ``go_to_optimum`` the best (or the first large-step) improving
        state is applied and False returned."""
        offsets_int, offsets_rig, offsets_pose, V = self._var_layout()
        if self._frozen_vis is None:
            self._frozen_vis = self._visibility(self._occlusion_depths())
        vis = self._frozen_vis
        initial = self._total_cost([g.camera.params for g in self.p.groups],
                                   [g.poses for g in self.p.groups], vis)
        deltas = self._component_deltas(offsets_int, offsets_rig, offsets_pose, V)
        offsets = (offsets_int, offsets_rig, offsets_pose)
        best_step, best_x = 0.0, None
        for comp in range(V):
            for direction in (-1.0, 1.0):
                x = np.zeros(V, np.float64)
                x[comp] = deltas[comp] * direction
                prm, _, poses = self._candidate_state(x, *offsets)
                cost = self._total_cost(prm, poses, vis)
                if cost < initial:
                    step = initial - cost
                    if print_errors:
                        print(f"not at optimum: component {comp} direction "
                              f"{direction:+.0f} improves cost by {step:.6g}")
                    if go_to_optimum and step >= immediate_step_threshold:
                        self._apply_state(*self._candidate_state(x, *offsets))
                        return False
                    if step > best_step:
                        best_step, best_x = step, x
        if go_to_optimum and best_x is not None:
            self._apply_state(*self._candidate_state(best_x, *offsets))
        return best_x is None

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
        (cache drift check) -> refresh]* -> final-state cost -> restore the
        optimum. ``iteration_costs`` / ``observations``, if given, receive
        each iteration's entry cost and visible (image, point) pairs."""
        self.current_scale = max(0, min(self.current_scale, self.p.scale_count - 2))
        self.lam = 64.0
        optimum_cost = math.inf
        optimum_state = None
        without_new = 0
        converged = False
        it = 0

        def snapshot():
            return ([(g.camera.params, g.poses) for g in self.p.groups],
                    list(self.p.rig_extrinsics))

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
            if self.obs_cache is not None and (it + 1) % self.obs_cache_check_interval == 0:
                with self._stage("obs_cache_check"):
                    self._check_obs_cache_drift(print_progress)
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
            groups, extrinsics = optimum_state
            self._apply_state([prm for prm, _ in groups], extrinsics, [p for _, p in groups])
        return OptimizerReport(it + 1, optimum_cost, converged)

    def next_scale(self) -> bool:
        if self.current_scale == 0:
            return False
        self.current_scale -= 1
        return True

    def run(self, max_iterations_per_scale: int = 100, print_progress: bool = False,
            on_scale_done=None):
        """The full coarse-to-fine schedule down to scale 0; ``on_scale_done(
        optimizer, report)`` is called after every scale."""
        self.current_scale = self.p.scale_count - 2
        while True:
            report = self.run_on_current_scale(max_iterations_per_scale,
                                               print_progress=print_progress)
            if on_scale_done is not None:
                on_scale_done(self, report)
            if not self.next_scale():
                break
        return self.p

    # -- diagnostics ---------------------------------------------------------

    def render_cost_image(self, gi: int, b: int, which: str = "fixed", vis=None) -> np.ndarray:
        """Per-pixel point-cost image (the cost fixed / variable / combined
        display modes): every fully observed point's robust residual rho at
        its projected full-res pixel, the nearest point winning; NaN where no
        point lands."""
        if which not in ("fixed", "variable", "combined"):
            raise ValueError(f"unknown cost mode: {which}")
        if vis is None:
            vis = self._visibility(self._occlusion_depths())
        var_desc = None
        if which in ("variable", "combined"):
            var_desc = (self._var_desc if self._var_desc is not None
                        else self._compute_variable_descriptors(vis))
        g = self.p.groups[gi]
        cam = g.camera
        bi, j = self._batch_row[gi][b]
        batch = self._batches[gi][bi]
        flat, pairs = batch.flat[j:j + 1], None if batch.pairs is None else batch.pairs[j:j + 1]
        q, t = g.poses.q[b:b + 1], g.poses.t[b:b + 1]
        cost_img = np.full((cam.height, cam.width), np.nan, np.float32)
        depth_img = np.full((cam.height, cam.width), np.inf, np.float32)
        for l in range(len(self.p.levels)):
            mask, s = (x[j:j + 1] for x in vis[gi][l][bi])
            pts, nbr, fixed_desc = self._geom(gi, b, l)
            if mask.shape[1] != pts.shape[0]:  # a view padded to its chunk's largest
                mask, s = mask[:, :pts.shape[0]], s[:, :pts.shape[0]]
            rho = torch.zeros(pts.shape[0], dtype=torch.float32, device=self.device)
            ok = None
            # each component is masked on its own: a point valid in one
            # residual type only must not pick up the other's clamped samples
            if which in ("fixed", "combined"):
                r_f, ok_f = _point_costs(cam, cam.params, q, t, pts, nbr, fixed_desc, flat,
                                         batch.layout, s, mask, pairs)
                rho = rho + self.fixed_weight * torch.where(ok_f[0], r_f[0], 0.0)
                ok = ok_f[0]
            if which in ("variable", "combined"):
                desc, mask2 = var_desc[l]
                view = self._view(gi, b, l)
                if view is not None:
                    desc, mask2 = desc[view.gather_idx], mask2[view.gather_idx]
                r_v, ok_v = _point_costs(cam, cam.params, q, t, pts, nbr, desc, flat,
                                         batch.layout, s, mask & mask2, pairs)
                w_v = (self.variable_weight
                       if (which == "combined" and self.variable_weight > 0) else 1.0)
                rho = rho + w_v * torch.where(ok_v[0], r_v[0], 0.0)
                ok = ok_v[0] if ok is None else (ok | ok_v[0])
            p_cam = SE3(q[0], t[0]).apply(pts)
            pix, pv = cm.project(cam, p_cam)
            p_cam, pix, pv = p_cam.cpu().numpy(), pix.cpu().numpy(), pv.cpu().numpy()
            sel = ok.cpu().numpy() & pv
            ix = np.floor(pix[:, 0] + 0.5).astype(np.int64)
            iy = np.floor(pix[:, 1] + 0.5).astype(np.int64)
            sel &= (ix >= 0) & (iy >= 0) & (ix < cam.width) & (iy < cam.height)
            z = p_cam[:, 2]
            order = np.argsort(-z[sel])  # nearest assigned last -> wins
            ixs, iys = ix[sel][order], iy[sel][order]
            closer = z[sel][order] <= depth_img[iys, ixs]
            cost_img[iys[closer], ixs[closer]] = rho.cpu().numpy()[sel][order][closer]
            depth_img[iys[closer], ixs[closer]] = z[sel][order][closer]
        return cost_img
