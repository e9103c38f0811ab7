"""Joint multi-scene scan+image BA: rows produced on the device.

Port of ``dataset_pipeline_tpu/parallel/joint_ba.py``:

- **Rows are produced per image on the device** and only the block-sparse
  normal-equation pieces are kept: ``Hkk (n_keep, n_keep)`` for the kept
  block (shared intrinsics + free scan poses), per image ``Hki (n_keep, 6)``
  and ``Hii (6, 6)``. Nothing of size rows x n_vars exists.
- **The Schur complement** folds every image's ``W_i = Hki_i Hii_i^-1``
  into ``S = Hkk - sum_i W_i Hki_i^T``; the small reduced system is solved
  and each image's step follows by back-substitution.
- **An LM accept/reject loop** (diag*(1+lambda) damping, frozen-visibility
  accept test, halve/double with 10 tries, force-apply the last) wraps the
  step; ``tools/joint_ba.py`` exposes it over N scenes.

Variable layout: ``[shared intrinsics P | 6 per free scan (scene-major,
first scan of each scene gauge-fixed) | 6 per image (eliminated)]``.

Images and ICP rows are sharded over a mesh (``parallel/mesh.py``; a bare
device is a one-rank mesh): the images are padded to ``m_pad``, a multiple
of the mesh size (``img_valid`` False for the padding, which adds nothing),
the ICP rows likewise with ``w = 0``. Each rank folds its contiguous share
of the images, one at a time in order as the JAX ``lax.scan`` does, and its
share of the ICP rows, and damps its own part of the reduced system (the
damping is linear in the parts); S, rhs, cost and count are summed over the
mesh (JAX: ``psum``), every rank solves the same system, and the per-image
back-substituted steps are gathered so that every rank applies the same
update. Visibility and the frozen-visibility cost are per rank too. Sampling
goes through ``ops/pyramid_sample.py`` (B3 on the card) in both modes; each
system builds the flat pyramid of its images and, on the card, the
row-paired copy once. All contractions run in strict fp32 (the package keeps
TF32 off).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device
from dataset_pipeline_tpu_torch.icp.moments import quat_mul_np, se3_exp_np
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import (
    SE3,
    quat_rotate,
    quat_rotate_fused,
    quat_to_matrix_np,
)
from dataset_pipeline_tpu_torch.ops.hb_geometry import forward_jacobian, project_full
from dataset_pipeline_tpu_torch.ops.hb_gram import (
    descriptor_residuals,
    gram,
    gram_assemble_plain,
    huber_terms,
)
from dataset_pipeline_tpu_torch.ops.knn import build_grid, nearest_neighbor
from dataset_pipeline_tpu_torch.ops.pyramid_sample import flatten_pyramid, pair_rows, pyramid_sample
from dataset_pipeline_tpu_torch.ops.splat import render_splats_depth
from dataset_pipeline_tpu_torch.parallel.ba import _cross
from dataset_pipeline_tpu_torch.parallel.mesh import Mesh, as_mesh, padded_rows, shard_range
from dataset_pipeline_tpu_torch.utils.timing import StageTimer


# ---------------------------------------------------------------------------
# Packed problem (host -> device once)
# ---------------------------------------------------------------------------


@dataclass
class JointBAPack:
    """Device-resident joint problem: scene geometry padded to the largest
    scene, per-image arrays, image poses and the pooled ICP correspondences."""

    device: torch.device
    mesh: Mesh
    camera: cm.Camera
    n_scenes: int
    n_images: int  # real image count (m)
    m_pad: int  # padded to a multiple of the mesh size
    s_max: int  # max scans per scene
    n_int: int  # optimized intrinsics params (0 = fixed)
    n_free: int  # free scan blocks (gauge-fixed excluded)
    scale_count: int
    occl_downscale: int
    scene_points: torch.Tensor  # (n_scenes, N_max, 3) scan-local-in-global
    scene_scan_idx: torch.Tensor  # (n_scenes, N_max) int64
    scene_neighbors: torch.Tensor  # (n_scenes, N_max, K) int64
    scene_desc: torch.Tensor  # (n_scenes, N_max, K)
    scene_valid: torch.Tensor  # (n_scenes, N_max) bool
    scene_radius: torch.Tensor  # (n_scenes, N_max) per-point footprint radii
    scan_col: torch.Tensor  # (n_scenes, s_max) free-block id or -1
    expand: torch.Tensor  # (n_scenes, Dk, n_keep) block expansion
    img_scene: torch.Tensor  # (m_pad,) int64
    img_valid: torch.Tensor  # (m_pad,) bool
    pose_q0: torch.Tensor  # (m_pad, 4) initial poses
    pose_t0: torch.Tensor  # (m_pad, 3)
    pyramids: List[torch.Tensor]  # per level (m_pad, H_l, W_l)
    icp_ps: torch.Tensor  # (M_pad, 3) scan-local-in-global endpoints
    icp_ns: torch.Tensor
    icp_pt: torch.Tensor
    icp_nt: torch.Tensor
    icp_w: torch.Tensor  # (M_pad,) 0 = padding
    icp_scene: torch.Tensor  # (M_pad,) int64
    icp_src_s: torch.Tensor  # (M_pad,) scan index within its scene
    icp_tgt_s: torch.Tensor
    scan_col_np: np.ndarray
    img_scene_np: np.ndarray
    occlusion_radius: float
    occlusion_depth_threshold: float
    n_icp: int
    # the original per-row ICP weights (never mutated): the correspondence
    # refresh derives its candidate rows from these, so a row zeroed by a
    # transient pose excursion can match again later
    icp_w0_np: Optional[np.ndarray] = None

    @property
    def n_keep(self) -> int:
        return self.n_int + 6 * self.n_free

    @property
    def dk(self) -> int:
        return self.n_int + 6 * self.s_max


def _identity_corrections(n_scenes: int, s_max: int, device):
    q = torch.zeros((n_scenes, s_max, 4), dtype=torch.float32, device=device)
    q[..., 0] = 1.0
    return q, torch.zeros((n_scenes, s_max, 3), dtype=torch.float32, device=device)


def make_state(pack: JointBAPack) -> dict:
    """Initial state: current intrinsics, identity per-scan corrections,
    packed image poses."""
    corr_q, corr_t = _identity_corrections(pack.n_scenes, pack.s_max, pack.device)
    return {"params": pack.camera.params.to(torch.float32), "corr_q": corr_q, "corr_t": corr_t,
            "pose_q": pack.pose_q0, "pose_t": pack.pose_t0}


def state_from_numpy(pack, state_np: dict, device=None) -> dict:
    """The JAX package's state dict as numpy arrays (``params``, ``corr_q/t``,
    ``pose_q/t``, and for the rig form ``extr_q/t``, with ``params`` one
    array per rig slot) as the port's state on ``device`` (the pack's by
    default)."""
    device = pack.device if device is None else default_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    out = {k: f32(v) for k, v in state_np.items() if k != "params"}
    prm = state_np["params"]
    out["params"] = tuple(f32(p) for p in prm) if isinstance(prm, (tuple, list)) else f32(prm)
    return out


def _scene_geometry(scenes, all_levels: bool):
    """Every scene's point levels concatenated (neighbor indices offset per
    level), padded to the largest scene: numpy (points, scan idx, neighbors,
    descriptors, valid, radius)."""

    def scene_levels(sc):
        return list(sc.problem.levels) if all_levels else [sc.problem.levels[sc.level_idx]]

    n_scenes = len(scenes)
    n_max = max(sum(lv.points.shape[0] for lv in scene_levels(sc)) for sc in scenes)
    K = scenes[0].problem.levels[scenes[0].level_idx].neighbors.shape[1]
    sp = np.zeros((n_scenes, n_max, 3), np.float32)
    ss = np.zeros((n_scenes, n_max), np.int64)
    sn = np.zeros((n_scenes, n_max, K), np.int64)
    sd = np.zeros((n_scenes, n_max, K), np.float32)
    sv = np.zeros((n_scenes, n_max), bool)
    sr = np.zeros((n_scenes, n_max), np.float32)
    for si, sc in enumerate(scenes):
        off = 0
        for lv in scene_levels(sc):
            n = lv.points.shape[0]
            sl = slice(off, off + n)
            sp[si, sl] = lv.points.cpu().numpy()
            ss[si, sl] = lv.scan_indices.cpu().numpy()
            sn[si, sl] = lv.neighbors.cpu().numpy() + off
            sd[si, sl] = lv.fixed_descriptors.cpu().numpy()
            sv[si, sl] = True
            sr[si, sl] = lv.radius
            off += n
    return sp, ss, sn, sd, sv, sr


def _free_scan_columns(scenes, s_max: int) -> np.ndarray:
    """(n_scenes, s_max) free-block id per scan, -1 for each scene's
    gauge-fixed first scan and for absent scans."""
    scan_col = np.full((len(scenes), s_max), -1, np.int32)
    col = 0
    for si, sc in enumerate(scenes):
        for s in range(1, sc.num_scans):
            scan_col[si, s] = col
            col += 1
    return scan_col


def _pool_icp(scenes, n_ranks: int):
    """The scenes' ICP correspondences pooled (numpy), padded with
    zero-weight rows to a positive multiple of ``n_ranks``, as JAX pads to
    its mesh size."""
    cols = {k: [] for k in "ps ns pt nt w scene src tgt".split()}
    for si, sc in enumerate(scenes):
        if sc.icp is None:
            continue
        ps, ns, pt, nt, src_s, tgt_s = sc.icp
        M = len(ps)
        cols["ps"].append(np.asarray(ps, np.float32))
        cols["ns"].append(np.asarray(ns, np.float32))
        cols["pt"].append(np.asarray(pt, np.float32))
        cols["nt"].append(np.asarray(nt, np.float32))
        cols["w"].append(np.full(M, sc.icp_weight, np.float32))
        cols["scene"].append(np.full(M, si, np.int64))
        cols["src"].append(np.asarray(src_s, np.int64))
        cols["tgt"].append(np.asarray(tgt_s, np.int64))
    if cols["w"]:
        cat = {k: np.concatenate(v) for k, v in cols.items()}
    else:
        cat = {k: np.zeros((0, 3) if k in ("ps", "ns", "pt", "nt") else (0,),
                           np.float32 if k in ("ps", "ns", "pt", "nt", "w") else np.int64)
               for k in cols}
    M = len(cat["w"])
    pad = max(-(-M // n_ranks), 1) * n_ranks - M
    return {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)]) for k, v in cat.items()}, M


def _pad_images(x: torch.Tensor, n: int, fill=0.0) -> torch.Tensor:
    """``x`` with its leading (image) axis padded to ``n`` with ``fill``."""
    pad = n - x.shape[0]
    return x if pad == 0 else torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def _identity_poses(poses_q, poses_t, n: int):
    """Pose arrays padded to ``n`` with identity poses."""
    q = _pad_images(poses_q, n)
    q[poses_q.shape[0]:, 0] = 1.0
    return q, _pad_images(poses_t, n)


def pack_scenes(mesh, scenes, optimize_intrinsics: bool = True, occl_downscale: int = 2,
                occlusion_radius: float = 0.03, occlusion_depth_threshold: float = 0.01,
                all_levels: bool = True) -> JointBAPack:
    """Pack a list of ``JointScene`` (``parallel.ba``) for ``mesh`` (a
    ``Mesh``, or a device, the card unless named, for one rank): every rank
    holds the whole pack on its device, the images and ICP rows padded to a
    multiple of the mesh size. All scenes share one camera.

    ``all_levels`` (default): every multi-resolution point level of each
    scene's problem is concatenated (per-point footprint radii, neighbor
    indices offset per level); ``False`` keeps each scene's ``level_idx``."""
    mesh = as_mesh(mesh)
    device = mesh.device
    cam = scenes[0].problem.groups[0].camera
    n_int = int(cam.params.shape[0]) if optimize_intrinsics else 0
    n_scenes = len(scenes)
    s_max = max(sc.num_scans for sc in scenes)
    scan_col = _free_scan_columns(scenes, s_max)
    n_free = int((scan_col >= 0).sum())
    n_keep = n_int + 6 * n_free
    dk = n_int + 6 * s_max

    expand = np.zeros((n_scenes, dk, n_keep), np.float32)
    for si in range(n_scenes):
        expand[si, :n_int, :n_int] = np.eye(n_int)
        for s in range(s_max):
            c = scan_col[si, s]
            if c >= 0:
                expand[si, n_int + 6 * s:n_int + 6 * s + 6, n_int + 6 * c:n_int + 6 * c + 6] = np.eye(6)
    sp, ss, sn, sd, sv, sr = _scene_geometry(scenes, all_levels)

    img_scene, pose_q, pose_t = [], [], []
    pyr_levels = None
    for si, sc in enumerate(scenes):
        g = sc.problem.groups[0]
        if pyr_levels is None:
            pyr_levels = [[] for _ in g.pyramid]
        for li, lvl in enumerate(g.pyramid):
            pyr_levels[li].append(lvl.to(device, torch.float32))
        img_scene += [si] * g.num_images
        pose_q.append(g.poses.q.to(device, torch.float32))
        pose_t.append(g.poses.t.to(device, torch.float32))
    m = len(img_scene)
    m_pad = padded_rows(m, mesh)
    img_scene_np = np.asarray(img_scene + [0] * (m_pad - m), np.int64)
    icp, M = _pool_icp(scenes, mesh.size)
    pose_q0, pose_t0 = _identity_poses(torch.cat(pose_q), torch.cat(pose_t), m_pad)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return JointBAPack(
        device=device, mesh=mesh, camera=cam.to(device), n_scenes=n_scenes, n_images=m,
        m_pad=m_pad, s_max=s_max, n_int=n_int, n_free=n_free, scale_count=len(pyr_levels),
        occl_downscale=occl_downscale,
        scene_points=dev(sp), scene_scan_idx=dev(ss), scene_neighbors=dev(sn),
        scene_desc=dev(sd), scene_valid=dev(sv), scene_radius=dev(sr),
        scan_col=dev(scan_col.astype(np.int64)), expand=dev(expand),
        img_scene=dev(img_scene_np), img_valid=torch.arange(m_pad, device=device) < m,
        pose_q0=pose_q0, pose_t0=pose_t0,
        pyramids=[_pad_images(torch.cat(lvls), m_pad) for lvls in pyr_levels],
        icp_ps=dev(icp["ps"]), icp_ns=dev(icp["ns"]), icp_pt=dev(icp["pt"]),
        icp_nt=dev(icp["nt"]), icp_w=dev(icp["w"]), icp_scene=dev(icp["scene"]),
        icp_src_s=dev(icp["src"]), icp_tgt_s=dev(icp["tgt"]),
        scan_col_np=scan_col, img_scene_np=img_scene_np, occlusion_radius=occlusion_radius,
        occlusion_depth_threshold=occlusion_depth_threshold, n_icp=M,
        icp_w0_np=icp["w"].copy())


def _stage(timer: Optional[StageTimer], name: str):
    return nullcontext() if timer is None else timer.stage(name)


# ---------------------------------------------------------------------------
# Per-image device passes
# ---------------------------------------------------------------------------


def _corrected_points(pack, corr_q, corr_t, si: int):
    """Scene ``si``'s points under the current per-scan corrections (the
    fused form, as XLA compiles it inside the JAX passes' ``jit``)."""
    scan = pack.scene_scan_idx[si]
    return quat_rotate_fused(corr_q[si][scan], pack.scene_points[si]) + corr_t[si][scan]


def _occlusion_camera(cam, d: int):
    """``cam`` on the occlusion grid of the image divided by ``d`` per axis
    (``width // d`` x ``height // d``, pixel-centre convention): the focals
    over d, the centres (c + 0.5) / d - 0.5, the lens as it is."""
    n = 1 if cam.spec.unique_focal else 2
    p = cam.params
    return replace(cam, width=cam.width // d, height=cam.height // d,
                   params=torch.cat([p[:n] / d, (p[n:n + 2] + 0.5) / d - 0.5, p[n + 2:]]))


def _vis_one_image(pack, params, corr_q, corr_t, pose_q, pose_t, si: int, current_scale,
                   camera=None):
    """Visibility + frozen footprint observation scale for one image: splat
    occlusion z-test with slack at 1/occl_downscale resolution, footprint
    scale from the projected point radius, border check at the coarser
    interpolation scale. ``camera`` is the image's (the pack's by default)."""
    cam = pack.camera if camera is None else camera
    pts = _corrected_points(pack, corr_q, corr_t, si)
    radius = pack.scene_radius[si]
    width, height = cam.width, cam.height
    d = pack.occl_downscale
    wo, ho = width // d, height // d

    # the fused forms: XLA contracts multiply-adds inside the JAX pass's jit,
    # and the footprint difference pix2 - pix magnifies an ulp ~1e4-fold
    p_cam = SE3(pose_q, pose_t).apply_fused(pts)
    pix, valid = cm.project(cam.with_params(params), p_cam, fused=True)
    z = p_cam[:, 2]

    occl = render_splats_depth(
        p_cam[None], torch.full(pts.shape[:1], pack.occlusion_radius, dtype=torch.float32,
                                device=pts.device),
        _occlusion_camera(cam, d), max_radius_px=2)[0]
    # float bounds before the int cast (XLA's cast saturates, torch's wraps)
    ix = torch.clamp(torch.round((pix[:, 0] + 0.5) / d - 0.5).nan_to_num(0.0), 0, wo - 1).long()
    iy = torch.clamp(torch.round((pix[:, 1] + 0.5) / d - 0.5).nan_to_num(0.0), 0, ho - 1).long()
    occ = occl[iy, ix]
    valid = valid & (z <= occ + pack.occlusion_depth_threshold) & (z > 0.05)

    eps = 1e-3 * torch.clamp(z, min=1e-6)
    p2 = p_cam + torch.stack([eps, torch.zeros_like(eps), torch.zeros_like(eps)], -1)
    pix2, _ = cm.project(cam.with_params(params), p2, fused=True)
    px_per_m = torch.sqrt(cm._sqnorm(pix2 - pix, keepdim=False)) / eps
    obs_scale = torch.log2(torch.clamp(2.0 * radius * px_per_m, min=1e-12))
    valid = (valid & (obs_scale >= current_scale)
             & (torch.floor(obs_scale) < pack.scale_count - 1) & (obs_scale >= 0))

    factor = torch.pow(2.0, -(torch.floor(obs_scale) + 1))
    xs = factor * (pix[:, 0] + 0.5) - 0.5
    ys = factor * (pix[:, 1] + 0.5) - 0.5
    w_si = torch.floor(width * factor + 0.5)
    h_si = torch.floor(height * factor + 0.5)
    valid = (valid & (xs + 0.5 >= 1.0) & (ys + 0.5 >= 1.0)
             & (xs + 0.5 < w_si - 1.0) & (ys + 0.5 < h_si - 1.0))
    return valid & pack.scene_valid[si], obs_scale


def _intensity_derivs(cam, params, p_cam0, flat, layout, pairs, obs_scale):
    """(pix, valid, intensity, dI/dx, dI/dy, sample ok) of camera-frame
    points: one derivatives-mode sample per point."""
    pix, valid = project_full(cam, params, p_cam0)
    inten, dpx, dpy, _, okS = pyramid_sample(flat, layout, pix[None].contiguous(),
                                             obs_scale[None].contiguous(), with_derivs=True,
                                             pairs=pairs)
    return pix, valid, inten[0], dpx[0], dpy[0], okS[0]


def _chain(dpx, dpy):
    """dI/dvar from dpix/dvar."""
    return lambda dpix: dpx * dpix[..., 0] + dpy * dpix[..., 1]


def _scan_rows(pack, cam, params, pose0: SE3, p_cam0, pts, si: int, dpx, dpy):
    """(N, 6*s_max) scan columns: dI/dp_world = dI/dpix . dpix/dp_cam . R
    with the left-multiplicative tangent d(exp(eps) p)/deps = [I | -[p]x],
    i.e. [dIdp, p x dIdp], in the point's scan slot."""
    n = pts.shape[0]
    Jpix_pc = forward_jacobian(lambda pc: project_full(cam, params, pc)[0], (p_cam0,),
                                lambda t: (t.expand(n, 3),),
                                torch.eye(3, dtype=pts.dtype, device=pts.device),
                                lambda dpix: dpix, n)  # (N, 2, 3)
    R = pose0.rotation_matrix()
    Jpix_pw = torch.einsum("nij,jk->nik", Jpix_pc, R)
    dIdp = dpx[:, None] * Jpix_pw[:, 0, :] + dpy[:, None] * Jpix_pw[:, 1, :]
    J_scan6 = torch.cat([dIdp, _cross(pts, dIdp)], -1)
    onehot = (pack.scene_scan_idx[si][:, None]
              == torch.arange(pack.s_max, device=pts.device)[None, :]).to(pts.dtype)
    return (J_scan6[:, None, :] * onehot[:, :, None]).reshape(n, 6 * pack.s_max)


def _rows_one_image(pack, params, corr_q, corr_t, pose_q, pose_t, si: int, flat, layout, pairs,
                    vis, obs_scale):
    """Compact per-image Gram: J (N, D) with D = [n_int | 6*s_max | 6], then
    the descriptor-residual Gram assembly of ``gram_assemble_plain``.

    One derivatives-mode sample per point chained with forward-mode
    Jacobians of the projection: pose/intrinsics blocks directly, the scan
    blocks through dpix/dp_cam rotated to the world frame."""
    cam = pack.camera
    pts = _corrected_points(pack, corr_q, corr_t, si)
    pose0 = SE3(pose_q, pose_t)
    p_cam0 = pose0.apply(pts)
    # visibility gates the centre point (contrib below); neighbours need only
    # be sample-valid, as in the single-scene engine
    pix, valid, inten, dpx, dpy, okS = _intensity_derivs(cam, params, p_cam0, flat, layout, pairs,
                                                         obs_scale)
    ok = valid & okS

    P = params.shape[0]
    eps0 = torch.zeros(6, dtype=torch.float32, device=pts.device)
    basis = torch.eye(P + 6, dtype=torch.float32, device=pts.device)
    J_pe = forward_jacobian(
        lambda eps, prm: project_full(cam, prm, SE3.exp(eps).compose(pose0).apply(pts))[0],
        (eps0, params), lambda t: (t[P:], t[:P]), basis if pack.n_int > 0 else basis[P:],
        _chain(dpx, dpy), pts.shape[0])
    rows_scan = _scan_rows(pack, cam, params, pose0, p_cam0, pts, si, dpx, dpy)
    J = torch.cat([J_pe[:, :-6], rows_scan, J_pe[:, -6:]], -1)
    return _image_gram(J, inten, ok, pack.scene_neighbors[si], pack.scene_desc[si],
                       vis & pack.scene_valid[si])


def _image_gram(J, inten, ok, neighbors, desc, contrib):
    """One image's (G, g, cost, count) from its per-point Jacobian J (N, D):
    ``gram_assemble_plain`` with the products accumulated in float64 and rounded
    to float32. A float32 BLAS sum over the N points strays from XLA's
    float32 dot by more than the JAX tests' own bounds allow (rtol 1e-4 per
    entry where a Gram entry cancels); the float64 sum stays within them."""
    G, g, cost, count = gram_assemble_plain(J[None].double(), inten[None], ok[None], neighbors,
                                            desc, contrib[None])
    return G[0].float(), g[0].float(), cost, count


def _cost_one_image(pack, params, corr_q, corr_t, pose_q, pose_t, si: int, flat, layout, pairs,
                    vis, obs_scale, camera=None):
    """Robust descriptor cost of one image under frozen visibility (the LM
    accept test): (cost, count)."""
    cam = pack.camera if camera is None else camera
    pts = _corrected_points(pack, corr_q, corr_t, si)
    pix, valid = project_full(cam, params, SE3(pose_q, pose_t).apply(pts))
    inten, okS = pyramid_sample(flat, layout, pix[None].contiguous(), obs_scale[None].contiguous(),
                                with_derivs=False, pairs=pairs)
    r, all_ok = descriptor_residuals(inten, valid[None] & okS, pack.scene_neighbors[si],
                                     pack.scene_desc[si], (vis & pack.scene_valid[si])[None])
    _, rho = huber_terms(r)
    return torch.sum(torch.where(all_ok, rho, torch.zeros_like(rho))), torch.sum(all_ok)


def _icp_local(pack, corr_q, corr_t, rows: slice = slice(None)):
    """The ICP rows (``rows`` of them: a rank's share) -> (Hs (6F, 6F),
    bs (6F,), cost) over the free-scan section of the kept block.
    Correspondence endpoints move with their scans' corrections;
    +target/-source for the source-normal row, the roles swapped for the
    target-normal twin."""
    F = pack.n_free
    w = pack.icp_w[rows]
    dev = w.device
    if F == 0 or w.shape[0] == 0:
        return (torch.zeros((6 * F, 6 * F), device=dev), torch.zeros((6 * F,), device=dev),
                torch.zeros((), device=dev))
    sc, src_s, tgt_s = pack.icp_scene[rows], pack.icp_src_s[rows], pack.icp_tgt_s[rows]
    qs, ts = corr_q[sc, src_s], corr_t[sc, src_s]
    qt, tt = corr_q[sc, tgt_s], corr_t[sc, tgt_s]
    ps = quat_rotate(qs, pack.icp_ps[rows]) + ts
    pt = quat_rotate(qt, pack.icp_pt[rows]) + tt
    ns = quat_rotate(qs, pack.icp_ns[rows])
    nt = quat_rotate(qt, pack.icp_nt[rows])
    diff = pt - ps
    r1 = torch.sum(ns * diff, -1)
    r2 = -torch.sum(nt * diff, -1)
    j1 = torch.cat([ns, _cross(pt, ns)], -1)
    j2 = torch.cat([nt, _cross(ps, nt)], -1)
    src_col = pack.scan_col[sc, src_s]  # (M,), -1 = gauge-fixed
    tgt_col = pack.scan_col[sc, tgt_s]
    blocks = torch.arange(F, device=dev)[None, :]
    sgn = ((tgt_col[:, None] == blocks).to(torch.float32)
           - (src_col[:, None] == blocks).to(torch.float32))  # (M, F)
    sw = torch.sqrt(w)[:, None]

    def gram_of(j, r):
        rows = (j[:, None, :] * sgn[:, :, None]).reshape(-1, 6 * F)
        rows_w = rows * sw
        rw = w * r
        # one (6F x M)(M x 6F) product leaves cuBLAS a few tiles: gram slices the rows
        return gram(rows_w[None], rows_w[None])[0], torch.sum(rows * rw[:, None], 0), torch.sum(rw * r)

    H1, b1, c1 = gram_of(j1, r1)
    # the twin rows carry the negated sign pattern; (-sgn) Grams equal sgn
    # Grams, so sgn is reused with the residual negated for b
    H2, b2, c2 = gram_of(j2, -r2)
    return H1 + H2, b1 + b2, c1 + c2


def _damped_schur(Hkk, bk, Hki, Hii, bi, img_valid, lam: float, mesh: Mesh):
    """The damped reduced system and its solution: (x_keep, x_img) float32.
    The pieces are this rank's (its images, and its ICP rows folded into
    Hkk, bk); each rank damps and reduces its own part, S and rhs are summed
    over ``mesh``, every rank solves, and the images' steps are gathered in
    image order. diag*(1+lam) damping; images with no observations (or
    padding) are decoupled by an identity block whose inverse is then
    zeroed. The elimination and the solve run in float64 (the JAX package's
    run in float32; the registrator's port solves in float64 too): the
    reduced system's condition number (~1e5 with free intrinsics) would
    otherwise turn float32 rounding into percent-level differences of the
    step between the card and the CPU."""
    Hkk, bk, Hki, Hii, bi = (x.double() for x in (Hkk, bk, Hki, Hii, bi))
    n_keep = Hkk.shape[0]
    eye6 = torch.eye(6, dtype=Hii.dtype, device=Hii.device)
    Hii_d = Hii * (1.0 + lam * eye6[None])
    ok_img = img_valid & (torch.einsum("mii->m", Hii) > 0)
    Hii_d = torch.where(ok_img[:, None, None], Hii_d, eye6[None])
    # the _ex form returns inf/NaN for a singular block (as jnp.linalg.inv)
    # instead of raising, and syncs nothing on the card
    inv_Hii = torch.linalg.inv_ex(Hii_d)[0]
    inv_Hii = torch.where(ok_img[:, None, None], inv_Hii, torch.zeros_like(inv_Hii))
    eye_k = torch.eye(n_keep, dtype=Hkk.dtype, device=Hkk.device)
    W = torch.einsum("mki,mij->mkj", Hki, inv_Hii)
    S = Hkk * (1.0 + lam * eye_k) - torch.einsum("mki,mni->kn", W, Hki)
    rhs = bk - torch.einsum("mki,mi->k", W, bi)
    S, rhs = mesh.all_reduce(S), mesh.all_reduce(rhs)
    x_keep = torch.linalg.solve_ex(S + 1e-10 * eye_k, rhs)[0]
    r_i = bi - torch.einsum("mki,k->mi", Hki, x_keep)
    return x_keep.float(), mesh.all_gather(torch.einsum("mij,mj->mi", inv_Hii, r_i).float())


# ---------------------------------------------------------------------------
# The system
# ---------------------------------------------------------------------------


class JointBASystem:
    """The joint-BA passes over a fixed pack, each rank on its images and
    ICP rows (all of them on one rank):

    - ``visibility(state) -> (vis, obs_scale)``, (m_local, N_max) each, for
      this rank's images;
    - ``step(state, vis, obs_scale, lam) -> (x_keep, x_img (m_pad, 6), cost,
      count)``, replicated on every rank;
    - ``cost(state, vis, obs_scale) -> (cost, count)``, summed over the mesh.

    The flat copy of this rank's pyramids (and on the card its row-paired
    copy, which B3 reads) is built once here. ``timer``, if given, times
    each pass as the stage ``joint_ba.<pass>`` (the card synchronized around
    it)."""

    def __init__(self, pack: JointBAPack, current_scale: float = 0.0,
                 timer: Optional[StageTimer] = None):
        self.pack = pack
        self.mesh = pack.mesh
        self.current_scale = float(current_scale)
        self.timer = timer
        self.images = range(pack.m_pad)[shard_range(pack.mesh, pack.m_pad)]
        self.icp_rows = shard_range(pack.mesh, pack.icp_w.shape[0])
        self.flat, self.layout = flatten_pyramid(
            [p[self.images.start:self.images.stop] for p in pack.pyramids])
        self.pairs = pair_rows(self.flat, self.layout) if self.flat.is_cuda else None

    def _image(self, j: int):
        """The flat pyramid of this rank's ``j``-th image."""
        return (self.flat[j:j + 1], self.layout,
                None if self.pairs is None else self.pairs[j:j + 1])

    def visibility(self, state):
        p = self.pack
        with _stage(self.timer, "joint_ba.visibility"):
            vs, ss = [], []
            for i in self.images:
                v, s = _vis_one_image(p, state["params"], state["corr_q"], state["corr_t"],
                                      state["pose_q"][i], state["pose_t"][i],
                                      int(p.img_scene_np[i]), self.current_scale)
                vs.append(v & p.img_valid[i])
                ss.append(s)
            return torch.stack(vs), torch.stack(ss)

    def normal_equations(self, state, vis, obs_scale):
        """This rank's block-sparse pieces of H, b: (Hkk, bk, Hki (m_local,k,6),
        Hii (m_local,6,6), bi (m_local,6), cost, count) of its images, its ICP
        rows folded into Hkk / bk; not summed over the mesh."""
        p = self.pack
        n_keep, dk, n_int, dev = p.n_keep, p.dk, p.n_int, p.device
        Hkk = torch.zeros((n_keep, n_keep), device=dev)
        bk = torch.zeros((n_keep,), device=dev)
        cost = torch.zeros((), device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        Hki, Hii, bi = [], [], []
        for j, i in enumerate(self.images):
            si = int(p.img_scene_np[i])
            G, g, c_i, n_i = _rows_one_image(p, state["params"], state["corr_q"], state["corr_t"],
                                             state["pose_q"][i], state["pose_t"][i], si,
                                             *self._image(j), vis[j], obs_scale[j])
            E = p.expand[si]  # (dk, n_keep)
            Hkk = Hkk + E.T @ (G[:dk, :dk] @ E)
            bk = bk + E.T @ g[:dk]
            cost = cost + c_i
            count = count + n_i
            Hki.append(E.T @ G[:dk, dk:])
            Hii.append(G[dk:, dk:])
            bi.append(g[dk:])
        Hs, bs, c_icp = _icp_local(p, state["corr_q"], state["corr_t"], self.icp_rows)
        if p.n_free > 0:
            Hkk = Hkk.clone()
            Hkk[n_int:, n_int:] += Hs
            bk = bk.clone()
            bk[n_int:] += bs
        return Hkk, bk, torch.stack(Hki), torch.stack(Hii), torch.stack(bi), cost + c_icp, count

    def step(self, state, vis, obs_scale, lam: float):
        p = self.pack
        with _stage(self.timer, "joint_ba.step"):
            Hkk, bk, Hki, Hii, bi, cost, count = self.normal_equations(state, vis, obs_scale)
            x_keep, x_img = _damped_schur(Hkk, bk, Hki, Hii, bi,
                                          p.img_valid[self.images.start:self.images.stop], lam,
                                          self.mesh)
            return x_keep, x_img, self.mesh.all_reduce(cost), self.mesh.all_reduce(count)

    def cost(self, state, vis, obs_scale):
        p = self.pack
        with _stage(self.timer, "joint_ba.cost"):
            costs, counts = [], []
            for j, i in enumerate(self.images):
                c, n = _cost_one_image(p, state["params"], state["corr_q"], state["corr_t"],
                                       state["pose_q"][i], state["pose_t"][i],
                                       int(p.img_scene_np[i]), *self._image(j), vis[j],
                                       obs_scale[j])
                costs.append(c)
                counts.append(n)
            _, _, c_icp = _icp_local(p, state["corr_q"], state["corr_t"], self.icp_rows)
            return (self.mesh.all_reduce(torch.sum(torch.stack(costs)) + c_icp),
                    self.mesh.all_reduce(torch.sum(torch.stack(counts))))


# ---------------------------------------------------------------------------
# LM loop (host control flow, device evaluation)
# ---------------------------------------------------------------------------


def _apply_scan_deltas(pack, state, x_keep, offset: int):
    """Per-scan corrections after the exp(-delta) update of the free blocks
    at ``offset`` in ``x_keep`` (host float64): (corr_q, corr_t) float32."""
    corr_q = state["corr_q"].double().cpu().numpy()
    corr_t = state["corr_t"].double().cpu().numpy()
    for si in range(pack.n_scenes):
        for s in range(pack.s_max):
            c = pack.scan_col_np[si, s]
            if c < 0:
                continue
            dq, dt = se3_exp_np(-x_keep[offset + 6 * c:offset + 6 * c + 6])
            corr_t[si, s] = quat_to_matrix_np(dq) @ corr_t[si, s] + dt
            q_new = quat_mul_np(dq, corr_q[si, s])
            corr_q[si, s] = q_new / np.linalg.norm(q_new)
    dev = state["corr_q"].device
    return (torch.as_tensor(corr_q, dtype=torch.float32, device=dev),
            torch.as_tensor(corr_t, dtype=torch.float32, device=dev))


def _apply_pose_deltas(state, x_img):
    dev = state["pose_q"].device
    poses = SE3.exp(torch.as_tensor(-x_img, dtype=torch.float32, device=dev)).compose(
        SE3(state["pose_q"], state["pose_t"]))
    return poses.q, poses.t


def apply_delta(pack: JointBAPack, state, x_keep, x_img):
    """Apply a solved step with the framework's exp(-delta) convention."""
    x_keep = np.asarray(torch.as_tensor(x_keep).double().cpu(), np.float64)
    x_img = np.asarray(torch.as_tensor(x_img).double().cpu(), np.float64)
    new = dict(state)
    if pack.n_int > 0:
        new["params"] = state["params"] - torch.as_tensor(
            x_keep[:pack.n_int], dtype=torch.float32, device=state["params"].device)
    new["corr_q"], new["corr_t"] = _apply_scan_deltas(pack, state, x_keep, pack.n_int)
    new["pose_q"], new["pose_t"] = _apply_pose_deltas(state, x_img)
    return new


def refresh_icp_correspondences(pack, state, clouds: dict, max_dist: float) -> None:
    """Re-find the ICP targets in the current state, keeping the shapes.

    The source side (ps/ns, scene/src/tgt assignment, row count) stays
    frozen; only the matched target endpoint (pt/nt, stored in the initial
    frame) and the gate weight w change. ``clouds[(scene, scan)] = (points,
    normals)`` in the initial global frame (numpy)."""
    dev = pack.icp_ps.device
    ps = pack.icp_ps.cpu().numpy()
    scene = pack.icp_scene.cpu().numpy()
    src_s = pack.icp_src_s.cpu().numpy()
    tgt_s = pack.icp_tgt_s.cpu().numpy()
    # candidate rows come from the original weights, not the current ones:
    # a row whose match was lost at some iteration may match again
    w0 = pack.icp_w0_np if pack.icp_w0_np is not None else pack.icp_w.cpu().numpy()
    corr_q = state["corr_q"].double().cpu().numpy()
    corr_t = state["corr_t"].double().cpu().numpy()
    pt_new = pack.icp_pt.cpu().numpy().copy()
    nt_new = pack.icp_nt.cpu().numpy().copy()
    w_new = pack.icp_w.cpu().numpy().copy()

    def corrected(si, s, pts):
        return pts @ quat_to_matrix_np(corr_q[si, s]).T + corr_t[si, s]

    grids = {}
    real = w0 > 0
    keys = set(zip(scene[real].tolist(), src_s[real].tolist(), tgt_s[real].tolist()))
    for (si, s, t) in sorted(keys):
        rows = real & (scene == si) & (src_s == s) & (tgt_s == t)
        if (si, t) not in grids:
            tp, tn = clouds[(si, t)]
            grids[(si, t)] = (build_grid(torch.as_tensor(corrected(si, t, tp).astype(np.float32),
                                                         device=dev), max_dist), tp, tn)
        grid, tp, tn = grids[(si, t)]
        q = torch.as_tensor(corrected(si, s, ps[rows]).astype(np.float32), device=dev)
        d2, idx = (x.cpu().numpy() for x in nearest_neighbor(grid, q))
        ok = (idx >= 0) & (d2 <= max_dist * max_dist)
        safe = np.maximum(idx, 0)
        pt_new[rows] = np.where(ok[:, None], tp[safe], pt_new[rows])
        nt_new[rows] = np.where(ok[:, None], tn[safe], nt_new[rows])
        wr = w_new[rows]
        wr[~ok] = 0.0
        wr[ok] = w0[rows][ok]
        w_new[rows] = wr
    pack.icp_pt = torch.as_tensor(pt_new, device=dev)
    pack.icp_nt = torch.as_tensor(nt_new, device=dev)
    pack.icp_w = torch.as_tensor(w_new, device=dev)


@dataclass
class JointBAResult:
    state: dict
    costs: List[float]
    iterations: int
    rows: int


def run_joint_ba(pack, max_iterations: int = 10, lam0: float = 1.0,
                 convergence_threshold: float = 1e-7, current_scale: float = 0.0,
                 print_progress: bool = False, refresh_visibility_every: int = 1,
                 icp_refresh_fn=None, iterations_without_optimum: int = 15,
                 system=None, state: Optional[dict] = None, on_iteration=None,
                 apply_fn=None, timer: Optional[StageTimer] = None) -> JointBAResult:
    """LM accept/reject loop over the joint system.

    Per outer iteration: refresh visibility, then up to 10 damped tries —
    solve at lambda, apply exp(-delta), evaluate the frozen-visibility cost,
    accept iff it decreases (halve lambda) else double; the 10th try is
    force-applied. The best state across iterations is tracked and returned,
    and the loop stops after ``iterations_without_optimum`` iterations
    without a new optimum. ``timer`` times a new system's passes and the
    ICP refresh and the host update as stages ``joint_ba.<name>``."""
    if system is None:
        system = JointBASystem(pack, current_scale, timer)
    if state is None:
        state = make_state(pack)
    if apply_fn is None:
        apply_fn = apply_delta
    lam = lam0
    vis, obs_scale = system.visibility(state)
    cost, count = system.cost(state, vis, obs_scale)
    cost = float(cost)
    K = int(pack.scene_neighbors.shape[-1])

    def row_count(cnt):
        return int(cnt) * K + 2 * pack.n_icp

    rows = row_count(count)
    costs = [cost]
    best_cost, best_state = cost, state
    since_optimum = 0
    it_done = 0
    x_keep = x_img = None
    for it in range(max_iterations):
        if it > 0 and icp_refresh_fn is not None:
            with _stage(timer, "joint_ba.icp_refresh"):
                icp_refresh_fn(pack, state)
            cost = float(system.cost(state, vis, obs_scale)[0])
        if it > 0 and refresh_visibility_every and it % refresh_visibility_every == 0:
            vis, obs_scale = system.visibility(state)
            c, cnt = system.cost(state, vis, obs_scale)
            cost = float(c)
            rows = row_count(cnt)
        applied = False
        for try_i in range(10):
            x_keep, x_img, _, _ = system.step(state, vis, obs_scale, lam)
            with _stage(timer, "joint_ba.apply"):
                cand = apply_fn(pack, state, x_keep, x_img)
            new_cost = float(system.cost(cand, vis, obs_scale)[0])
            if new_cost < cost or try_i == 9:
                state = cand
                cost = new_cost
                lam = max(lam * 0.5, 1e-10)
                applied = True
                break
            lam *= 2.0
        costs.append(cost)
        it_done = it + 1
        if cost < best_cost:
            best_cost, best_state = cost, state
            since_optimum = 0
        else:
            since_optimum += 1
        if print_progress:
            print(f"  joint BA iter {it}: cost {cost:.6f} lam {lam:.2e}")
        if on_iteration is not None:
            on_iteration(it, state, cost)
        if not applied or since_optimum >= iterations_without_optimum:
            break
        step_norm = (float(torch.linalg.norm(x_keep.double()))
                     + float(torch.linalg.norm(x_img.double())))
        if step_norm < convergence_threshold:
            break
    return JointBAResult(state=best_state, costs=costs, iterations=it_done, rows=rows)
