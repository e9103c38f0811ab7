"""Rig-capable joint multi-scene BA: frames as the Schur-eliminated unit.

Port of ``dataset_pipeline_tpu/parallel/joint_ba_rig.py``. It generalizes
``parallel/joint_ba.py`` to the full variable set:

- **several camera groups**: one intrinsics block per rig slot;
- **rig extrinsics**: 6-dof kept blocks per non-reference rig camera, the
  image pose being ``exp(e_extr) . extr . exp(e_ref) . ref``;
- **inverse-depth residuals** for reference-slot images.

The unit of elimination is the frame: every rig image of a frame shares the
frame's 6-dof reference pose, and frames are what a mesh shards (padding
frames have no slot present). Everything else (block-sparse Hkk / Hki /
Hii, the damped reduced system summed over the mesh, back-substitution and
the gathered steps) is ``joint_ba.py``'s. A slot absent from a frame is
skipped (the JAX package evaluates it on zero images and multiplies the
result by 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from dataset_pipeline_tpu_torch.icp.moments import quat_mul_np, se3_exp_np
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import (
    SE3,
    quat_rotate,
    quat_rotate_fused,
    quat_to_matrix_np,
)
from dataset_pipeline_tpu_torch.ops.hb_geometry import forward_jacobian, project_full
from dataset_pipeline_tpu_torch.ops.hb_gram import gram, inverse_depths
from dataset_pipeline_tpu_torch.ops.pyramid_sample import flatten_pyramid, pair_rows, pyramid_sample
from dataset_pipeline_tpu_torch.ops.robust import DEFAULT_DEPTH_TUKEY, tukey_rho, tukey_weight
from dataset_pipeline_tpu_torch.parallel.joint_ba import (
    _apply_pose_deltas,
    _apply_scan_deltas,
    _chain,
    _corrected_points,
    _cost_one_image,
    _damped_schur,
    _free_scan_columns,
    _identity_corrections,
    _icp_local,
    _identity_poses,
    _image_gram,
    _intensity_derivs,
    _pad_images,
    _pool_icp,
    _scan_rows,
    _scene_geometry,
    _stage,
    _vis_one_image,
    run_joint_ba,
)
from dataset_pipeline_tpu_torch.parallel.mesh import Mesh, as_mesh, padded_rows, shard_range
from dataset_pipeline_tpu_torch.utils.timing import StageTimer


@dataclass
class RigJointPack:
    """Device-resident rig joint problem: the scene geometry as in
    ``JointBAPack``, and per frame the per-slot pyramids."""

    device: torch.device
    mesh: Mesh
    cameras: List[cm.Camera]  # per rig slot, slot 0 = reference
    n_cams: int
    n_scenes: int
    n_frames: int  # real frame count
    f_pad: int  # padded to a multiple of the mesh size
    s_max: int
    n_int: int  # total optimized intrinsics params
    p_off: List[int]  # kept offset of slot c's params
    p_len: List[int]
    n_free: int
    scale_count: int
    occl_downscale: int
    depth_weight: float
    scene_points: torch.Tensor
    scene_scan_idx: torch.Tensor
    scene_neighbors: torch.Tensor
    scene_desc: torch.Tensor
    scene_valid: torch.Tensor
    scene_radius: torch.Tensor
    scan_col: torch.Tensor
    # per-slot expansion maps [P_c | 6 extr (c > 0) | 6*s_max scans] -> n_keep,
    # indexed by scene: (n_scenes, dk_c, n_keep)
    expand_c: List[torch.Tensor]
    frame_scene: torch.Tensor  # (f_pad,) int64
    frame_valid: torch.Tensor  # (f_pad,) bool
    present: torch.Tensor  # (f_pad, n_cams) bool
    ref_q0: torch.Tensor  # (f_pad, 4)
    ref_t0: torch.Tensor
    pyramids: List[torch.Tensor]  # per level (f_pad, n_cams, H_l, W_l)
    depth_pyramids: Optional[List[torch.Tensor]]  # per level (f_pad, H_l, W_l)
    extr_q0: torch.Tensor  # (n_cams, 4)
    extr_t0: torch.Tensor  # (n_cams, 3)
    icp_ps: torch.Tensor
    icp_ns: torch.Tensor
    icp_pt: torch.Tensor
    icp_nt: torch.Tensor
    icp_w: torch.Tensor
    icp_scene: torch.Tensor
    icp_src_s: torch.Tensor
    icp_tgt_s: torch.Tensor
    scan_col_np: np.ndarray
    frame_scene_np: np.ndarray
    present_np: np.ndarray
    occlusion_radius: float
    occlusion_depth_threshold: float
    n_icp: int
    icp_w0_np: Optional[np.ndarray] = None

    @property
    def n_extr(self) -> int:
        return 6 * (self.n_cams - 1)

    @property
    def extr_off(self) -> int:
        return self.n_int

    @property
    def scan_off(self) -> int:
        return self.n_int + self.n_extr

    @property
    def n_keep(self) -> int:
        return self.n_int + self.n_extr + 6 * self.n_free

    def dk(self, c: int) -> int:
        """Kept-column count of slot c's compact Jacobian."""
        return self.p_len[c] + (6 if c > 0 else 0) + 6 * self.s_max


def make_rig_state(pack: RigJointPack) -> dict:
    """Initial state: per-slot intrinsics, the rig extrinsics, identity
    per-scan corrections, the frames' reference poses."""
    corr_q, corr_t = _identity_corrections(pack.n_scenes, pack.s_max, pack.device)
    return {"params": tuple(cam.params.to(torch.float32) for cam in pack.cameras),
            "extr_q": pack.extr_q0, "extr_t": pack.extr_t0, "corr_q": corr_q, "corr_t": corr_t,
            "pose_q": pack.ref_q0, "pose_t": pack.ref_t0}


def pack_rig_scenes(mesh, scenes, optimize_intrinsics: bool = True, occl_downscale: int = 2,
                    occlusion_radius: float = 0.03, occlusion_depth_threshold: float = 0.01,
                    depth_weight: float = 0.0, all_levels: bool = True) -> RigJointPack:
    """Pack ``JointScene``s whose problems carry a rig for ``mesh`` (a
    ``Mesh``, or a device, the card unless named, for one rank), the frames
    and ICP rows padded to a multiple of the mesh size: each problem's
    groups are the rig slots (ordered by ``rig_cam_index``; group 0's images
    define the frames). All scenes share the rig (per-slot cameras and
    extrinsics)."""
    mesh = as_mesh(mesh)
    device = mesh.device
    probs = [sc.problem for sc in scenes]
    groups0 = sorted(probs[0].groups, key=lambda g: g.rig_cam_index)
    n_cams = len(groups0)
    cams = [g.camera.to(device) for g in groups0]
    if probs[0].rig_extrinsics:
        extr = probs[0].rig_extrinsics[0]
        extr_q0, extr_t0 = (x.to(device, torch.float32) for x in (extr.q, extr.t))
    else:
        extr_q0, extr_t0 = (x[0] for x in _identity_corrections(1, n_cams, device))

    p_len = [(int(c.params.shape[0]) if optimize_intrinsics else 0) for c in cams]
    p_off = [int(v) for v in np.concatenate([[0], np.cumsum(p_len)[:-1]])]
    n_int = int(sum(p_len))
    n_scenes = len(scenes)
    s_max = max(sc.num_scans for sc in scenes)
    scan_col = _free_scan_columns(scenes, s_max)
    n_free = int((scan_col >= 0).sum())
    n_keep = n_int + 6 * (n_cams - 1) + 6 * n_free

    expand_c = []
    for c in range(n_cams):
        E = np.zeros((n_scenes, p_len[c] + (6 if c > 0 else 0) + 6 * s_max, n_keep), np.float32)
        for si in range(n_scenes):
            off = 0
            if p_len[c]:
                E[si, off:off + p_len[c], p_off[c]:p_off[c] + p_len[c]] = np.eye(p_len[c])
                off += p_len[c]
            if c > 0:
                eo = n_int + 6 * (c - 1)
                E[si, off:off + 6, eo:eo + 6] = np.eye(6)
                off += 6
            for s in range(s_max):
                if scan_col[si, s] >= 0:
                    so = n_int + 6 * (n_cams - 1) + 6 * scan_col[si, s]
                    E[si, off + 6 * s:off + 6 * s + 6, so:so + 6] = np.eye(6)
        expand_c.append(torch.as_tensor(E, device=device))
    sp, ss, sn, sd, sv, sr = _scene_geometry(scenes, all_levels)

    # frames: reference-slot images, scene-major; the dependent slots attach
    # through their groups' ref_slots
    frame_scene, ref_q, ref_t, present_rows = [], [], [], []
    pyr_levels = depth_levels = None
    for si, sc in enumerate(scenes):
        gs = sorted(sc.problem.groups, key=lambda g: g.rig_cam_index)
        g0 = gs[0]
        nf = g0.num_images
        if pyr_levels is None:
            pyr_levels = [[] for _ in g0.pyramid]
            if depth_weight > 0 and sc.problem.depth_map_pyramids is not None:
                depth_levels = [[] for _ in g0.pyramid]
        pres = np.zeros((nf, n_cams), bool)
        pres[:, 0] = True
        for g in gs[1:]:
            pres[np.asarray(g.ref_slots), g.rig_cam_index] = True
        for li in range(len(g0.pyramid)):
            H_l, W_l = g0.pyramid[li].shape[-2:]
            lvl = torch.zeros((nf, n_cams, H_l, W_l), dtype=torch.float32, device=device)
            lvl[:, 0] = g0.pyramid[li].to(device)
            for g in gs[1:]:
                slots = torch.as_tensor(np.asarray(g.ref_slots, np.int64), device=device)
                lvl[slots, g.rig_cam_index] = g.pyramid[li].to(device)
            pyr_levels[li].append(lvl)
            if depth_levels is not None:
                depth_levels[li].append(sc.problem.depth_map_pyramids[0][li].to(device,
                                                                               torch.float32))
        present_rows.append(pres)
        frame_scene += [si] * nf
        ref_q.append(g0.poses.q.to(device, torch.float32))
        ref_t.append(g0.poses.t.to(device, torch.float32))
    f = len(frame_scene)
    f_pad = padded_rows(f, mesh)
    frame_scene_np = np.asarray(frame_scene + [0] * (f_pad - f), np.int64)
    present = np.concatenate(present_rows + [np.zeros((f_pad - f, n_cams), bool)], 0)
    icp, M = _pool_icp(scenes, mesh.size)
    ref_q0, ref_t0 = _identity_poses(torch.cat(ref_q), torch.cat(ref_t), f_pad)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return RigJointPack(
        device=device, mesh=mesh, cameras=cams, n_cams=n_cams, n_scenes=n_scenes, n_frames=f,
        f_pad=f_pad,
        s_max=s_max, n_int=n_int, p_off=p_off, p_len=p_len, n_free=n_free,
        scale_count=len(pyr_levels), occl_downscale=occl_downscale, depth_weight=depth_weight,
        scene_points=dev(sp), scene_scan_idx=dev(ss), scene_neighbors=dev(sn),
        scene_desc=dev(sd), scene_valid=dev(sv), scene_radius=dev(sr),
        scan_col=dev(scan_col.astype(np.int64)), expand_c=expand_c,
        frame_scene=dev(frame_scene_np), frame_valid=torch.arange(f_pad, device=device) < f,
        present=dev(present), ref_q0=ref_q0, ref_t0=ref_t0,
        pyramids=[_pad_images(torch.cat(lvls), f_pad) for lvls in pyr_levels],
        depth_pyramids=None if depth_levels is None else [_pad_images(torch.cat(l), f_pad)
                                                          for l in depth_levels],
        extr_q0=extr_q0, extr_t0=extr_t0,
        icp_ps=dev(icp["ps"]), icp_ns=dev(icp["ns"]), icp_pt=dev(icp["pt"]),
        icp_nt=dev(icp["nt"]), icp_w=dev(icp["w"]), icp_scene=dev(icp["scene"]),
        icp_src_s=dev(icp["src"]), icp_tgt_s=dev(icp["tgt"]),
        scan_col_np=scan_col, frame_scene_np=frame_scene_np, present_np=present,
        occlusion_radius=occlusion_radius, occlusion_depth_threshold=occlusion_depth_threshold,
        n_icp=M, icp_w0_np=icp["w"].copy())


# ---------------------------------------------------------------------------
# Per-(frame, slot) device passes
# ---------------------------------------------------------------------------


def _slot_pose(extr_q, extr_t, ref_q, ref_t, c: int) -> SE3:
    if c == 0:
        return SE3(ref_q, ref_t)
    return SE3(extr_q[c], extr_t[c]).compose(SE3(ref_q, ref_t))


def _slot_pose_fused(extr_q, extr_t, ref_q, ref_t, c: int) -> SE3:
    """:func:`_slot_pose` as XLA compiles it inside ``jit`` (multiply-adds
    contracted): the visibility's footprint difference magnifies an ulp of
    the pose ~1e4-fold."""
    if c == 0:
        return SE3(ref_q, ref_t)
    a, b = extr_q[c], ref_q
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    fma = torch.addcmul
    q = torch.stack([
        fma(fma(fma(aw * bw, -ax, bx), -ay, by), -az, bz),
        fma(fma(fma(aw * bx, ax, bw), ay, bz), -az, by),
        fma(fma(fma(aw * by, -ax, bz), ay, bw), az, bx),
        fma(fma(fma(aw * bz, ax, by), -ay, bx), az, bw)], -1)
    norm = torch.sqrt(fma(fma(fma(q[0] * q[0], q[1], q[1]), q[2], q[2]), q[3], q[3]))
    return SE3(q / norm, quat_rotate_fused(a, ref_t) + extr_t[c])


def _vis_one(pack: RigJointPack, c: int, params_c, corr_q, corr_t, extr_q, extr_t, ref_q, ref_t,
             si: int, current_scale):
    """Visibility + frozen footprint observation scale for slot ``c`` of a
    frame (the gates of ``joint_ba._vis_one_image``)."""
    pose = _slot_pose_fused(extr_q, extr_t, ref_q, ref_t, c)
    return _vis_one_image(pack, params_c, corr_q, corr_t, pose.q, pose.t, si, current_scale,
                          camera=pack.cameras[c])


def _rows_one(pack: RigJointPack, c: int, params_c, corr_q, corr_t, extr_q, extr_t, ref_q, ref_t,
              si: int, flat, layout, pairs, vis, obs_scale):
    """Compact per-(frame, slot) Gram: J columns
    [P_c | 6 extr (c > 0) | 6*s_max scans | 6 ref]."""
    cam = pack.cameras[c]
    pts = _corrected_points(pack, corr_q, corr_t, si)
    extr0 = SE3(extr_q[c], extr_t[c])
    ref0 = SE3(ref_q, ref_t)

    def geom(eps_e, eps_r, prm):
        ref = SE3.exp(eps_r).compose(ref0)
        pose = SE3.exp(eps_e).compose(extr0).compose(ref) if c > 0 else ref
        return project_full(cam, prm, pose.apply(pts))[0]

    pose0 = _slot_pose(extr_q, extr_t, ref_q, ref_t, c)
    p_cam0 = pose0.apply(pts)
    pix, valid, inten, dpx, dpy, okS = _intensity_derivs(cam, params_c, p_cam0, flat, layout,
                                                         pairs, obs_scale)
    ok = valid & okS

    P = params_c.shape[0]
    z6 = torch.zeros(6, dtype=torch.float32, device=pts.device)
    keep = ([*range(P)] if pack.p_len[c] else []) + ([*range(P, P + 6)] if c > 0 else []) + [
        *range(P + 6, P + 12)]
    basis = torch.eye(P + 12, dtype=torch.float32, device=pts.device)[keep]
    J_per = forward_jacobian(geom, (z6, z6, params_c),
                              lambda t: (t[P:P + 6], t[P + 6:], t[:P]), basis, _chain(dpx, dpy),
                              pts.shape[0])
    rows_scan = _scan_rows(pack, cam, params_c, pose0, p_cam0, pts, si, dpx, dpy)
    J = torch.cat([J_per[:, :-6], rows_scan, J_per[:, -6:]], -1)  # the reference pose last
    return _image_gram(J, inten, ok, pack.scene_neighbors[si], pack.scene_desc[si],
                       vis & pack.scene_valid[si])


def _depth_rows_one(pack: RigJointPack, params0, corr_q, corr_t, ref_q, ref_t, si: int, flat,
                    layout, pairs, vis, obs_scale):
    """Inverse-depth rows for the reference slot of a frame (Tukey), in the
    compact layout of ``_rows_one`` with c = 0: (G, g, cost, count)."""
    cam = pack.cameras[0]
    pts = _corrected_points(pack, corr_q, corr_t, si)
    ref0 = SE3(ref_q, ref_t)
    scan = pack.scene_scan_idx[si]
    S = pack.s_max

    def geom(eps_r, eps_s, prm):
        corr = SE3.exp(eps_s)
        p_cam = SE3.exp(eps_r).compose(ref0).apply(quat_rotate(corr.q[scan], pts) + corr.t[scan])
        pix, _ = project_full(cam, prm, p_cam)
        return pix, p_cam[:, 2]

    dev = pts.device
    z6 = torch.zeros(6, dtype=torch.float32, device=dev)
    zs = torch.zeros((S, 6), dtype=torch.float32, device=dev)
    pix, z = geom(z6, zs, params0)
    _, valid = project_full(cam, params0, ref0.apply(pts))
    D, dDx, dDy, _, okD = pyramid_sample(flat, layout, pix[None].contiguous(),
                                         obs_scale[None].contiguous(), with_derivs=True,
                                         pairs=pairs)
    D, dDx, dDy, okD = D[0], dDx[0], dDy[0], okD[0]
    inv_D, inv_z, safe_z = inverse_depths(D, z)
    r0 = inv_D - inv_z
    rho = tukey_rho(r0, DEFAULT_DEPTH_TUKEY)
    w = tukey_weight(r0, DEFAULT_DEPTH_TUKEY)
    ok = valid & okD & (D > 0) & vis & pack.scene_valid[si]
    wfull = torch.where(ok, w, torch.zeros_like(w))
    dD_coef = -torch.where(D > 0, 1.0 / torch.clamp(D * D, min=1e-18), torch.zeros_like(D))
    dz_coef = torch.where(z != 0, 1.0 / (safe_z * safe_z), torch.zeros_like(z))

    def combine(dout):
        dpix, dz = dout
        return dD_coef * (dDx * dpix[..., 0] + dDy * dpix[..., 1]) + dz_coef * dz

    P = params0.shape[0]
    keep = ([*range(P)] if pack.p_len[0] else []) + [*range(P, P + 6 * S + 6)]
    basis = torch.eye(P + 6 * S + 6, dtype=torch.float32, device=dev)[keep]
    rows = forward_jacobian(geom, (z6, zs, params0),
                             lambda t: (t[P + 6 * S:], t[P:P + 6 * S].reshape(S, 6), t[:P]),
                             basis, combine, pts.shape[0])  # [P | scans | ref]
    rows = torch.where(ok[:, None], rows, torch.zeros_like(rows))
    sw = torch.sqrt(wfull)
    rows_w = rows * sw[:, None]
    r_w = torch.where(ok, r0, torch.zeros_like(r0)) * sw
    # the Gram accumulated in float64 and rounded, as the photometric ones (_image_gram)
    G = gram(rows_w[None].double(), rows_w[None].double())[0].float()
    g = torch.sum(rows_w * r_w[:, None], 0)
    return G, g, torch.sum(torch.where(ok, rho, torch.zeros_like(rho))), torch.sum(ok)


def _cost_one(pack: RigJointPack, c: int, params_c, corr_q, corr_t, extr_q, extr_t, ref_q, ref_t,
              si: int, flat, layout, pairs, vis, obs_scale):
    pose = _slot_pose(extr_q, extr_t, ref_q, ref_t, c)
    return _cost_one_image(pack, params_c, corr_q, corr_t, pose.q, pose.t, si, flat, layout,
                           pairs, vis, obs_scale, camera=pack.cameras[c])


def _depth_cost_one(pack: RigJointPack, params0, corr_q, corr_t, ref_q, ref_t, si: int, flat,
                    layout, pairs, vis, obs_scale):
    cam = pack.cameras[0]
    pts = _corrected_points(pack, corr_q, corr_t, si)
    p_cam = SE3(ref_q, ref_t).apply(pts)
    z = p_cam[:, 2]
    pix, valid = project_full(cam, params0, p_cam)
    D, okD = pyramid_sample(flat, layout, pix[None].contiguous(), obs_scale[None].contiguous(),
                            with_derivs=False, pairs=pairs)
    D, okD = D[0], okD[0]
    ok = valid & okD & (D > 0) & vis & pack.scene_valid[si]
    inv_D, inv_z, _ = inverse_depths(D, z)
    rho = tukey_rho(inv_D - inv_z, DEFAULT_DEPTH_TUKEY)
    return torch.sum(torch.where(ok, rho, torch.zeros_like(rho))), torch.sum(ok)


def _flat_and_pairs(levels):
    """A stack of pyramids (per level (n, H_l, W_l)) as the flat copy and, on
    the card, its row-paired copy."""
    flat, layout = flatten_pyramid(levels)
    return flat, layout, pair_rows(flat, layout) if flat.is_cuda else None


class RigJointBASystem:
    """The rig passes over a fixed pack, each rank on its frames and ICP
    rows; the interface of ``JointBASystem`` (visibility / step / cost), so
    ``run_joint_ba`` drives it unchanged."""

    def __init__(self, pack: RigJointPack, current_scale: float = 0.0,
                 timer: Optional[StageTimer] = None):
        self.pack = pack
        self.mesh = pack.mesh
        self.current_scale = float(current_scale)
        self.timer = timer
        self.frames = range(pack.f_pad)[shard_range(pack.mesh, pack.f_pad)]
        self.icp_rows = shard_range(pack.mesh, pack.icp_w.shape[0])
        own = slice(self.frames.start, self.frames.stop)
        n = len(self.frames) * pack.n_cams
        self.flat, self.layout, self.pairs = _flat_and_pairs(
            [p[own].reshape((n,) + tuple(p.shape[2:])) for p in pack.pyramids])
        self.has_depth = pack.depth_pyramids is not None and pack.depth_weight > 0
        if self.has_depth:
            self.dflat, self.dlayout, self.dpairs = _flat_and_pairs(
                [p[own] for p in pack.depth_pyramids])

    def _image(self, j: int, c: int):
        """The flat pyramid of slot ``c`` of this rank's ``j``-th frame."""
        k = j * self.pack.n_cams + c
        return (self.flat[k:k + 1], self.layout,
                None if self.pairs is None else self.pairs[k:k + 1])

    def _depth(self, j: int):
        return (self.dflat[j:j + 1], self.dlayout,
                None if self.dpairs is None else self.dpairs[j:j + 1])

    def _slots(self, i: int):
        return [c for c in range(self.pack.n_cams) if self.pack.present_np[i, c]]

    def visibility(self, state):
        """(vis, obs_scale), (f_local, n_cams, N_max) each, for this rank's
        frames."""
        p = self.pack
        with _stage(self.timer, "joint_ba.visibility"):
            vis, scales = [], []
            for i in self.frames:
                vs, ss = [], []
                for c in range(p.n_cams):
                    v, s = _vis_one(p, c, state["params"][c], state["corr_q"], state["corr_t"],
                                    state["extr_q"], state["extr_t"], state["pose_q"][i],
                                    state["pose_t"][i], int(p.frame_scene_np[i]),
                                    self.current_scale)
                    vs.append(v & p.frame_valid[i] & p.present[i, c])
                    ss.append(s)
                vis.append(torch.stack(vs))
                scales.append(torch.stack(ss))
            return torch.stack(vis), torch.stack(scales)

    def normal_equations(self, state, vis, obs_scale):
        """This rank's block-sparse pieces of H, b per frame: (Hkk, bk, Hki
        (f_local,k,6), Hii (f_local,6,6), bi (f_local,6), cost, count), its ICP
        rows folded into Hkk / bk; not summed over the mesh."""
        p = self.pack
        n_keep, dev = p.n_keep, p.device
        Hkk = torch.zeros((n_keep, n_keep), device=dev)
        bk = torch.zeros((n_keep,), device=dev)
        cost = torch.zeros((), device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        Hki, Hii, bi = [], [], []
        for j, i in enumerate(self.frames):
            si = int(p.frame_scene_np[i])
            kk = torch.zeros((n_keep, n_keep), device=dev)
            ki = torch.zeros((n_keep, 6), device=dev)
            ii = torch.zeros((6, 6), device=dev)
            bkk = torch.zeros((n_keep,), device=dev)
            bii = torch.zeros((6,), device=dev)
            c_f = torch.zeros((), device=dev)
            for c in self._slots(i):
                G, g, c_i, n_i = _rows_one(p, c, state["params"][c], state["corr_q"],
                                           state["corr_t"], state["extr_q"], state["extr_t"],
                                           state["pose_q"][i], state["pose_t"][i], si,
                                           *self._image(j, c), vis[j, c], obs_scale[j, c])
                dk = p.dk(c)
                E = p.expand_c[c][si]
                kk = kk + E.T @ (G[:dk, :dk] @ E)
                ki = ki + E.T @ G[:dk, dk:]
                ii = ii + G[dk:, dk:]
                bkk = bkk + E.T @ g[:dk]
                bii = bii + g[dk:]
                c_f = c_f + c_i
                count = count + n_i
            if self.has_depth and p.present_np[i, 0]:
                Gd, gd, cd, _ = _depth_rows_one(p, state["params"][0], state["corr_q"],
                                                state["corr_t"], state["pose_q"][i],
                                                state["pose_t"][i], si, *self._depth(j),
                                                vis[j, 0], obs_scale[j, 0])
                w = p.depth_weight
                dk0 = p.p_len[0] + 6 * p.s_max
                E0 = p.expand_c[0][si]  # slot 0 has no extrinsics columns
                kk = kk + w * (E0.T @ (Gd[:dk0, :dk0] @ E0))
                ki = ki + w * (E0.T @ Gd[:dk0, dk0:])
                ii = ii + w * Gd[dk0:, dk0:]
                bkk = bkk + w * (E0.T @ gd[:dk0])
                bii = bii + w * gd[dk0:]
                c_f = c_f + w * cd
            Hkk = Hkk + kk
            bk = bk + bkk
            cost = cost + c_f
            Hki.append(ki)
            Hii.append(ii)
            bi.append(bii)
        Hs, bs, c_icp = _icp_local(p, state["corr_q"], state["corr_t"], self.icp_rows)
        so = p.scan_off
        if p.n_free > 0:
            Hkk = Hkk.clone()
            Hkk[so:, so:] += Hs
            bk = bk.clone()
            bk[so:] += bs
        return Hkk, bk, torch.stack(Hki), torch.stack(Hii), torch.stack(bi), cost + c_icp, count

    def step(self, state, vis, obs_scale, lam: float):
        p = self.pack
        with _stage(self.timer, "joint_ba.step"):
            Hkk, bk, Hki, Hii, bi, cost, count = self.normal_equations(state, vis, obs_scale)
            x_keep, x_img = _damped_schur(Hkk, bk, Hki, Hii, bi,
                                          p.frame_valid[self.frames.start:self.frames.stop], lam,
                                          self.mesh)
            return x_keep, x_img, self.mesh.all_reduce(cost), self.mesh.all_reduce(count)

    def cost(self, state, vis, obs_scale):
        p = self.pack
        with _stage(self.timer, "joint_ba.cost"):
            costs, counts = [], []
            for j, i in enumerate(self.frames):
                si = int(p.frame_scene_np[i])
                c_f = torch.zeros((), device=p.device)
                n_f = torch.zeros((), dtype=torch.int64, device=p.device)
                for c in self._slots(i):
                    cc, nn = _cost_one(p, c, state["params"][c], state["corr_q"], state["corr_t"],
                                       state["extr_q"], state["extr_t"], state["pose_q"][i],
                                       state["pose_t"][i], si, *self._image(j, c), vis[j, c],
                                       obs_scale[j, c])
                    c_f = c_f + cc
                    n_f = n_f + nn
                if self.has_depth and p.present_np[i, 0]:
                    cd, _ = _depth_cost_one(p, state["params"][0], state["corr_q"],
                                            state["corr_t"], state["pose_q"][i],
                                            state["pose_t"][i], si, *self._depth(j), vis[j, 0],
                                            obs_scale[j, 0])
                    c_f = c_f + p.depth_weight * cd
                costs.append(c_f)
                counts.append(n_f)
            _, _, c_icp = _icp_local(p, state["corr_q"], state["corr_t"], self.icp_rows)
            return (self.mesh.all_reduce(torch.sum(torch.stack(costs)) + c_icp),
                    self.mesh.all_reduce(torch.sum(torch.stack(counts))))


def apply_rig_delta(pack: RigJointPack, state, x_keep, x_img):
    """Apply a solved step with the exp(-delta) convention to intrinsics,
    rig extrinsics, scan corrections and reference poses."""
    x_keep = np.asarray(torch.as_tensor(x_keep).double().cpu(), np.float64)
    x_img = np.asarray(torch.as_tensor(x_img).double().cpu(), np.float64)
    new = dict(state)
    params = list(state["params"])
    for c in range(pack.n_cams):
        if pack.p_len[c]:
            o = pack.p_off[c]
            params[c] = state["params"][c] - torch.as_tensor(
                x_keep[o:o + pack.p_len[c]], dtype=torch.float32, device=params[c].device)
    new["params"] = tuple(params)

    extr_q = state["extr_q"].double().cpu().numpy()
    extr_t = state["extr_t"].double().cpu().numpy()
    for c in range(1, pack.n_cams):
        o = pack.extr_off + 6 * (c - 1)
        dq, dt = se3_exp_np(-x_keep[o:o + 6])
        extr_t[c] = quat_to_matrix_np(dq) @ extr_t[c] + dt
        qn = quat_mul_np(dq, extr_q[c])
        extr_q[c] = qn / np.linalg.norm(qn)
    dev = state["extr_q"].device
    new["extr_q"] = torch.as_tensor(extr_q, dtype=torch.float32, device=dev)
    new["extr_t"] = torch.as_tensor(extr_t, dtype=torch.float32, device=dev)
    new["corr_q"], new["corr_t"] = _apply_scan_deltas(pack, state, x_keep, pack.scan_off)
    new["pose_q"], new["pose_t"] = _apply_pose_deltas(state, x_img)
    return new


def run_rig_joint_ba(pack: RigJointPack, **kw):
    """The LM loop over the rig system (``run_joint_ba``'s loop)."""
    system = RigJointBASystem(pack, kw.pop("current_scale", 0.0), kw.get("timer"))
    return run_joint_ba(pack, system=system, state=make_rig_state(pack),
                        apply_fn=apply_rig_delta, **kw)
