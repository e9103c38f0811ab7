"""Joint scan+image bundle adjustment with Schur elimination: the dense twin.

Port of ``dataset_pipeline_tpu/parallel/ba.py``. Variables are a small kept
block (shared intrinsics + free scan poses) and one 6-dof block per image;
no residual touches two images, so the per-image 6x6 diagonal blocks are
eliminated (the reduced camera system with images in the role of points)
and the small reduced system is solved.

This module is the validation twin of the production system
(``parallel/joint_ba.py``): rows are materialized densely on the host, one
row per descriptor component or ICP correspondence. Each rank of a mesh
(``parallel/mesh.py``) accumulates H, b over its shard of the rows and the
three results are summed over the mesh (JAX: ``psum``); a bare device is a
one-rank mesh.

Every contraction runs in strict fp32: the Schur complement cancels
catastrophically, and the package keeps TF32 off.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from dataset_pipeline_tpu_torch.models.lie import SE3, quat_rotate
from dataset_pipeline_tpu_torch.ops.hb_geometry import forward_jacobian, project_full
from dataset_pipeline_tpu_torch.ops.pyramid_sample import flatten_pyramid, pyramid_sample
from dataset_pipeline_tpu_torch.ops.robust import DEFAULT_COLOR_HUBER, huber_weight
from dataset_pipeline_tpu_torch.parallel.mesh import as_mesh


def schur_eliminate_images(H, b, n_keep: int, num_images: int, lam=0.0):
    """Eliminate the trailing per-image 6x6 blocks from the damped system.

    H: (n_keep + 6m, n_keep + 6m), b matching. Returns (S, rhs, back) where
    ``back(x_keep) -> x_images (m,6)`` completes the solution."""
    m = num_images
    Hkk, Hki, Hii = H[:n_keep, :n_keep], H[:n_keep, n_keep:], H[n_keep:, n_keep:]
    bk, bi = b[:n_keep], b[n_keep:]
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    blocks = torch.stack([Hii[6 * i:6 * i + 6, 6 * i:6 * i + 6] for i in range(m)])
    # the _ex form returns inf/NaN for a singular block (as jnp.linalg.inv)
    # instead of raising, and syncs nothing on the card
    inv_blocks = torch.linalg.inv_ex(blocks + lam * eye6[None])[0]
    Hki_b = Hki.reshape(n_keep, m, 6)
    W = torch.einsum("kmi,mij->kmj", Hki_b, inv_blocks)
    S = Hkk + lam * torch.eye(n_keep, dtype=H.dtype, device=H.device) - torch.einsum(
        "kmi,nmi->kn", W, Hki_b)
    rhs = bk - torch.einsum("kmi,mi->k", W, bi.reshape(m, 6))

    def back(x_keep):
        r = bi.reshape(m, 6) - torch.einsum("kmi,k->mi", Hki_b, x_keep)
        return torch.einsum("mij,mj->mi", inv_blocks, r)

    return S, rhs, back


def make_sharded_hb(mesh, row_fn: Callable, n_vars: int):
    """H, b accumulator over residual rows sharded over ``mesh`` (a
    ``Mesh``, or a device for a one-rank mesh).

    ``row_fn(*inputs) -> (rows (R, n_vars), r (R,), w (R,))`` is evaluated on
    this rank's shard of the inputs (``mesh.shard_rows``); returns a function
    of the shard producing the replicated (H (n_vars, n_vars), b (n_vars,),
    cost), each summed over the mesh."""
    mesh = as_mesh(mesh)

    def hb(*inputs):
        rows, r, w = row_fn(*(x.to(mesh.device) for x in inputs))
        sw = torch.sqrt(w)[:, None]
        rows_w = rows * sw
        r_w = r * sw[:, 0]
        H = rows_w.T @ rows_w
        b = torch.sum(rows_w * r_w[:, None], 0)
        return mesh.all_reduce(H), mesh.all_reduce(b), mesh.all_reduce(torch.sum(r_w * r_w))

    return hb


# ---------------------------------------------------------------------------
# Residual-row producers: [shared intrinsics | 6 per free scan | 6 per image]
# ---------------------------------------------------------------------------


def photometric_row_blocks(camera, params, pose_q, pose_t, points, scan_idx, neighbors, desc,
                           image_pyr, obs_scale, contrib_mask, optimize_intrinsics: bool,
                           num_scans: int):
    """Materialized descriptor-residual rows for ONE image on one level.

    ``points`` are scan-local-in-global positions; each point moves with its
    scan's left-multiplicative correction ``exp(eps_scan[s])``. Returns the
    per-block row pieces of the N*K descriptor components: (rows_int (NK,P)
    or None, rows_scan (NK, 6*num_scans), rows_img (NK,6), r (NK,), w (NK,)),
    the weights robust (Huber) and invalid components zeroed.

    The JAX twin takes ``jacfwd`` of the sampled intensity; here the sampler
    gives dI/dpix analytically and forward mode differentiates the
    gather-free projection (the same chain, as in ``photometric/optimizer``)."""
    S = num_scans
    pose0 = SE3(pose_q, pose_t)
    dev = points.device

    def geom(eps_img, eps_scan, prm):
        pose = SE3.exp(eps_img).compose(pose0)
        corr = SE3.exp(eps_scan)
        pts = quat_rotate(corr.q[scan_idx], points) + corr.t[scan_idx]
        return project_full(camera, prm, pose.apply(pts))

    z_img = torch.zeros(6, dtype=torch.float32, device=dev)
    z_scan = torch.zeros((S, 6), dtype=torch.float32, device=dev)
    pix, valid = geom(z_img, z_scan, params)
    flat, layout = flatten_pyramid([p[None] for p in image_pyr])
    inten, dpx, dpy, _, okS = pyramid_sample(flat, layout, pix[None].contiguous(),
                                             obs_scale[None].contiguous(), with_derivs=True)
    inten, dpx, dpy, ok = inten[0], dpx[0], dpy[0], valid & okS[0]

    P = params.shape[0]
    basis = torch.eye(6 + 6 * S + P, dtype=torch.float32, device=dev)
    J = forward_jacobian(lambda a, b_, c: geom(a, b_, c)[0], (z_img, z_scan, params),
                          lambda t: (t[:6], t[6:6 + 6 * S].reshape(S, 6), t[6 + 6 * S:]), basis,
                          lambda dpix: dpx * dpix[..., 0] + dpy * dpix[..., 1], pix.shape[0])
    J_img, J_scan, J_int = J[:, :6], J[:, 6:6 + 6 * S], J[:, 6 + 6 * S:]

    K = neighbors.shape[1]
    all_ok = ok & torch.all(ok[neighbors], -1) & contrib_mask
    r = (inten[neighbors] - inten[:, None]) - desc
    r = torch.where(all_ok[:, None], r, torch.zeros_like(r))
    norm = torch.sqrt(torch.clamp(torch.sum(r * r, -1), min=1e-20))
    w = torch.where(all_ok, huber_weight(norm, DEFAULT_COLOR_HUBER), torch.zeros_like(norm))

    def expand(Jb):
        Jb = torch.where(ok[:, None], Jb, torch.zeros_like(Jb))
        rows = Jb[neighbors] - Jb[:, None, :]
        rows = torch.where(all_ok[:, None, None], rows, torch.zeros_like(rows))
        return rows.reshape(-1, Jb.shape[-1])

    rows_int = expand(J_int) if optimize_intrinsics else None
    w_rep = w[:, None].expand(-1, K).reshape(-1)
    return rows_int, expand(J_scan), expand(J_img), r.reshape(-1), w_rep


def _cross(a, b):
    a0, a1, a2 = torch.unbind(a, -1)
    b0, b1, b2 = torch.unbind(b, -1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def icp_row_blocks(ps, ns, pt, nt, w):
    """Symmetric point-to-plane rows for global-frame correspondences:
    (j_rows (2M,6), r (2M,), w (2M,)); row m applies with sign +1 to the
    TARGET scan's block and -1 to the SOURCE scan's for the first M rows,
    and the reverse for the second M (the target-normal twin)."""
    diff = pt - ps
    r1 = torch.sum(ns * diff, -1)
    r2 = -torch.sum(nt * diff, -1)
    j1 = torch.cat([ns, _cross(pt, ns)], -1)
    j2 = torch.cat([nt, _cross(ps, nt)], -1)
    return torch.cat([j1, j2], 0), torch.cat([r1, r2], 0), torch.cat([w, w], 0)


class JointScene:
    """One scene of the joint BA: a single-group PhotoProblem whose level
    points carry per-point scan indices, plus global-frame ICP
    correspondences between its scans."""

    def __init__(self, problem, level_idx: int = 0, icp=None, icp_weight: float = 1.0):
        # rig problems (several groups) go through parallel/joint_ba_rig
        if len(problem.groups) != 1 and not any(g.rig_cam_index > 0 for g in problem.groups):
            raise ValueError("joint BA rows: single-group or rig scenes")
        self.problem = problem
        self.level_idx = level_idx
        self.icp = icp  # (ps, ns, pt, nt, src_scan, tgt_scan) numpy, or None
        self.icp_weight = icp_weight

    @property
    def num_scans(self) -> int:
        lv = self.problem.levels[self.level_idx]
        return int(lv.scan_indices.max()) + 1

    @property
    def num_images(self) -> int:
        return self.problem.groups[0].num_images


def build_joint_rows(scenes: List[JointScene], obs_scale: float = 0.0,
                     optimize_intrinsics: bool = True, fix_first_scan: bool = True):
    """Assemble the full joint row system over all scenes.

    Layout: [shared intrinsics P | 6 per FREE scan (scene-major; each
    scene's first scan gauge-fixed with ``fix_first_scan``) | 6 per image
    (scene-major)]. Returns (rows (R, n_vars) float32, r (R,), w (R,),
    n_keep, num_images) as numpy arrays."""
    cam = scenes[0].problem.groups[0].camera
    n_int = int(cam.params.shape[0]) if optimize_intrinsics else 0
    scan_cols, col = [], n_int
    for sc in scenes:
        cols = {}
        for s in range(sc.num_scans):
            if s < (1 if fix_first_scan else 0):
                cols[s] = -1
            else:
                cols[s] = col
                col += 6
        scan_cols.append(cols)
    n_keep = col
    img_base, m = [], 0
    for sc in scenes:
        img_base.append(n_keep + 6 * m)
        m += sc.num_images
    n_vars = n_keep + 6 * m

    all_rows, all_r, all_w = [], [], []
    for si, sc in enumerate(scenes):
        g = sc.problem.groups[0]
        lv = sc.problem.levels[sc.level_idx]
        S = sc.num_scans
        scan_idx = lv.scan_indices.long()
        n_pts = lv.points.shape[0]
        dev = lv.points.device
        contrib = torch.ones(n_pts, dtype=torch.bool, device=dev)
        scale = torch.full((n_pts,), obs_scale, dtype=torch.float32, device=dev)
        for i in range(g.num_images):
            rint, rscan, rimg, r, w = photometric_row_blocks(
                g.camera, g.camera.params, g.poses.q[i], g.poses.t[i], lv.points, scan_idx,
                lv.neighbors, lv.fixed_descriptors, [lvl[i] for lvl in g.pyramid], scale, contrib,
                optimize_intrinsics, S)
            r, w = r.cpu().numpy(), w.cpu().numpy()
            keep = w > 0
            if not keep.any():
                continue
            R = int(keep.sum())
            rows = np.zeros((R, n_vars), np.float32)
            if optimize_intrinsics:
                rows[:, :n_int] = rint.cpu().numpy()[keep]
            rscan = rscan.cpu().numpy()[keep].reshape(R, S, 6)
            for s in range(S):
                c = scan_cols[si][s]
                if c >= 0:
                    rows[:, c:c + 6] = rscan[:, s]
            o = img_base[si] + 6 * i
            rows[:, o:o + 6] = rimg.cpu().numpy()[keep]
            all_rows.append(rows)
            all_r.append(r[keep])
            all_w.append(w[keep])
        if sc.icp is not None:
            ps, ns, pt, nt, src_scan, tgt_scan = sc.icp
            M = len(ps)

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)

            jrows, r, w = icp_row_blocks(f32(ps), f32(ns), f32(pt), f32(nt),
                                         torch.full((M,), sc.icp_weight, dtype=torch.float32,
                                                    device=dev))
            jrows, r, w = jrows.cpu().numpy(), r.cpu().numpy(), w.cpu().numpy()
            rows = np.zeros((2 * M, n_vars), np.float32)
            src2 = np.concatenate([src_scan, tgt_scan])
            tgt2 = np.concatenate([tgt_scan, src_scan])
            for k in range(2 * M):
                ct = scan_cols[si][int(tgt2[k])]
                cs = scan_cols[si][int(src2[k])]
                if ct >= 0:
                    rows[k, ct:ct + 6] += jrows[k]
                if cs >= 0:
                    rows[k, cs:cs + 6] -= jrows[k]
            all_rows.append(rows)
            all_r.append(r)
            all_w.append(w)

    return (np.concatenate(all_rows, 0), np.concatenate(all_r, 0), np.concatenate(all_w, 0),
            n_keep, m)


def joint_ba_step(mesh, row_fn: Callable, inputs: Tuple, n_keep: int, num_images: int,
                  lam: float = 1e-3):
    """One damped GN step of the joint BA over dense rows sharded over
    ``mesh`` (a ``Mesh``, or a device for one rank): ``inputs`` is this
    rank's shard; every rank solves the same reduced system.

    Returns (delta_keep (n_keep,), delta_images (m,6), cost). Deltas follow
    the framework convention: apply as ``exp(-delta)`` / subtract."""
    hb = make_sharded_hb(mesh, row_fn, n_keep + 6 * num_images)
    H, b, cost = hb(*inputs)
    S, rhs, back = schur_eliminate_images(H, b, n_keep, num_images, lam)
    x_keep = torch.linalg.solve(S, rhs)
    return x_keep, back(x_keep), cost
