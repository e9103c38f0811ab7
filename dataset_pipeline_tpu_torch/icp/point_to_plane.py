"""Joint multi-cloud symmetric point-to-plane ICP.

Port of ``dataset_pipeline_tpu/icp/point_to_plane.py``:

- outer iteration: transform clouds to the global frame, find nearest-neighbor
  correspondences within ``max_correspondence_distance`` for every ordered
  cloud pair with overlapping bounding boxes, plus both directions against an
  optional fixed cloud;
- inner loop: Levenberg-Marquardt over per-cloud SE3 corrections (cloud 0 is
  gauge-fixed) with the symmetric residual pair per correspondence; the
  moment accelerator (``icp/moments.py``) runs first when one directly
  accumulated H is well conditioned, and the exact direct LM finishes;
- LM control: lambda starts at 0.1, halve on accept / double on reject, 10
  tries as one ladder, stop when no update applies or |x| < threshold;
- ``use_device_lm``: the whole inner LM with its state in device tensors
  (``_icp_inner_lm_device``), one host read per iteration.

There is one orchestration path. Correspondences are packed once per outer
iteration into the group-padded ``(13, Mp)`` tensor on the engine's device
(one ordered cloud pair per chunk); every H,b goes through the fused B1
wrapper, the ten candidates of an LM ladder through B1's cost batch in one
pass, and the moment pass through the B2 wrapper (``ops/gn.py``). Only those
wrappers differ between CPU and CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.icp.moments import (
    compute_group_moments_from_packed,
    icp_lm_from_moments,
    pack_group_data,
)
from dataset_pipeline_tpu_torch.models.lie import SE3, quat_rotate, quat_to_matrix_np
from dataset_pipeline_tpu_torch.ops.gn import icp_cost_batch_fused, icp_hb_cost_fused
from dataset_pipeline_tpu_torch.ops.knn import build_grid, nearest_neighbor
from dataset_pipeline_tpu_torch.utils.timing import stage

ENGINE_CHUNK = 49152  # columns per chunk of the packed tensor, at most
_CHUNK_ALIGN = 256  # the CUDA kernels' row granularity
_LADDER_TRIES = 10  # damped candidates per LM iteration (ops/gn.py: GN_MAX_CANDIDATES)


# ---------------------------------------------------------------------------
# Direct accumulation over the (M, 3) layout (the JAX package's `entry()`
# step). The engine itself works off the packed tensor through ops/gn.py.
# ---------------------------------------------------------------------------


def _residuals(q, t, ps, ns, pt, nt, sid, tid):
    gps = quat_rotate(q[sid], ps) + t[sid]
    gns = quat_rotate(q[sid], ns)
    gpt = quat_rotate(q[tid], pt) + t[tid]
    gnt = quat_rotate(q[tid], nt)
    diff = gpt - gps
    return gps, gns, gpt, gnt, torch.sum(gns * diff, -1), -torch.sum(gnt * diff, -1)


def _icp_hb_cost(q, t, ps, ns, pt, nt, src_id, tgt_id, w, num_clouds: int,
                 chunk: int = 65536):
    """H (6C,6C), b (6C,), cost (float32) of the symmetric point-to-plane
    residuals; ``ps/ns/pt/nt (M,3)`` global frame, ``src_id/tgt_id (M,)``
    cloud ids, ``w (M,)`` weights. One-hot row form, strict fp32."""
    C = num_clouds
    H = torch.zeros((6 * C, 6 * C), dtype=torch.float32, device=ps.device)
    b = torch.zeros(6 * C, dtype=torch.float32, device=ps.device)
    cost = torch.zeros((), dtype=torch.float32, device=ps.device)
    for s in range(0, ps.shape[0], chunk):
        sl = slice(s, s + chunk)
        sid, tid = src_id[sl].long(), tgt_id[sl].long()
        gps, gns, gpt, gnt, r1, r2 = _residuals(q, t, ps[sl], ns[sl], pt[sl], nt[sl], sid, tid)
        j1 = torch.cat([gns, torch.linalg.cross(gpt, gns, dim=-1)], -1)  # (m,6)
        j2 = torch.cat([gnt, torch.linalg.cross(gps, gnt, dim=-1)], -1)
        sign = (torch.nn.functional.one_hot(tid, C) - torch.nn.functional.one_hot(sid, C)).to(ps.dtype)
        sw = torch.sqrt(w[sl])
        rows1 = sign[:, :, None] * j1[:, None, :]
        rows2 = -sign[:, :, None] * j2[:, None, :]
        rows = torch.cat([rows1, rows2], 0).reshape(-1, 6 * C) * torch.cat([sw, sw])[:, None]
        r = torch.cat([r1 * sw, r2 * sw])
        H = H + rows.T @ rows
        b = b + torch.sum(rows * r[:, None], 0)
        cost = cost + torch.sum(r * r)
    return H, b, cost


def _icp_cost(q, t, ps, ns, pt, nt, src_id, tgt_id, w, chunk: int = 65536):
    """Residual cost only (float32)."""
    cost = torch.zeros((), dtype=torch.float32, device=ps.device)
    for s in range(0, ps.shape[0], chunk):
        sl = slice(s, s + chunk)
        *_, r1, r2 = _residuals(q, t, ps[sl], ns[sl], pt[sl], nt[sl],
                                src_id[sl].long(), tgt_id[sl].long())
        cost = cost + torch.sum(w[sl] * (r1 * r1 + r2 * r2))
    return cost


def _icp_cost_batch(qs, ts, ps, ns, pt, nt, src_id, tgt_id, w, chunk: int = 65536):
    """Costs of a batch of candidate pose sets ``qs (K,C,4)``, ``ts (K,C,3)``
    -> (K,)."""
    return torch.stack([_icp_cost(qs[k], ts[k], ps, ns, pt, nt, src_id, tgt_id, w, chunk)
                        for k in range(qs.shape[0])])


def _icp_inner_lm_device(q, t, data, chunk_pairs, num_clouds: int, chunk: int,
                         max_iterations: int, convergence_threshold: float = 1e-7):
    """The whole inner LM loop with its state (q, t, lambda) in device
    tensors: per iteration one full B1 pass for H, b and the cost, the ten
    damped 6(C-1) solves of the ladder as one batched solve on the device
    (float64, as B1 returns H and b), one B1 cost batch over the ten
    candidates, and the choice of the first improving one by ``torch.where``.

    Counterpart of the JAX ``_icp_inner_lm_device`` with the same trajectory:
    lambda 0.1, halved on accept and doubled on reject, at most 10 tries per
    iteration, stop when no try applies or |x| < threshold. The host reads
    one flag per iteration, nothing inside the ladder. Returns (q, t,
    iterations).
    """
    C = num_clouds
    n_var = 6 * (C - 1)
    dev = data.device
    eye = torch.eye(n_var, dtype=torch.float64, device=dev)
    lam = torch.tensor(0.1, dtype=torch.float64, device=dev)
    doublings = 2.0 ** torch.arange(_LADDER_TRIES, dtype=torch.float64, device=dev)
    it = 0
    while it < max_iterations:
        H, b, cost = icp_hb_cost_fused(q, t, data, chunk_pairs, C, chunk)
        Hv, bv = H[6:, 6:], b[6:, None]
        # the ladder's candidates depend only on H, b and the lambda at its
        # start (a reject doubles it), so all are built first, costed in one
        # pass, and the first improving one is taken
        lams = lam * doublings
        # solve_ex does not read its error flag back: a singular system
        # gives a non-finite step, whose cost compares false and is rejected
        xs = torch.linalg.solve_ex(Hv + lams[:, None, None] * eye,
                                   bv.expand(_LADDER_TRIES, -1, -1))[0][:, :, 0]
        deltas = torch.zeros((_LADDER_TRIES, C, 6), dtype=torch.float32, device=dev)
        deltas[:, 1:] = -xs.reshape(_LADDER_TRIES, C - 1, 6).to(torch.float32)  # cloud 0: gauge
        cands = SE3.exp(deltas).compose(SE3(q, t))
        costs = icp_cost_batch_fused(cands.q, cands.t, data, chunk_pairs, C, chunk)
        improving = costs < cost
        applied = improving.any()
        hit = torch.argmax(improving.to(torch.int32))[None]  # the first improving try
        q = torch.where(applied, cands.q.index_select(0, hit)[0], q)
        t = torch.where(applied, cands.t.index_select(0, hit)[0], t)
        lam = torch.where(applied, 0.5 * lams.index_select(0, hit)[0], 2.0 * lams[-1])
        dx = torch.linalg.vector_norm(xs.index_select(0, hit)[0])
        it += 1
        if not bool(applied & (dx >= convergence_threshold)):
            break
    return q, t, it


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def _bbox_overlap(a_min, a_max, b_min, b_max) -> bool:
    return bool(np.all(a_min <= b_max) and np.all(b_min <= a_max))


def _engine_chunk(group_sizes) -> int:
    """Chunk of the packed tensor: ``ENGINE_CHUNK``, or less when every group
    is smaller (padding each group to 49152 columns would dominate small
    problems). A multiple of the kernels' row granularity."""
    largest = max(group_sizes)
    return min(ENGINE_CHUNK, _CHUNK_ALIGN * -(-largest // _CHUNK_ALIGN))


@dataclass
class ICPResult:
    poses: List[np.ndarray]  # per movable cloud: global_T_cloud (4,4)
    converged: bool
    iterations: int
    final_cost: float
    num_correspondences: int = 0


class PointToPlaneICP:
    """Multi-cloud symmetric point-to-plane ICP (API mirrors the reference's
    ``PointToPlaneICP::AddPointCloud/Run``; ``run`` returns the poses).

    ``use_device_lm``: run the whole inner LM on the device
    (``_icp_inner_lm_device``) instead of the moment accelerator and the
    host-solved direct LM. ``device``: where correspondences are searched
    and H,b accumulated; the card unless the caller names another (it raises
    when CUDA is absent). ``timings``: optional dict that collects per-stage
    seconds (``correspondences``, ``moment_pass``, ``moment_lm``,
    ``direct_lm``, ``device_lm``).
    """

    def __init__(self, use_device_lm: bool = False, use_moments: bool = True,
                 device="cuda", timings: Optional[dict] = None):
        self._clouds: List[Tuple[np.ndarray, np.ndarray]] = []  # local points, normals
        self._poses: List[np.ndarray] = []  # global_T_cloud (4,4)
        self._fixed: List[Tuple[np.ndarray, np.ndarray]] = []  # global frame
        self.use_device_lm = use_device_lm
        self.use_moments = use_moments
        self.device = resolve_device(device)
        self.timings = timings

    def add_point_cloud(self, points, normals, global_T_cloud=None, fixed=False):
        points = np.ascontiguousarray(points, np.float32)
        normals = np.ascontiguousarray(normals, np.float32)
        T = np.eye(4, dtype=np.float64) if global_T_cloud is None else np.asarray(global_T_cloud, np.float64)
        if fixed:
            R, tr = T[:3, :3], T[:3, 3]
            self._fixed.append(((points @ R.T + tr).astype(np.float32),
                                (normals @ R.T).astype(np.float32)))
        else:
            self._clouds.append((points, normals))
            self._poses.append(T)
        return len(self._clouds) - 1

    def get_result_global_T_cloud(self, index: int) -> np.ndarray:
        """global_T_cloud (4,4) of movable cloud ``index`` (after ``run``)."""
        return self._poses[index]

    # -- correspondence search ------------------------------------------------

    def _find_all_correspondences(self, globals_: List[Tuple[np.ndarray, np.ndarray]],
                                  max_dist: float):
        """Per ordered cloud pair with correspondences: a dict of (Mg, 3)
        device tensors ps/ns/pt/nt, and the list of (src, tgt) ids.

        Cloud ids: 0 = fixed concatenation (if present), movable clouds
        follow; movable pairs both ways, fixed<->movable both ways, never
        fixed->fixed.
        """
        has_fixed = len(self._fixed) > 0
        entries = []
        if has_fixed:
            entries.append((np.concatenate([p for p, _ in self._fixed]),
                            np.concatenate([n for _, n in self._fixed])))
        entries.extend(globals_)
        bboxes = [(p.min(0) - max_dist, p.max(0) + max_dist) for p, _ in entries]
        dev_entries = [(torch.from_numpy(p).to(self.device), torch.from_numpy(n).to(self.device))
                       for p, n in entries]
        grids = {}

        groups, pairs = [], []
        first_movable = 1 if has_fixed else 0
        for i in range(len(entries)):
            for j in range(len(entries)):
                if i == j or (i < first_movable and j < first_movable):
                    continue
                if not _bbox_overlap(bboxes[i][0], bboxes[i][1], bboxes[j][0], bboxes[j][1]):
                    continue
                if j not in grids:
                    grids[j] = build_grid(dev_entries[j][0], max_dist)
                src_pts, src_nrm = dev_entries[i]
                tgt_pts, tgt_nrm = dev_entries[j]
                d2, idx = nearest_neighbor(grids[j], src_pts)
                sidx = torch.nonzero((idx >= 0) & (d2 <= max_dist * max_dist))[:, 0]
                if sidx.numel() == 0:
                    continue
                tidx = idx[sidx]
                groups.append({"ps": src_pts[sidx], "ns": src_nrm[sidx],
                               "pt": tgt_pts[tidx], "nt": tgt_nrm[tidx]})
                pairs.append((i, j))
        return groups, pairs

    # -- inner LM -------------------------------------------------------------

    def _inner_lm(self, groups, pairs, num_entries: int, max_iterations: int,
                  convergence_threshold: float):
        """LM over per-cloud corrections with fixed correspondences.

        Returns per-entry correction (q (C,4), t (C,3)) as numpy arrays and
        the final cost.
        """
        C = num_entries
        dev = self.device
        chunk = _engine_chunk([len(g["ps"]) for g in groups])
        data, chunk_gid = pack_group_data(groups, chunk, rows=13, device=dev)
        chunk_pairs = torch.as_tensor(np.asarray(pairs, np.int32)[chunk_gid], device=dev)

        def hb_cost(q_, t_):
            return icp_hb_cost_fused(q_, t_, data, chunk_pairs, C, chunk)

        def cost_of(q_, t_):
            return float(hb_cost(q_, t_)[2])

        q = torch.tensor([[1.0, 0, 0, 0]] * C, dtype=torch.float32, device=dev)
        t = torch.zeros((C, 3), dtype=torch.float32, device=dev)
        lam = 0.1
        n_var = 6 * (C - 1)
        if n_var == 0:
            return q.cpu().numpy(), t.cpu().numpy(), cost_of(q, t)

        if self.use_device_lm:
            with stage(self.timings, "device_lm", dev):
                q, t, _ = _icp_inner_lm_device(q, t, data, chunk_pairs, C, chunk,
                                               max_iterations, convergence_threshold)
                final_cost = cost_of(q, t)
            return q.cpu().numpy(), t.cpu().numpy(), final_cost

        if self.use_moments:
            # Moment accelerator, GATED on conditioning: one directly
            # accumulated H at the linearization point (structural zeros
            # exact) must have lambda_min > 1e-4 lambda_max, so the moment
            # noise is small in every direction; degenerate geometries take
            # the exact direct path alone.
            with stage(self.timings, "moment_pass", dev):
                H0 = hb_cost(q, t)[0].cpu().numpy()
                Hv0 = H0[6:, 6:]
                evals, V = np.linalg.eigh(0.5 * (Hv0 + Hv0.T))
                well_conditioned = evals.min() > 1e-4 * max(float(evals.max()), 1e-30)
                if well_conditioned:
                    # center the data: far-from-origin clouds lose moment
                    # precision to f32 cancellation
                    center = 0.5 * (torch.cat([g["ps"] for g in groups]).double().mean(0)
                                    + torch.cat([g["pt"] for g in groups]).double().mean(0))
                    center = center.cpu().numpy()
                    c32 = torch.as_tensor(center.astype(np.float32), device=dev)[:, None]
                    centered = data.clone()  # padding columns have w=0 and vanish
                    centered[0:3] -= c32
                    centered[6:9] -= c32
                    P = compute_group_moments_from_packed(centered, chunk_gid, len(pairs), chunk)
                    del centered
            if well_conditioned:
                with stage(self.timings, "moment_lm", dev):
                    # absolute noise floor of the moment-form cost, ~1e-7 *
                    # ||P||_F per group (f32 Gram accumulation), with a 10x
                    # safety factor: phases starting below it are skipped
                    floor_abs = 10.0 * 1e-7 * max(float(np.linalg.norm(Pg)) for Pg in P)
                    qm, tm, _ = icp_lm_from_moments(
                        P, pairs, C, max_iterations, convergence_threshold,
                        center=center, basis=np.ascontiguousarray(V),
                        cost_floor_rel=1e-4, cost_floor_abs=floor_abs)
                    q = torch.as_tensor(np.asarray(qm, np.float32), device=dev)
                    t = torch.as_tensor(np.asarray(tm, np.float32), device=dev)

        with stage(self.timings, "direct_lm", dev):
            eye = np.eye(n_var)
            for _ in range(max_iterations):
                H, b, cost = hb_cost(q, t)
                Hn = H.cpu().numpy()[6:, 6:]
                bn = b.cpu().numpy()[6:]
                cost = float(cost)

                # the damped ladder as one batch: H, b are fixed within it,
                # so accepting the FIRST improving candidate reproduces the
                # sequential try loop exactly
                lams = [lam * (2.0 ** j) for j in range(10)]
                xs = []
                deltas = np.zeros((10, C, 6), np.float32)
                for k, lj in enumerate(lams):
                    try:
                        xj = np.linalg.solve(Hn + lj * eye, bn)
                    except np.linalg.LinAlgError:
                        xs.append(None)
                        continue
                    xs.append(xj)
                    deltas[k, 1:] = -xj.reshape(C - 1, 6)
                cands = SE3.exp(torch.from_numpy(deltas).to(dev)).compose(SE3(q, t))
                costs = icp_cost_batch_fused(cands.q, cands.t, data, chunk_pairs, C, chunk)
                costs = np.where([xj is None for xj in xs], np.inf, costs.cpu().numpy())
                hit = next((j for j in range(10) if costs[j] < cost), None)
                if hit is None:
                    break
                q, t = cands.q[hit], cands.t[hit]
                lam = lams[hit] * 0.5
                if np.linalg.norm(xs[hit]) < convergence_threshold:
                    break
            final_cost = cost_of(q, t)
        return q.cpu().numpy(), t.cpu().numpy(), final_cost

    # -- public entry ---------------------------------------------------------

    def run(self, max_correspondence_distance: float, max_num_iterations: int = 100,
            convergence_threshold_max_movement: float = 1e-10,
            inner_max_iterations: int = 150, inner_convergence_threshold: float = 1e-7,
            print_progress: bool = False) -> ICPResult:
        has_fixed = len(self._fixed) > 0
        total_corr = 0
        converged = False
        it = 0
        final_cost = 0.0
        for it in range(max_num_iterations):
            globals_ = []
            for (pts, nrm), T in zip(self._clouds, self._poses):
                R, tr = T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32)
                globals_.append((pts @ R.T + tr, nrm @ R.T))

            with stage(self.timings, "correspondences", self.device):
                groups, pairs = self._find_all_correspondences(
                    globals_, max_correspondence_distance)
            if not groups:
                break
            total_corr = sum(len(g["ps"]) for g in groups)
            num_entries = len(self._clouds) + (1 if has_fixed else 0)
            q, t, final_cost = self._inner_lm(
                groups, pairs, num_entries, inner_max_iterations,
                inner_convergence_threshold)

            first_movable = 1 if has_fixed else 0
            max_move = 0.0
            for ci in range(len(self._clouds)):
                e = first_movable + ci
                corr_T = np.eye(4)
                corr_T[:3, :3] = quat_to_matrix_np(np.asarray(q[e], np.float64))
                corr_T[:3, 3] = np.asarray(t[e], np.float64)
                new_T = corr_T @ self._poses[ci]
                max_move = max(max_move, float(np.linalg.norm(new_T[:3, 3] - self._poses[ci][:3, 3])))
                self._poses[ci] = new_T
            if print_progress:
                print(f"icp outer iter {it}: {total_corr} correspondences, max movement {max_move:.3e}")
            if max_move < convergence_threshold_max_movement:
                converged = True
                break
        return ICPResult([p.copy() for p in self._poses], converged, it + 1,
                         final_cost, total_corr)
