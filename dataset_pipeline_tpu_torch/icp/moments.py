"""Moment-matrix (monomial Gram) form of the symmetric point-to-plane
Gauss-Newton normal equations.

Port of ``dataset_pipeline_tpu/icp/moments.py``. Every entry of a
correspondence's stacked residual/Jacobian row pair is linear in the 42
pose-independent monomials

    m = sqrt(w) * [ns, nt, ps_k * (ns, nt), pt_k * (ns, nt)],  k = 0..2

so ``H_aug = sum_g M_g(pose) P_g M_g(pose)^T`` with ``P_g = sum m m^T`` per
correspondence group: one pass over the data (the B2 kernel) gives the
``P_g``, after which every inner LM iteration is O(1) host float64 math.

The host float64 functions (``group_row_maps``, ``hb_cost_from_moments``,
``se3_exp_np``, ``quat_mul_np``, ``icp_lm_from_moments``) are line-for-line
copies: importing the JAX package would import jax.
``hb_cost_from_moments_torch`` is the on-device float32 form, batched over
the groups, for schedules that keep the whole inner LM on the device.

Monomial layout (42 rows, Kronecker block order):
    0:6                 b = [sqrt(w)*ns (3), sqrt(w)*nt (3)]
    6+6k : 12+6k        a_k * b,  a = (ps_0, ps_1, ps_2, pt_0, pt_1, pt_2)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.models.lie import quat_to_matrix, quat_to_matrix_np
from dataset_pipeline_tpu_torch.ops.gn import moment_gram_partials

# index arrays into the 42 monomials for each outer-product family,
# flattened row-major over (i, j)
_I6 = np.arange(3)
IDX_PS_SNS = (6 + 6 * _I6[:, None] + _I6[None, :]).reshape(9)
IDX_PS_SNT = (9 + 6 * _I6[:, None] + _I6[None, :]).reshape(9)
IDX_PT_SNS = (24 + 6 * _I6[:, None] + _I6[None, :]).reshape(9)
IDX_PT_SNT = (27 + 6 * _I6[:, None] + _I6[None, :]).reshape(9)


def monomials(ps, ns, pt, nt, w):
    """(M, 42) monomial matrix (counterpart of ``monomials_xla``)."""
    sw = torch.sqrt(w)[:, None]
    b = torch.cat([ns * sw, nt * sw], dim=1)  # (M, 6)
    a = torch.cat([ps, pt], dim=1)  # (M, 6)
    prod = (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], 36)
    return torch.cat([b, prod], dim=1)


def moment_gram(ps, ns, pt, nt, w):
    """P = sum m m^T for one correspondence group (42x42, strict fp32;
    counterpart of ``moment_gram_xla``)."""
    m = monomials(ps, ns, pt, nt, w)
    return m.T @ m


def _skew(v):
    return np.asarray([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def group_row_maps(Rs, ts, Rt, tt):
    """Linear maps from the 42 monomials to the two augmented row vectors.

    Returns (J1, r1, J2, r2): J* (6, 42) map to the 6-dof Jacobian vectors
    ``j1 = [Ns, Pt x Ns]`` / ``j2 = [Nt, Ps x Nt]`` in the GLOBAL frame,
    r* (42,) map to the residuals ``r1 = Ns.(Pt-Ps)``, ``r2 = Nt.(Ps-Pt)``.
    All f64.
    """
    Rs = np.asarray(Rs, np.float64)
    Rt = np.asarray(Rt, np.float64)
    ts = np.asarray(ts, np.float64)
    tt = np.asarray(tt, np.float64)

    # cross products of columns: cc[a, e*3+f] = (Rt[:,e] x Rs[:,f])_a
    def col_cross(A, B):
        c = np.cross(A.T[:, None, :], B.T[None, :, :])  # (e, f, a)
        return c.reshape(9, 3).T  # (3, 9)

    eye9 = np.eye(3).reshape(9)
    J1 = np.zeros((6, 42))
    J1[0:3, 0:3] = Rs                       # Ns on ns
    J1[3:6, 0:3] = _skew(tt) @ Rs           # (t_t x Ns) on ns
    J1[3:6, IDX_PT_SNS] = col_cross(Rt, Rs)  # (R_t pt x R_s ns) on pt (x) ns
    r1 = np.zeros(42)
    r1[0:3] = Rs.T @ (tt - ts)              # Ns.(t_t - t_s) on ns
    r1[IDX_PS_SNS] = -eye9                  # -ps.ns  (R_s^T R_s = I)
    # (Rt.T @ Rs)[e, f] = Rt[:,e].Rs[:,f]  -> row-major e*3+f
    r1[IDX_PT_SNS] = (Rt.T @ Rs).reshape(9)
    J2 = np.zeros((6, 42))
    J2[0:3, 3:6] = Rt
    J2[3:6, 3:6] = _skew(ts) @ Rt
    J2[3:6, IDX_PS_SNT] = col_cross(Rs, Rt)  # (R_s ps x R_t nt) on ps (x) nt
    r2 = np.zeros(42)
    r2[3:6] = Rt.T @ (ts - tt)
    r2[IDX_PT_SNT] = -eye9
    r2[IDX_PS_SNT] = (Rs.T @ Rt).reshape(9)
    return J1, r1, J2, r2


def hb_cost_from_moments(P_groups: Sequence[np.ndarray],
                         group_pairs: Sequence[Tuple[int, int]],
                         q: np.ndarray, t: np.ndarray,
                         num_clouds: int):
    """H (6C,6C), b (6C,), cost from per-group moment matrices. All f64.

    ``q`` (C,4) wxyz, ``t`` (C,3): per-cloud correction poses (the transform
    applied on top of the stored global poses, exactly as in
    ``_icp_hb_cost``).
    """
    C = num_clouds
    n = 6 * C
    G = np.zeros((n + 1, n + 1))
    Rs_all = [quat_to_matrix_np(np.asarray(q[c], np.float64)) for c in range(C)]
    for P, (s, tg) in zip(P_groups, group_pairs):
        P = np.asarray(P, np.float64)[:42, :42]
        J1, r1, J2, r2 = group_row_maps(Rs_all[s], t[s], Rs_all[tg], t[tg])
        A1 = np.zeros((n + 1, 42))
        A1[6 * s:6 * s + 6] = -J1
        A1[6 * tg:6 * tg + 6] += J1
        A1[n] = r1
        A2 = np.zeros((n + 1, 42))
        A2[6 * s:6 * s + 6] = J2
        A2[6 * tg:6 * tg + 6] += -J2
        A2[n] = r2
        G += A1 @ P @ A1.T + A2 @ P @ A2.T
    return G[:n, :n], G[:n, n], G[n, n]


def _group_row_maps_torch(Rs, ts, Rt, tt):
    """Batched twin of :func:`group_row_maps` in ``Rs.dtype``: ``Rs, Rt
    (G,3,3)``, ``ts, tt (G,3)`` -> J1, J2 ``(G,6,42)``, r1, r2 ``(G,42)``."""
    G, dev, dt = Rs.shape[0], Rs.device, Rs.dtype

    def col_cross(A, B):  # [g, a, e*3+f] = (A[g,:,e] x B[g,:,f])_a
        c = torch.linalg.cross(A.transpose(1, 2)[:, :, None, :], B.transpose(1, 2)[:, None, :, :],
                               dim=-1)
        return c.reshape(G, 9, 3).transpose(1, 2)

    def skew(v):
        z = torch.zeros_like(v[:, 0])
        return torch.stack([z, -v[:, 2], v[:, 1], v[:, 2], z, -v[:, 0],
                            -v[:, 1], v[:, 0], z], -1).reshape(G, 3, 3)

    idx = {k: torch.as_tensor(v, device=dev) for k, v in
           (("ps_sns", IDX_PS_SNS), ("ps_snt", IDX_PS_SNT), ("pt_sns", IDX_PT_SNS),
            ("pt_snt", IDX_PT_SNT))}
    eye9 = torch.eye(3, dtype=dt, device=dev).reshape(9)
    J1 = torch.zeros((G, 6, 42), dtype=dt, device=dev)
    J1[:, 0:3, 0:3] = Rs
    J1[:, 3:6, 0:3] = skew(tt) @ Rs
    J1[:, 3:6, idx["pt_sns"]] = col_cross(Rt, Rs)
    r1 = torch.zeros((G, 42), dtype=dt, device=dev)
    r1[:, 0:3] = (Rs.transpose(1, 2) @ (tt - ts)[:, :, None])[:, :, 0]
    r1[:, idx["ps_sns"]] = -eye9
    r1[:, idx["pt_sns"]] = (Rt.transpose(1, 2) @ Rs).reshape(G, 9)
    J2 = torch.zeros((G, 6, 42), dtype=dt, device=dev)
    J2[:, 0:3, 3:6] = Rt
    J2[:, 3:6, 3:6] = skew(ts) @ Rt
    J2[:, 3:6, idx["ps_snt"]] = col_cross(Rs, Rt)
    r2 = torch.zeros((G, 42), dtype=dt, device=dev)
    r2[:, 3:6] = (Rt.transpose(1, 2) @ (ts - tt)[:, :, None])[:, :, 0]
    r2[:, idx["pt_snt"]] = -eye9
    r2[:, idx["ps_snt"]] = (Rs.transpose(1, 2) @ Rt).reshape(G, 9)
    return J1, r1, J2, r2


def hb_cost_from_moments_torch(P, group_pairs, q, t, num_clouds: int):
    """H (6C,6C), b (6C,), cost on ``P``'s device and in its dtype from
    stacked ``(G, 48, 48)`` (or ``(G, 42, 42)``) moment matrices.

    Counterpart of ``hb_cost_from_moments_jax``: batched over the groups
    (each group's augmented Gram only touches the (s,s), (s,t), (t,s), (t,t)
    blocks, the b column and the cost, so the compact 7x7 Grams ``B P B^T``,
    ``B = [J; r]``, are formed for all groups at once) and scattered by a
    signed one-hot product in a fixed order. Every product is strict fp32
    (the package turns TF32 off at import). ``group_pairs``: ``(G, 2)``
    sequence or integer tensor; a tensor already on the device costs no copy.
    """
    C = num_clouds
    pairs = torch.as_tensor(group_pairs, device=P.device).long()
    s_idx, t_idx = pairs[:, 0], pairs[:, 1]
    R = quat_to_matrix(q.to(P.dtype))
    tr = t.to(P.dtype)
    J1, r1, J2, r2 = _group_row_maps_torch(R[s_idx], tr[s_idx], R[t_idx], tr[t_idx])
    B1 = torch.cat([J1, r1[:, None, :]], 1)  # (G, 7, 42)
    B2 = torch.cat([J2, r2[:, None, :]], 1)
    Pg = P[:, :42, :42]
    S1 = B1 @ Pg @ B1.transpose(1, 2)  # (G, 7, 7)
    S2 = B2 @ Pg @ B2.transpose(1, 2)
    # A1 rows: block s = -J1, block t = +J1, last row r1 (A2: s = +J2, t = -J2)
    Hblk = S1[:, :6, :6] + S2[:, :6, :6]
    bs = S2[:, :6, 6] - S1[:, :6, 6]
    eye = torch.eye(C, dtype=P.dtype, device=P.device)
    e = eye[t_idx] - eye[s_idx]  # (G, C): +1 on the target cloud, -1 on the source
    H = torch.einsum("gc,gd,gab->cadb", e, e, Hblk).reshape(6 * C, 6 * C)
    b = -torch.einsum("gc,ga->ca", e, bs).reshape(6 * C)
    return H, b, torch.sum(S1[:, 6, 6] + S2[:, 6, 6])


def se3_exp_np(tangent):
    """f64 host twin of ``SE3.exp`` ([u, w] -> (q wxyz, t), Sophus V(w)u)."""
    tangent = np.asarray(tangent, np.float64)
    u, w = tangent[:3], tangent[3:]
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        q = np.asarray([1.0, 0.5 * w[0], 0.5 * w[1], 0.5 * w[2]])
        q /= np.linalg.norm(q)
        K = _skew(w)
        V = np.eye(3) + 0.5 * K + K @ K / 6.0
    else:
        axis = w / theta
        q = np.concatenate([[np.cos(theta / 2)], np.sin(theta / 2) * axis])
        K = _skew(w)
        V = (np.eye(3) + (1 - np.cos(theta)) / theta**2 * K
             + (theta - np.sin(theta)) / theta**3 * (K @ K))
    return q, V @ u


def quat_mul_np(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.asarray([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def icp_lm_from_moments(P_groups, group_pairs, num_clouds: int,
                        max_iterations: int = 150,
                        convergence_threshold: float = 1e-7,
                        lam0: float = 0.1, center=None, cost_fn=None,
                        trunc_rel: float = 1e-4, basis=None,
                        cost_batch_fn=None, cost_floor_rel: float = 0.0,
                        cost_floor_abs: float = 0.0):
    """The ENTIRE inner LM loop from precomputed moment matrices.

    Damped solve over the gauge-fixed system (cloud 0 excluded), accept iff
    cost decreases, lambda halve/double with 10 tries, stop when no update
    applies or |x| < threshold. All math f64 on host; per-iteration cost is
    O(groups * 42^2) regardless of correspondence count.

    ``center``: the moment matrices were accumulated from correspondences
    minus ``center``; H,b are evaluated at the conjugated centered state and
    mapped back to the origin tangent basis, so the trajectory equals the
    uncentered algorithm's. ``cost_fn(q, t)``: exact accept-test cost
    (default: the moment-form cost). ``trunc_rel``: steps along
    eigendirections with curvature below ``trunc_rel * lambda_max`` are
    zeroed. ``basis``: optional (n_var, k) orthonormal columns confining the
    steps (``trunc_rel`` is then ignored). ``cost_batch_fn(qs, ts)``: the
    whole 10-candidate ladder in one call, first improvement accepted.
    ``cost_floor_rel`` / ``cost_floor_abs``: stop once the cost falls below
    either floor (the moment-form cost's noise floor).

    Returns (q (C,4) f64, t (C,3) f64, final_cost).
    """
    C = num_clouds
    q = np.tile(np.asarray([1.0, 0, 0, 0]), (C, 1))
    t = np.zeros((C, 3))
    lam = lam0
    n_var = 6 * (C - 1)

    if center is not None:
        center = np.asarray(center, np.float64)
        Ginv_blk = np.eye(6)
        Ginv_blk[3:6, 0:3] = _skew(center)
        Ginv = np.kron(np.eye(C), Ginv_blk)

    def eval_G(q_, t_):
        if center is None:
            return hb_cost_from_moments(P_groups, group_pairs, q_, t_, C)
        # conjugate the global correction into the centered frame:
        # X' = T_{-c} X T_{c}  =>  R' = R, t' = R c + t - c
        tc = np.stack([quat_to_matrix_np(q_[e]) @ center + t_[e] - center
                       for e in range(C)])
        Hc, bc, cost = hb_cost_from_moments(P_groups, group_pairs, q_, tc, C)
        return Ginv @ Hc @ Ginv.T, Ginv @ bc, cost

    if cost_fn is None:
        cost_fn = lambda q_, t_: eval_G(q_, t_)[2]  # noqa: E731

    H, b, _ = eval_G(q, t)
    cost = cost_fn(q, t)
    cost0 = max(abs(cost), 1e-30)
    if n_var == 0:
        return q, t, cost
    if basis is not None and basis.shape[1] == 0:
        return q, t, cost  # fully rank-deficient: nothing the LM may move
    floor = max(cost_floor_rel * cost0, cost_floor_abs)
    if cost_floor_abs > 0.0 and abs(cost) < cost_floor_abs:
        return q, t, cost

    for _ in range(max_iterations):
        Hv, bv = H[6:, 6:], b[6:]
        if basis is not None:
            Hp = basis.T @ Hv @ basis
            bp = basis.T @ bv
            k = basis.shape[1]
        else:
            try:
                evals, V = np.linalg.eigh(0.5 * (Hv + Hv.T))
            except np.linalg.LinAlgError:
                break
            lam_max = max(float(evals.max()), 1e-30)
            keep = evals > trunc_rel * lam_max
            bb = V.T @ bv
        def solve_at(lam_k):
            if basis is not None:
                try:
                    xp = np.linalg.solve(Hp + lam_k * np.eye(k), bp)
                except np.linalg.LinAlgError:
                    return None
                return basis @ xp
            return V @ np.where(keep, bb / (evals + lam_k), 0.0)

        def apply_x(x):
            qc = q.copy()
            tc = t.copy()
            for c in range(1, C):
                dq, dt = se3_exp_np(np.concatenate([
                    -x[6 * (c - 1):6 * (c - 1) + 3],
                    -x[6 * (c - 1) + 3:6 * c]]))
                Rd = quat_to_matrix_np(dq)
                qc[c] = quat_mul_np(dq, q[c])
                qc[c] /= np.linalg.norm(qc[c])
                tc[c] = Rd @ t[c] + dt
            return qc, tc

        applied = False
        x = None
        if cost_batch_fn is not None:
            # whole ladder in ONE dispatch; accept the first improvement
            lams = [lam * (2.0 ** j) for j in range(10)]
            cands = [solve_at(lj) for lj in lams]
            states = [apply_x(xj) if xj is not None else None for xj in cands]
            qs = np.stack([s[0] if s is not None else q for s in states])
            ts = np.stack([s[1] if s is not None else t for s in states])
            costs = np.asarray(cost_batch_fn(qs, ts), np.float64)
            costs = np.where([s is None for s in states], np.inf, costs)
            hit = next((j for j in range(10) if costs[j] < cost), None)
            if hit is None:
                lam = lams[-1] * 2.0
            else:
                x = cands[hit]
                q, t = states[hit]
                cost = float(costs[hit])
                H, b, _ = eval_G(q, t)
                lam = lams[hit] * 0.5
                applied = True
        else:
            for _ in range(10):
                x = solve_at(lam)
                if x is None:
                    lam *= 2.0
                    continue
                qc, tc = apply_x(x)
                new_cost = cost_fn(qc, tc)
                if new_cost < cost:
                    q, t, cost = qc, tc, new_cost
                    H, b, _ = eval_G(q, t)
                    lam *= 0.5
                    applied = True
                    break
                lam *= 2.0
        if not applied:
            break
        if floor > 0.0 and abs(cost) < floor:
            # the moment-form cost is approaching its noise floor: hand over
            # to the caller's exact finisher
            break
        if x is not None and np.linalg.norm(x) < convergence_threshold:
            break
    return q, t, cost


def _groups_device(groups, device):
    """The device a function over correspondence groups works on: the one
    asked for, else the groups' own when they are tensors, else the card
    (which raises when CUDA is absent: numpy groups name no device)."""
    if device is not None:
        return resolve_device(device)
    if groups and torch.is_tensor(groups[0]["ps"]):
        return groups[0]["ps"].device
    return resolve_device("cuda")


def pack_group_data(groups, chunk: int = 16384, rows: int = 16, device=None):
    """Pack per-group correspondence arrays into the ``(rows, Mp)`` layout
    with each group padded to a chunk multiple (padding columns have w=0 and
    thus vanish from every sum).

    ``groups``: list of dicts with ps/ns/pt/nt (Mg,3) float32 arrays or
    tensors and optional 'w'. Returns (data (rows, Mp) float32 tensor on
    ``device``, chunk_gid (grid,) int32 numpy array mapping each chunk to
    its group). ``device`` defaults to the groups' own when they are
    tensors and to the card when they are numpy arrays (pass ``"cpu"`` for
    the CPU). Same layout as the JAX ``pack_group_data``; ``rows=13`` drops
    the three zero rows.
    """
    if rows not in (13, 16):
        raise ValueError(f"rows must be 13 or 16; got {rows}")
    sizes = [len(g["ps"]) for g in groups]
    padded = [m + (-m) % chunk for m in sizes]
    device = _groups_device(groups, device)
    data = torch.zeros((rows, sum(padded)), dtype=torch.float32, device=device)
    chunk_gid = []
    ofs = 0
    for gi, (g, Mg, Mp) in enumerate(zip(groups, sizes, padded)):
        for r0, key in ((0, "ps"), (3, "ns"), (6, "pt"), (9, "nt")):
            data[r0:r0 + 3, ofs:ofs + Mg] = torch.as_tensor(g[key], device=device).T
        w = g.get("w")
        data[12, ofs:ofs + Mg] = 1.0 if w is None else torch.as_tensor(w, device=device)
        chunk_gid.extend([gi] * (Mp // chunk))
        ofs += Mp
    return data, np.asarray(chunk_gid, np.int32)


def group_moments_on_device(parts, parts_per_chunk: int, chunk_gid, n_groups: int):
    """``(n_groups, 42, 42)`` float32 group moments on ``parts``' device from
    the partial Grams of a moment pass (``ops/gn.py:moment_gram_partials``):
    a group's parts are consecutive, and each group is summed in float64."""
    part_gid = np.repeat(np.asarray(chunk_gid), parts_per_chunk)
    bounds = np.searchsorted(part_gid, np.arange(n_groups + 1))
    return torch.stack([parts[a:b].sum(0, dtype=torch.float64)
                        for a, b in zip(bounds[:-1], bounds[1:])]).to(parts.dtype)


def compute_group_moments_from_packed(data, chunk_gid, n_groups: int,
                                      chunk: int = 49152) -> List[np.ndarray]:
    """Per-group 42x42 float64 moment matrices from a packed tensor
    (``pack_group_data`` layout, per-group padded): one B2 pass gives the
    partial Grams, which are summed per group on the host in float64."""
    parts, per_chunk = moment_gram_partials(data, chunk)
    parts = parts.cpu().numpy().astype(np.float64)
    part_gid = np.repeat(np.asarray(chunk_gid), per_chunk)
    return [parts[part_gid == gi].sum(0) for gi in range(n_groups)]


def compute_group_moments(groups, chunk: int = 49152, device=None) -> List[np.ndarray]:
    """Per-group 42x42 moment matrices, float64 on the host, through the same
    packed B2 pass as the engine; ``device`` as in :func:`pack_group_data`."""
    data, chunk_gid = pack_group_data(groups, chunk, rows=13, device=device)
    return compute_group_moments_from_packed(data, chunk_gid, len(groups), chunk)
