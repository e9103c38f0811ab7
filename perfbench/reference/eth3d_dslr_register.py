"""Plain reference of one LM iteration of the ImageRegistrator on the DSLR scene.

Written from the method's definition (``README.md``, the registrator's
equations), with torch only, for PINHOLE cameras, in float64 (or, as the
control, float32 with TF32 matrix products, :class:`~perfbench.reference.geometry.Prec`):

- image pyramids: level l + 1 is the mean of each 2 x 2 block of level l;
- occlusion: square splats of the scan at every image's pose (geometry.splat_depth);
- visibility of each level point in each image: in front, z-test against the
  occlusion depth at the rounded pixel with a slack, the observation scale
  ``log2(2 radius fx / z)`` within [current scale, scale count - 1), inside
  the border of the coarser interpolation level, not oversaturated there;
- the intensity of a point: trilinear in the pyramid between levels
  floor(s) + 1 and floor(s) at its frozen scale s, with its derivatives;
- residuals: per point and neighbour k, (I[n_k] - I[n]) - d_k for the fixed
  descriptors (scan intensity differences) and the variable ones (the mean
  image-space difference over the images that observe the point and all its
  neighbours, where at least two do), Huber-weighted on the norm of the
  point's residual vector;
- the Jacobian of an intensity over [fx, fy, cx, cy | u, w] of the pose
  update ``exp([u | w]) . pose``, analytic: dI/dpix dpix/dp dp/d(u, w), the
  intrinsics' dpix/dprm, and dI/ds ds/d(.) with s = log2(2 r fx / z);
- H = sum of w D^T D over residual rows D = J[n_k] - J[n], b = sum w D r;
  the cost the weighted mean of the Huber costs per residual type;
- the LM ladder: H with its diagonal times (1 + lambda), the update applied
  as ``params - x``, ``exp(-x_pose) . pose``, accepted when the cost with the
  frozen visibility falls, lambda halved, else doubled, ten tries, the last
  applied.

State: ``params`` (4,), ``q`` (B, 4) wxyz, ``t`` (B, 3) image_T_world.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.geometry import (
    Prec,
    project,
    quat_to_matrix,
    se3_compose,
    se3_exp,
    splat_depth,
    transform,
)

HUBER = 30.0 * math.sqrt(5.0) / math.sqrt(2.0)
LN2 = math.log(2.0)
N_INTR = 4


def image_pyramid(images, levels: int, prec: Prec):
    """(B, H, W) images -> per level (B, H_l, W_l): 2 x 2 block means, an
    odd last row or column left out."""
    pyr = [prec.cast(images.float())]
    for _ in range(1, levels):
        b, h, w = pyr[-1].shape
        c = pyr[-1][:, :h // 2 * 2, :w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2)
        pyr.append(c.sum((2, 4)) / 4)
    return pyr


def bilinear(img, l: int, x, y):
    """Bilinear value and derivatives by full-resolution pixel (dx, dy) of
    level image ``img`` (H_l, W_l) at full-resolution coordinates x, y, and
    whether all four taps lie inside."""
    H, W = img.shape
    f = 2.0 ** -l
    xl, yl = f * (x + 0.5) - 0.5, f * (y + 0.5) - 0.5
    fx0, fy0 = torch.floor(xl), torch.floor(yl)
    ok = (xl >= 0) & (yl >= 0) & (fx0 < W - 1) & (fy0 < H - 1)
    ix = torch.clamp(torch.nan_to_num(fx0), 0, max(W - 2, 0))
    iy = torch.clamp(torch.nan_to_num(fy0), 0, max(H - 2, 0))
    i, j = ix.long(), iy.long()
    tl, tr, bl, br = img[j, i], img[j, i + 1], img[j + 1, i], img[j + 1, i + 1]
    ax, ay = xl - ix, yl - iy
    top, bottom = tl + ax * (tr - tl), bl + ax * (br - bl)
    value = top + ay * (bottom - top)
    dx = ((1 - ay) * (tr - tl) + ay * (br - bl)) * f
    dy = (bottom - top) * f
    return value, dx, dy, ok


def trilinear(pyr_b, x, y, s):
    """Value and derivatives (by x, y and scale) of image ``pyr_b`` (its
    levels) at full-resolution x, y and continuous scale s, and validity."""
    L = len(pyr_b)
    fs = torch.floor(s)
    coarse = torch.where(torch.isfinite(s), torch.clamp(torch.nan_to_num(fs) + 1, 1, L - 1),
                         torch.ones_like(s)).long()
    a = 1.0 - (s - fs)  # the finer level's weight
    out = [torch.zeros_like(x) for _ in range(6)]  # vc, dxc, dyc, vf, dxf, dyf
    ok = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    okc = torch.zeros_like(ok)
    for l in range(1, L):
        sel = torch.nonzero(coarse == l)[:, 0]
        if sel.numel() == 0:
            continue
        xs, ys = x[sel], y[sel]
        vc, dxc, dyc, oc = bilinear(pyr_b[l], l, xs, ys)
        vf, dxf, dyf, of = bilinear(pyr_b[l - 1], l - 1, xs, ys)
        for o, v in zip(out, (vc, dxc, dyc, vf, dxf, dyf)):
            o[sel] = v
        ok[sel] = of
        okc[sel] = oc
    vc, dxc, dyc, vf, dxf, dyf = out
    value = (1 - a) * vc + a * vf
    return value, (1 - a) * dxc + a * dxf, (1 - a) * dyc + a * dyf, vc - vf, ok & okc


class RegistratorReference:
    """The registrator's LM iteration on ``scene`` (perfbench.scene.dslr)
    with the settings of configuration ``cfg`` (its ``registrator`` group)."""

    def __init__(self, scene, cfg: dict, prec: Prec):
        self.prec = prec
        self.cfg = cfg
        self.W, self.H = scene.width, scene.height
        self.pyr = image_pyramid(scene.images, cfg["scale_count"], prec)
        self.scan = scene.scan
        self.levels = []
        for lv in scene.levels:
            inten = prec.cast(lv.intensities)
            self.levels.append(dict(points=lv.points, radius=lv.radius, neighbors=lv.neighbors,
                                    fixed=inten[lv.neighbors] - inten[:, None]))
        self.B = scene.images.shape[0]
        self.V = N_INTR + 6 * self.B

    # -- state -----------------------------------------------------------------

    def _pose(self, q, t, b):
        return quat_to_matrix(q[b].double()), t[b].double()

    def _cam(self, params):
        p = self.prec.cast(params)
        return p[0], p[1], p[2], p[3]

    def _points_cam(self, pts, q, t, b):
        R, tt = self._pose(q, t, b)
        return transform(pts, R, tt, self.prec)

    # -- occlusion and visibility ----------------------------------------------

    def occlusion(self, params, q, t):
        """(B, H, W) splat depth of the scan in every image."""
        fx, fy, cx, cy = self._cam(params)
        return torch.stack([
            splat_depth(self._points_cam(self.scan, q, t, b), fx, fy, cx, cy, self.W, self.H,
                        self.cfg["occlusion_radius"], self.cfg["max_radius_px"])
            for b in range(self.B)])

    def visibility(self, params, q, t, occl, current_scale: int):
        """Per level (mask (B, N) bool, scale (B, N))."""
        c = self.cfg
        fx, fy, cx, cy = self._cam(params)
        L = c["scale_count"]
        out = []
        for lv in self.levels:
            masks, scales = [], []
            for b in range(self.B):
                p = self._points_cam(lv["points"], q, t, b)
                x, y, ok = project(p, fx, fy, cx, cy)
                z = p[:, 2]
                ix = torch.clamp(torch.round(torch.nan_to_num(x)), 0, self.W - 1).long()
                iy = torch.clamp(torch.round(torch.nan_to_num(y)), 0, self.H - 1).long()
                ok = ok & (z <= occl[b][iy, ix] + c["occlusion_depth_threshold"]) & (z > c["min_depth"])
                s = torch.log2(torch.clamp(2.0 * lv["radius"] * fx / z, min=1e-12))
                fs = torch.floor(s)
                ok = ok & (s >= current_scale) & (fs < L - 1) & (s >= 0)
                f = torch.pow(2.0, -(fs + 1))
                xs, ys = f * (x + 0.5) - 0.5, f * (y + 0.5) - 0.5
                ws, hs = torch.floor(self.W * f + 0.5), torch.floor(self.H * f + 0.5)
                ok = ok & (xs + 0.5 >= 1) & (ys + 0.5 >= 1) & (xs + 0.5 < ws - 1) & (ys + 0.5 < hs - 1)
                # oversaturated at the coarser interpolation level
                si = torch.nan_to_num(fs) + 1
                sic = torch.clamp(si, 1, L - 1).long()
                bad = torch.zeros_like(ok)
                for l in range(1, L):
                    sel = sic == l
                    img = self.pyr[l][b]
                    g = 2.0 ** -l
                    jx = torch.clamp(torch.floor(g * (x[sel] + 0.5) - 0.5 + 0.5), 0, img.shape[1] - 1)
                    jy = torch.clamp(torch.floor(g * (y[sel] + 0.5) - 0.5 + 0.5), 0, img.shape[0] - 1)
                    bad[sel] = img[jy.long(), jx.long()] > c["max_valid_intensity"]
                ok = ok & ~(bad & (si >= 1) & (si <= L - 1))
                masks.append(ok)
                scales.append(s)
            out.append((torch.stack(masks), torch.stack(scales)))
        return out

    # -- intensities, descriptors, cost ----------------------------------------

    def _intensities(self, params, q, t, b, lv, s, derivs: bool):
        """Per point of level ``lv`` in image b at frozen scales s: (value,
        ok) and, with ``derivs``, the Jacobian (N, 10) over [4 intrinsics |
        u | w]."""
        fx, fy, cx, cy = self._cam(params)
        p = self._points_cam(lv["points"], q, t, b)
        x, y, front = project(p, fx, fy, cx, cy)
        v, gx, gy, gs, ok = trilinear(self.pyr_b(b), x, y, s)
        ok = ok & front & torch.isfinite(x) & torch.isfinite(y)
        if not derivs:
            return v, ok, None
        X, Y, Z = p.unbind(-1)
        a = 1.0 / torch.where(front, Z, torch.ones_like(Z))
        # dI/dp through the pixel and through the scale s = log2(2 r fx / z)
        dIdp = torch.stack([gx * fx * a, gy * fy * a,
                            -(gx * fx * X + gy * fy * Y) * a * a - gs * a / LN2], -1)
        # dp/du = I, dp/dw = -[p]x
        dIdw = torch.linalg.cross(p, dIdp, dim=-1)
        J = torch.stack([gx * X * a + gs / (fx * LN2), gy * Y * a, gx, gy], -1)
        return v, ok, torch.cat([J, dIdp, dIdw], -1)

    def pyr_b(self, b):
        return [lvl[b] for lvl in self.pyr]

    def _residual_sets(self, l, vdesc):
        sets = [(self.levels[l]["fixed"], None, self.cfg["fixed_weight"])]
        if vdesc is not None and self.cfg["variable_weight"] > 0:
            desc, mask2 = vdesc[l]
            sets.append((desc, mask2, self.cfg["variable_weight"]))
        return sets

    def var_desc(self, params, q, t, vis):
        """Per level (mean image-space descriptor (N, K), observed by >= 2
        images (N,))."""
        out = []
        for l, lv in enumerate(self.levels):
            mask, s = vis[l]
            nbr = lv["neighbors"]
            total = torch.zeros(lv["fixed"].shape, dtype=self.prec.dtype, device=nbr.device)
            count = torch.zeros(nbr.shape[0], dtype=torch.int64, device=nbr.device)
            for b in range(self.B):
                v, ok, _ = self._intensities(params, q, t, b, lv, s[b], False)
                full = ok & ok[nbr].all(1) & mask[b]
                total += torch.where(full[:, None], v[nbr] - v[:, None], 0.0)
                count += full
            out.append((total / torch.clamp(count, min=1)[:, None], count >= 2))
        return out

    def _residuals(self, v, ok, nbr, desc, contrib):
        full = ok & ok[nbr].all(1) & contrib
        r = torch.where(full[:, None], (v[nbr] - v[:, None]) - desc, 0.0)
        norm = torch.sqrt(torch.clamp((r * r).sum(1), min=1e-20))
        rho = torch.where(norm <= HUBER, 0.5 * norm * norm, HUBER * (norm - 0.5 * HUBER))
        w = torch.where(norm <= HUBER, torch.ones_like(norm), HUBER / norm)
        return full, r, torch.where(full, rho, 0.0), torch.where(full, w, 0.0)

    def _mean_cost(self, sums):
        return sum(w * s / max(n, 1) for w, s, n in sums.values())

    def accumulate(self, params, q, t, vis, vdesc):
        """(H (V, V), b (V,), cost, S = sum of weight x Huber weight x r^2) in
        float64."""
        H = torch.zeros((self.V, self.V), dtype=torch.float64, device=self.scan.device)
        g = torch.zeros(self.V, dtype=torch.float64, device=self.scan.device)
        sums, S = {}, 0.0
        for b in range(self.B):
            idx = torch.tensor(list(range(N_INTR)) + list(range(N_INTR + 6 * b, N_INTR + 6 * b + 6)),
                               device=H.device)
            for l, lv in enumerate(self.levels):
                mask, s = vis[l]
                nbr = lv["neighbors"]
                v, ok, J = self._intensities(params, q, t, b, lv, s[b], True)
                for ti, (desc, mask2, wt) in enumerate(self._residual_sets(l, vdesc)):
                    contrib = mask[b] if mask2 is None else mask[b] & mask2
                    full, r, rho, w = self._residuals(v, ok, nbr, desc, contrib)
                    sel = torch.nonzero(full)[:, 0]
                    D = J[nbr[sel]] - J[sel][:, None, :]  # (n, K, 10)
                    sw = torch.sqrt(wt * w[sel])[:, None, None]
                    Dw = (D * sw).reshape(-1, D.shape[-1])
                    Hb = self.prec.mm(Dw.transpose(0, 1), Dw).double()
                    gb = self.prec.mm(Dw.transpose(0, 1), (r[sel][..., None] * sw).reshape(-1, 1))
                    H[idx[:, None], idx[None, :]] += Hb
                    g[idx] += gb[:, 0].double()
                    S += float((wt * w[sel] * (r[sel] ** 2).sum(1)).sum())
                    ws, ss, n = sums.get(ti, (wt, 0.0, 0))
                    sums[ti] = (ws, ss + float(rho.sum()), n + int(full.sum()))
        return H, g, self._mean_cost(sums), S

    def cost(self, params, q, t, vis, vdesc) -> float:
        sums = {}
        for b in range(self.B):
            for l, lv in enumerate(self.levels):
                mask, s = vis[l]
                v, ok, _ = self._intensities(params, q, t, b, lv, s[b], False)
                for ti, (desc, mask2, wt) in enumerate(self._residual_sets(l, vdesc)):
                    contrib = mask[b] if mask2 is None else mask[b] & mask2
                    full, _, rho, _ = self._residuals(v, ok, lv["neighbors"], desc, contrib)
                    ws, ss, n = sums.get(ti, (wt, 0.0, 0))
                    sums[ti] = (ws, ss + float(rho.sum()), n + int(full.sum()))
        return self._mean_cost(sums)

    # -- the LM ladder ---------------------------------------------------------

    def candidate(self, params, q, t, x):
        """The state after the update ``x`` (V,): ``params - x[:4]``,
        ``exp(-x_pose) . pose``."""
        dq, dt = se3_exp(-x[N_INTR:].reshape(self.B, 6))
        qn, tn = se3_compose(dq, dt, q.double(), t.double())
        return params.double() - x[:N_INTR], qn, tn

    def lm_step(self, H, g, initial: float, lam: float, params, q, t, vis, vdesc):
        """The damped ladder: (update x, params, q, t, lambda after, applied)."""
        for attempt in range(10):
            Hl = H.clone()
            Hl.diagonal().mul_(1.0 + lam)
            try:
                x = torch.linalg.solve(Hl, g)
            except RuntimeError:
                lam *= 2.0
                continue
            pn, qn, tn = self.candidate(params, q, t, x)
            if self.cost(pn, qn, tn, vis, vdesc) < initial or attempt == 9:
                return x, pn, qn, tn, lam * 0.5, True
            lam *= 2.0
        return None, params, q, t, lam, False

    def iteration(self, params, q, t, current_scale: int, lam: float, step: bool = True):
        """Everything one LM iteration computes from the state (params, q,
        t): occlusion, visibility, variable descriptors, H, b, cost and, with
        ``step``, the ladder's update ``x`` and ``next``, the state it leaves
        with lambda after."""
        occl = self.occlusion(params, q, t)
        vis = self.visibility(params, q, t, occl, current_scale)
        vdesc = self.var_desc(params, q, t, vis) if self.cfg["variable_weight"] > 0 else None
        H, g, cost, S = self.accumulate(params, q, t, vis, vdesc)
        out = dict(occl=occl, vis=vis, H=H, b=g, cost=cost, S=S)
        if step:
            x, pn, qn, tn, lam, _ = self.lm_step(H, g, cost, lam, params, q, t, vis, vdesc)
            out.update(x=x, next=((pn, qn, tn), lam))
        return out
