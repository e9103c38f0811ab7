"""Plain reference of one LM iteration of the ImageRegistrator under ETH3D's
DSLR camera model, THIN_PRISM_FISHEYE.

Written from the model's definition (COLMAP's and the ETH3D pipeline's
"benchmark camera": 12 parameters fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1), with
torch only, in float64 (or, as the control, float32 with TF32 matrix
products, :class:`~perfbench.reference.geometry.Prec`). What the pinhole
reference (``eth3d_dslr_register.py``) computes, with the lens in place of
the pinhole:

- projection: n = p.xy / z; the equidistant pre-warp w = n atan(|n|) / |n|
  (w = n below |n| = 1e-6); the distortion w (1 + k1 r2 + k2 r2^2 + k3 r2^3
  + k4 r2^4) + (2 p1 x y + p2 (r2 + 2 x^2), 2 p2 x y + p1 (r2 + 2 y^2)) +
  (sx1 r2, sy1 r2), r2 = |w|^2; pixels f * that + c. A point projects if z >
  1e-6, r2 <= the radius cutoff and the pixel is finite;
- the radius cutoff: 1.01 x the largest r2 of the image border, by the
  inverse of the distortion at 64 samples of each side (the model is
  monotonic over the image, so each has one inverse);
- occlusion: square splats of the scan centred at the projected pixels of
  the points that project (``lens_splat_depth``); the pixel radius f r / z;
- the observation scale of a point: the finite difference of the
  projection that the registrator defines, log2(2 r |pix(p + (e, 0, 0)) -
  pix(p)| / e), e = 1e-3 max(z, 1e-6). The reference takes this definition
  (in float64), not the analytic limit e -> 0;
- the Jacobian of an intensity over [12 intrinsics | u, w] of the pose
  update ``exp([u | w]) . pose``: dI/dpix dpix/d(.) + dI/ds ds/d(.), the
  derivatives of the projection and of that footprint by ``torch.func.jvp``
  in the reference's precision (autodiff of the plain formulas above), in
  blocks of points;
- a point whose scale lies within ``scale_band`` of an integer (every scale
  threshold is one) takes the compared run's scale where that lies within
  ``scale_band`` of the reference's own
  (:meth:`FisheyeRegistratorReference.visibility`): under the lens the scale
  varies over the image, so points sit on the threshold s = 0 that the
  pinhole scene keeps clear of, and the float32 finite difference, ~1e-4
  off, puts them on either side, where the trilinear sample also changes its
  pair of levels. The reference's own projection, occlusion and pyramid
  decide such a point's visibility at that scale; a point of the band whose
  compared scale lies further off, and which either run counts visible, is a
  disagreement (``off``).

The Jacobian runs in blocks of ``BLOCK`` points and the Gram sums in blocks
of ``GRAM_BLOCK`` residual points, so that the reference fits beside the
program's scene at 6048x4032.

State: ``params`` (12,), ``q`` (B, 4) wxyz, ``t`` (B, 3) image_T_world.
"""

from __future__ import annotations

import torch

from perfbench.reference.eth3d_dslr_register import RegistratorReference, trilinear
from perfbench.reference.geometry import INF, Prec, min_filter, se3_compose, se3_exp, zbuffer

N_INTR = 12
BLOCK = 1 << 19  # points per block of the Jacobian (18 tangents each)
GRAM_BLOCK = 1 << 20  # residual points per block of the Gram sums
EPS = 1e-6


# ---------------------------------------------------------------------------
# The lens
# ---------------------------------------------------------------------------


def distort(k, wx, wy):
    """The thin-prism distortion of the pre-warped point (wx, wy); ``k`` =
    [k1, k2, p1, p2, k3, k4, sx1, sy1]."""
    k1, k2, p1, p2, k3, k4, sx1, sy1 = k.unbind(-1)
    r2 = wx * wx + wy * wy
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    return (wx * radial + 2 * p1 * wx * wy + p2 * (r2 + 2 * wx * wx) + sx1 * r2,
            wy * radial + 2 * p2 * wx * wy + p1 * (r2 + 2 * wy * wy) + sy1 * r2)


def prewarp(nx, ny):
    """The equidistant pre-warp n -> n atan(|n|) / |n| and its r2."""
    r = torch.sqrt(torch.clamp(nx * nx + ny * ny, min=EPS * EPS))
    g = torch.where(r < EPS, torch.ones_like(r), torch.atan(r) / r)
    wx, wy = nx * g, ny * g
    return wx, wy, wx * wx + wy * wy


def lens_project(p, prm, cutoff_sq):
    """Pixels (x, y) of camera-frame points (..., 3) and whether each
    projects (in front, inside the cutoff, finite)."""
    X, Y, Z = p.unbind(-1)
    safe = torch.where(Z.abs() < EPS, torch.full_like(Z, EPS), Z)
    wx, wy, r2 = prewarp(X / safe, Y / safe)
    dx, dy = distort(prm[4:], wx, wy)
    x, y = prm[0] * dx + prm[2], prm[1] * dy + prm[3]
    ok = (Z > EPS) & (r2 <= cutoff_sq) & torch.isfinite(x) & torch.isfinite(y)
    return x, y, ok


def footprint(p, prm, radius, cutoff_sq):
    """The observation scale log2(2 r |pix(p + (e,0,0)) - pix(p)| / e), e =
    1e-3 max(z, 1e-6), of camera-frame points (..., 3)."""
    x, y, _ = lens_project(p, prm, cutoff_sq)
    e = 1e-3 * torch.clamp(p[..., 2], min=EPS)
    p2 = torch.stack([p[..., 0] + e, p[..., 1], p[..., 2]], -1)
    x2, y2, _ = lens_project(p2, prm, cutoff_sq)
    ppm = torch.sqrt((x2 - x) ** 2 + (y2 - y) ** 2) / e
    return torch.log2(torch.clamp(2.0 * radius * ppm, min=1e-12))


def distort_jacobian(k, wx, wy):
    """d distort / d (wx, wy): (a00, a01, a10, a11)."""
    k1, k2, p1, p2, k3, k4, sx1, sy1 = k.unbind(-1)
    r2 = wx * wx + wy * wy
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    drad = k1 + r2 * (2 * k2 + r2 * (3 * k3 + r2 * 4 * k4))
    xy = 2 * wx * wy * drad
    return (radial + 2 * wx * wx * drad + 2 * p1 * wy + 6 * p2 * wx + 2 * sx1 * wx,
            xy + 2 * p1 * wx + 2 * p2 * wy + 2 * sx1 * wy,
            xy + 2 * p2 * wy + 2 * p1 * wx + 2 * sy1 * wx,
            radial + 2 * wy * wy * drad + 2 * p2 * wx + 6 * p1 * wy + 2 * sy1 * wy)


def undistort(prm, u, v, iters: int = 12):
    """The pre-warped point w whose pixel is (u, v): Newton on the
    distortion from w = the distorted point. Returns (wx, wy, the largest
    residual in pixels)."""
    dx0, dy0 = (u - prm[2]) / prm[0], (v - prm[3]) / prm[1]
    wx, wy = dx0.clone(), dy0.clone()
    for _ in range(iters):
        fx, fy = distort(prm[4:], wx, wy)
        ex, ey = fx - dx0, fy - dy0
        a, b, c, d = distort_jacobian(prm[4:], wx, wy)
        det = a * d - b * c
        wx, wy = wx - (d * ex - b * ey) / det, wy - (a * ey - c * ex) / det
    fx, fy = distort(prm[4:], wx, wy)
    res = torch.maximum(prm[0] * (fx - dx0).abs(), prm[1] * (fy - dy0).abs())
    return wx, wy, float(res.max())


def unwarp(wx, wy):
    """The inverse of the pre-warp: w -> w tan(|w|) / |w| (|w| < pi / 2)."""
    r = torch.sqrt(wx * wx + wy * wy)
    g = torch.where(r < EPS, torch.ones_like(r), torch.tan(r) / r.clamp(min=EPS))
    return wx * g, wy * g


def radius_cutoff_sq(params, width: int, height: int, samples: int = 64) -> float:
    """1.01 x the largest pre-warped r2 of ``samples`` points on each side
    of the image (pixel centres at integers)."""
    prm = params.double()
    xs = torch.linspace(0.0, width - 1.0, samples, dtype=torch.float64, device=prm.device)
    ys = torch.linspace(0.0, height - 1.0, samples, dtype=torch.float64, device=prm.device)
    u = torch.cat([xs, xs, torch.zeros_like(ys), torch.full_like(ys, width - 1.0)])
    v = torch.cat([torch.zeros_like(xs), torch.full_like(xs, height - 1.0), ys, ys])
    wx, wy, _ = undistort(prm, u, v)
    return 1.01 * float((wx * wx + wy * wy).max())


def lens_splat_depth(p, prm, cutoff_sq, width: int, height: int, radius: float, max_radius_px: int):
    """Square splats centred through the lens: a point that projects covers
    every pixel whose column and row lie within k = ceil(clamp(f radius / z,
    0, max_radius_px)) of the pixel holding its projection (floor of its
    coordinates, f = (fx + fy) / 2), at depth z. (H, W), inf where empty."""
    x, y, ok = lens_project(p, prm, cutoff_sq)
    z = p[..., 2]
    f = 0.5 * (prm[0] + prm[1])
    k = torch.ceil(torch.clamp(f * radius / torch.where(ok, z, torch.ones_like(z)), 0,
                               max_radius_px)).long()
    R = max_radius_px
    Wp, Hp = width + 2 * R, height + 2 * R
    jx = torch.clamp(torch.floor(torch.nan_to_num(x)), -R - 1, width + R) + R
    jy = torch.clamp(torch.floor(torch.nan_to_num(y)), -R - 1, height + R) + R
    inside = ok & (jx >= 0) & (jy >= 0) & (jx < Wp) & (jy < Hp)
    out = torch.full((Hp, Wp), INF, dtype=z.dtype, device=z.device)
    for kk in range(R + 1):
        sel = inside & (k == kk)
        pix = torch.where(sel, jy.long() * Wp + jx.long(), -1)
        out = torch.minimum(out, min_filter(zbuffer(pix, z, Hp * Wp).reshape(Hp, Wp), kk))
    return out[R:R + height, R:R + width]


# ---------------------------------------------------------------------------
# The registrator's iteration under the lens
# ---------------------------------------------------------------------------


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


class FisheyeRegistratorReference(RegistratorReference):
    """The registrator's LM iteration on ``scene`` (perfbench.scene.dslr_fisheye)
    under THIN_PRISM_FISHEYE, with the settings of configuration ``cfg`` (its
    ``registrator`` group). The radius cutoff is the start intrinsics', as
    the program's camera keeps the one it was made with."""

    def __init__(self, scene, cfg: dict, prec: Prec):
        super().__init__(scene, cfg, prec)
        self.V = N_INTR + 6 * self.B
        self.cutoff_sq = radius_cutoff_sq(scene.params, self.W, self.H)

    def occlusion(self, params, q, t):
        prm = self.prec.cast(params)
        return torch.stack([
            lens_splat_depth(self._points_cam(self.scan, q, t, b), prm, self.cutoff_sq, self.W,
                             self.H, self.cfg["occlusion_radius"], self.cfg["max_radius_px"])
            for b in range(self.B)])

    def visibility(self, params, q, t, occl, current_scale: int, decided=None,
                   band: float = 0.0):
        """Per level (mask (B, N) bool, scale (B, N)), as the pinhole
        reference's with the lens's projection and footprint, and per level
        ``off`` (B, N) bool. ``decided``: per level the (B, N) masks and
        scales of the run this one is compared with. A point whose own
        scale lies within ``band`` of an integer takes the compared scale
        where that lies within ``band`` of its own, for its scale tests and
        its trilinear sample alike (a point visible only at the compared
        scale would otherwise be sampled at the other); its projection,
        occlusion and pyramid stay the reference's. ``off`` marks the other
        points within the band that either run counts visible."""
        c = self.cfg
        prm = self.prec.cast(params)
        vis, offs = [], []
        for l, lv in enumerate(self.levels):
            masks, scales, off = [], [], []
            for b in range(self.B):
                p = self._points_cam(lv["points"], q, t, b)
                x, y, ok = lens_project(p, prm, self.cutoff_sq)
                z = p[:, 2]
                ix = torch.clamp(torch.round(torch.nan_to_num(x)), 0, self.W - 1).long()
                iy = torch.clamp(torch.round(torch.nan_to_num(y)), 0, self.H - 1).long()
                ok = ok & (z <= occl[b][iy, ix] + c["occlusion_depth_threshold"]) & (z > c["min_depth"])
                s = footprint(p, prm, lv["radius"], self.cutoff_sq)
                near = agree = dm = torch.zeros_like(ok)
                if decided is not None:
                    dm, ds = decided[l][0][b].to(ok.device), decided[l][1][b].to(s)
                    near = (s - torch.round(s)).abs() < band
                    agree = near & ((ds - s).abs() < band)
                    s = torch.where(agree, ds, s)
                mask = ok & self._scale_tests(x, y, s, b, current_scale)
                masks.append(mask)
                scales.append(s)
                off.append(near & ~agree & (mask | dm))
            vis.append((torch.stack(masks), torch.stack(scales)))
            offs.append(torch.stack(off))
        return vis, offs

    def _scale_tests(self, x, y, s, b, current_scale: int):
        """The visibility tests that read the scale s of pixels (x, y) in
        image b: the scale range, the interpolation level's bounds, and no
        oversaturated pixel at the coarser level."""
        c = self.cfg
        L = c["scale_count"]
        fs = torch.floor(s)
        ok = (s >= current_scale) & (fs < L - 1) & (s >= 0)
        f = torch.pow(2.0, -(fs + 1))
        xs, ys = f * (x + 0.5) - 0.5, f * (y + 0.5) - 0.5
        ws, hs = torch.floor(self.W * f + 0.5), torch.floor(self.H * f + 0.5)
        ok = ok & (xs + 0.5 >= 1) & (ys + 0.5 >= 1) & (xs + 0.5 < ws - 1) & (ys + 0.5 < hs - 1)
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
        return ok & ~(bad & (si >= 1) & (si <= L - 1))

    def _tangents(self, p, prm, radius):
        """(dx, dy, ds) (N, 18) each: the derivatives of the pixel and of the
        footprint over [12 intrinsics | u | w] of ``exp([u | w]) . pose`` at
        0, by ``torch.func.jvp`` over each basis vector."""
        def geom(eps, k):
            pp = p + eps[:3] + _cross(eps[3:].expand_as(p), p)
            x, y, _ = lens_project(pp, k, self.cutoff_sq)
            return x, y, footprint(pp, k, radius, self.cutoff_sq)

        eye = torch.eye(N_INTR + 6, dtype=p.dtype, device=p.device)
        eps0 = torch.zeros(6, dtype=p.dtype, device=p.device)

        def column(v):
            return torch.func.jvp(geom, (eps0, prm), (v[N_INTR:], v[:N_INTR]))[1]

        return torch.func.vmap(column, out_dims=-1)(eye)

    def _intensities(self, params, q, t, b, lv, s, derivs: bool):
        """Per point of level ``lv`` in image b at frozen scales s: (value,
        ok) and, with ``derivs``, the Jacobian (N, 18) over [12 intrinsics |
        u | w]."""
        prm = self.prec.cast(params)
        p = self._points_cam(lv["points"], q, t, b)
        x, y, front = lens_project(p, prm, self.cutoff_sq)
        v, gx, gy, gs, ok = trilinear(self.pyr_b(b), x, y, s)
        ok = ok & front
        if not derivs:
            return v, ok, None
        J = torch.empty((p.shape[0], N_INTR + 6), dtype=p.dtype, device=p.device)
        for a in range(0, p.shape[0], BLOCK):
            sl = slice(a, a + BLOCK)
            dx, dy, ds = self._tangents(p[sl], prm, lv["radius"])
            J[sl] = gx[sl, None] * dx + gy[sl, None] * dy + gs[sl, None] * ds
        return v, ok, J

    def accumulate(self, params, q, t, vis, vdesc):
        """(H (V, V), b (V,), cost, S = sum of weight x Huber weight x r^2) in
        float64, the residual rows' Gram sums in blocks."""
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
                    sel_all = torch.nonzero(full)[:, 0]
                    for a in range(0, sel_all.shape[0], GRAM_BLOCK):
                        sel = sel_all[a:a + GRAM_BLOCK]
                        D = J[nbr[sel]] - J[sel][:, None, :]  # (n, K, 18)
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

    def iteration(self, params, q, t, current_scale: int, lam: float, step: bool = True,
                  decided=None, band: float = 0.0):
        """As the pinhole reference's iteration. ``decided``: per level (B,
        N) visibility masks and scales of the run this one is compared
        with, which decide the points on a scale threshold as
        :meth:`visibility` says; ``off`` in the result marks the points of
        the band where the two scales disagree."""
        occl = self.occlusion(params, q, t)
        vis, off = self.visibility(params, q, t, occl, current_scale, decided, band)
        vdesc = self.var_desc(params, q, t, vis) if self.cfg["variable_weight"] > 0 else None
        H, g, cost, S = self.accumulate(params, q, t, vis, vdesc)
        out = dict(occl=occl, vis=vis, off=off, H=H, b=g, cost=cost, S=S)
        if step:
            x, pn, qn, tn, lam, _ = self.lm_step(H, g, cost, lam, params, q, t, vis, vdesc)
            out.update(x=x, next=((pn, qn, tn), lam))
        return out

    def candidate(self, params, q, t, x):
        """The state after the update ``x`` (V,): ``params - x[:12]``,
        ``exp(-x_pose) . pose``."""
        dq, dt = se3_exp(-x[N_INTR:].reshape(self.B, 6))
        qn, tn = se3_compose(dq, dt, q.double(), t.double())
        return params.double() - x[:N_INTR], qn, tn
