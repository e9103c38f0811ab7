"""Plain geometry shared by the references and the scene generator.

Written from the definitions, with torch only: quaternions and rotation
matrices, SE(3) exp and log in the [translation | rotation] tangent
convention (``t = V(w) u``), the pinhole projection with pixel centres at
integer coordinates, point transforms as matrix products, z-buffers and
square splats. Nothing here imports the measured program.

A :class:`Prec` fixes the arithmetic: ``"float64"`` is the reference's;
``"tf32"`` is the control's, float32 with the operands of every matrix
product rounded to TF32 (10 mantissa bits), as a tensor core computes
products when TF32 is allowed. The rounding is explicit, so the control does
not depend on which kernel a library picks for a small product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INF = float("inf")


class Prec:
    """The arithmetic of a reference run: ``float64`` or ``tf32``."""

    def __init__(self, name: str = "float64"):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def cast(self, x):
        return x.to(self.dtype)

    def mm(self, a, b):
        """``a @ b`` in this precision (TF32 operands for ``tf32``)."""
        a, b = a.to(self.dtype), b.to(self.dtype)
        if self.name == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return a @ b


def tf32_round(x):
    """float32 ``x`` rounded to the nearest TF32 value (ties to even): the
    low 13 of the 23 mantissa bits cleared."""
    i = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


# ---------------------------------------------------------------------------
# Rotations and rigid transforms
# ---------------------------------------------------------------------------


def quat_to_matrix(q):
    """Unit quaternions (..., 4) wxyz -> rotation matrices (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_from_rotvec(w):
    """Rotation vectors (..., 3) -> unit quaternions (..., 4)."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    half = 0.5 * theta
    k = torch.where(theta > 1e-12, torch.sin(half) / theta.clamp(min=1e-30), 0.5 - theta ** 2 / 48)
    return torch.cat([torch.cos(half), k * w], -1)


def skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([z, -w[..., 2], w[..., 1], w[..., 2], z, -w[..., 0],
                        -w[..., 1], w[..., 0], z], -1).reshape(w.shape[:-1] + (3, 3))


def _V(w):
    """The left Jacobian of SO(3): V(w) = I + a [w]x + b [w]x^2."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    a = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2.clamp(min=1e-30))
    b = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / (th2 * th).clamp(min=1e-30))
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def se3_exp(tangent):
    """Tangents (..., 6) = [u | w] -> (q (..., 4), t (..., 3)), t = V(w) u."""
    u, w = tangent[..., :3], tangent[..., 3:]
    return quat_from_rotvec(w), (_V(w) @ u[..., None])[..., 0]


def se3_compose(qa, ta, qb, tb):
    """(a . b): apply b first. Quaternion and translation."""
    q = quat_multiply(qa, qb)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q, (quat_to_matrix(qa) @ tb[..., None])[..., 0] + ta


def se3_log_between(q0, t0, q1, t1):
    """The tangent d (..., 6) with (q1, t1) = exp(d) . (q0, t0), float64."""
    q0, t0, q1, t1 = (x.double() for x in (q0, t0, q1, t1))
    conj = q0 * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q0.dtype, device=q0.device)
    qd = quat_multiply(q1, conj)
    qd = qd / torch.linalg.vector_norm(qd, dim=-1, keepdim=True)
    qd = torch.where(qd[..., :1] < 0, -qd, qd)
    vn = torch.linalg.vector_norm(qd[..., 1:], dim=-1, keepdim=True)
    k = torch.where(vn > 1e-15, 2 * torch.atan2(vn, qd[..., :1]) / vn.clamp(min=1e-300),
                    2.0 / qd[..., :1])
    w = k * qd[..., 1:]
    td = t1 - (quat_to_matrix(qd) @ t0[..., None])[..., 0]
    u = torch.linalg.solve(_V(w), td[..., None])[..., 0]
    return torch.cat([u, w], -1)


def transform(points, R, t, prec: Prec):
    """Camera-frame points ``R p + t`` of world points (N, 3) for one pose
    (R (3,3), t (3,)), as a matrix product in ``prec``."""
    return prec.mm(points, R.transpose(0, 1)) + prec.cast(t)


# ---------------------------------------------------------------------------
# Pinhole projection, z-buffers, splats
# ---------------------------------------------------------------------------


def project(p, fx, fy, cx, cy):
    """Pinhole pixel coordinates (x, y) of camera-frame points (..., 3), and
    whether each lies in front of the camera (z > 1e-6)."""
    X, Y, Z = p.unbind(-1)
    safe = torch.where(Z > 1e-6, Z, torch.ones_like(Z))
    return fx * (X / safe) + cx, fy * (Y / safe) + cy, Z > 1e-6


def zbuffer(pixel, z, n_px: int):
    """Per-pixel minimum of ``z`` at flat pixel ids (-1: none); inf where
    nothing lands."""
    keep = pixel >= 0
    out = torch.full((n_px,), INF, dtype=z.dtype, device=z.device)
    return out.scatter_reduce_(0, pixel[keep], z[keep], reduce="amin", include_self=True)


def min_filter(img, k: int):
    """Minimum over the (2k+1)^2 window of each pixel of (H, W), as two
    passes of 1-D minima (rows, then columns); outside counts as inf."""
    if k == 0:
        return img
    for dim in (1, 0):
        pad = [0, 0, 0, 0]
        pad[2 * (1 - dim)] = pad[2 * (1 - dim) + 1] = k
        p = F.pad(img[None], pad, value=INF)[0]
        n = img.shape[dim]
        img = torch.stack([p.narrow(dim, s, n) for s in range(2 * k + 1)]).amin(0)
    return img


def splat_depth(p, fx, fy, cx, cy, width: int, height: int, radius: float, max_radius_px: int):
    """Depth of square splats: a point at camera-frame p with z > 0 covers
    every pixel whose column and row lie within k = ceil(clamp(f radius / z,
    0, max_radius_px)) of the pixel holding it (floor of its coordinates,
    f = (fx + fy) / 2), at depth z. (H, W), inf where empty. Each size k is
    a z-buffer of the centres, widened by a (2k+1)^2 minimum."""
    x, y, _ = project(p, fx, fy, cx, cy)
    z = p[..., 2]
    front = z > 0
    f = 0.5 * (fx + fy)
    k = torch.ceil(torch.clamp(f * radius / torch.where(front, z, torch.ones_like(z)), 0,
                               max_radius_px)).long()
    R = max_radius_px
    Wp, Hp = width + 2 * R, height + 2 * R
    jx = torch.clamp(torch.floor(x), -R - 1, width + R) + R
    jy = torch.clamp(torch.floor(y), -R - 1, height + R) + R
    inside = front & (jx >= 0) & (jy >= 0) & (jx < Wp) & (jy < Hp)
    out = torch.full((Hp, Wp), INF, dtype=z.dtype, device=z.device)
    for kk in range(R + 1):
        sel = inside & (k == kk)
        pix = torch.where(sel, jy.long() * Wp + jx.long(), -1)
        out = torch.minimum(out, min_filter(zbuffer(pix, z, Hp * Wp).reshape(Hp, Wp), kk))
    return out[R:R + height, R:R + width]

