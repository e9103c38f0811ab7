"""Batched Lie-group math (SO3 / SE3 / Sim3) in torch.

Port of ``dataset_pipeline_tpu/models/lie.py``.
Quaternions are ``(..., 4)`` in ``wxyz`` order, translations ``(..., 3)``;
every function broadcasts over leading dimensions. The closed forms stay
elementwise (no 3x3 matmuls), so results do not depend on a matmul's
precision mode, and ``SE3.exp`` keeps Sophus's ``t = V(w) u``.

Two forms of the rotation: ``quat_rotate`` is the JAX function as it runs op
by op (outside ``jit``), ``quat_rotate_fused`` as XLA's CPU backend compiles
it inside ``jit``, where the cross products and ``w uv + uuv`` become fused
multiply-adds (``addcmul``). Each is bit-equal to its JAX counterpart on the
CPU; the fused form also gives the same bits on the card (one op per kernel:
nothing is left for a compiler to contract in its own way).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS = 1e-8


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def fms(a, b, c, d):
    """``a*b - c*d`` as XLA's CPU backend compiles it inside ``jit``:
    ``fma(a, b, -(c*d))``."""
    return torch.addcmul(-(c * d), a, b)


def dot3_fused(a, b):
    """``sum(a * b, -1)`` over 3-vectors as XLA's CPU backend compiles it
    inside ``jit``: the FMA chain ``fma(a2, b2, fma(a1, b1, a0 b0))``."""
    return torch.addcmul(torch.addcmul(a[..., 0] * b[..., 0], a[..., 1], b[..., 1]),
                         a[..., 2], b[..., 2])


def _cross_fused(a, b):
    """``jnp.cross`` inside ``jit``."""
    a0, a1, a2 = torch.unbind(a, -1)
    b0, b1, b2 = torch.unbind(b, -1)
    return torch.stack([fms(a1, b2, a2, b1), fms(a2, b0, a0, b2), fms(a0, b1, a1, b0)], -1)


def quat_identity(batch_shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_multiply(a, b):
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors ``v (...,3)`` by quaternions ``q (...,4)``."""
    qv = q[..., 1:]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_rotate_fused(q, v):
    """:func:`quat_rotate` as XLA compiles it inside ``jit``."""
    qv = q[..., 1:]
    uv = _cross_fused(qv, v)
    uuv = _cross_fused(qv, uv)
    return v + 2.0 * torch.addcmul(uuv, q[..., :1], uv)


def quat_to_matrix(q):
    w, x, y, z = torch.unbind(q, -1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_to_matrix_np(q):
    """Numpy float64 twin of :func:`quat_to_matrix` for host-side math
    (one quaternion (4,) wxyz -> (3,3))."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_from_matrix(m):
    """Rotation matrix ``(...,3,3)`` -> quaternion wxyz. Branch-free Shepperd."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s = piv(1.0 + tr)
    cw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
    s = piv(1.0 + m00 - m11 - m22)
    cx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)
    s = piv(1.0 - m00 + m11 - m22)
    cy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)
    s = piv(1.0 - m00 - m11 + m22)
    cz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)

    idx = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)
    return quat_normalize(q[..., 0, :])


def so3_exp_quat(w):
    """Axis-angle vector ``(...,3)`` -> unit quaternion."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < _EPS
    half = 0.5 * theta
    # sin(theta/2)/theta with Taylor fallback 0.5 - theta^2/48
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    qw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([qw, k * w], dim=-1)


def so3_log(q):
    """Unit quaternion -> axis-angle vector ``(...,3)``."""
    q = torch.where(q[..., :1] < 0, -q, q)  # w >= 0 branch
    w = q[..., :1]
    v = q[..., 1:]
    vn_sq = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn_sq, min=_EPS * _EPS))
    theta = 2.0 * torch.atan2(vn, w)
    small = vn_sq < _EPS
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / vn)
    return k * v


def skew(w):
    """(...,3) -> (...,3,3) cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    m = torch.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def _apply_V(w, u):
    """V(w) @ u where V = I + (1-cos)/t^2 [w]x + (t-sin)/t^3 [w]x^2."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < _EPS
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    wxu = _cross(w, u)
    wdotu = torch.sum(w * u, dim=-1, keepdim=True)
    wxxu = w * wdotu - theta_sq * u
    return u + a * wxu + b * wxxu


def _apply_V_inv(w, t):
    """V(w)^-1 @ t = t - 0.5 [w]x t + c [w]x^2 t."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < _EPS
    half_theta = 0.5 * theta
    c = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - half_theta * torch.cos(half_theta) / torch.sin(half_theta)) / theta_sq)
    wxt = _cross(w, t)
    wdott = torch.sum(w * t, dim=-1, keepdim=True)
    wxxt = w * wdott - theta_sq * t
    return t - 0.5 * wxt + c * wxxt


class SE3(NamedTuple):
    """Rigid transform: x -> R x + t. ``q`` is wxyz, shape (...,4); ``t`` (...,3)."""

    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        return SE3(quat_identity(batch_shape, dtype, device),
                   torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device))

    @staticmethod
    def from_matrix(m) -> "SE3":
        return SE3(quat_from_matrix(m[..., :3, :3]), m[..., :3, 3])

    @staticmethod
    def from_rt(R, t) -> "SE3":
        return SE3(quat_from_matrix(R), t)

    @property
    def batch_shape(self):
        return self.q.shape[:-1]

    def rotation_matrix(self):
        return quat_to_matrix(self.q)

    def matrix(self):
        """(...,4,4) homogeneous matrix."""
        return _homogeneous(quat_to_matrix(self.q), self.t)

    def apply(self, p):
        """Transform points ``(...,3)``."""
        return quat_rotate(self.q, p) + self.t

    def rotate(self, v):
        return quat_rotate(self.q, v)

    def apply_fused(self, p):
        """:meth:`apply` as XLA compiles it inside ``jit``."""
        return quat_rotate_fused(self.q, p) + self.t

    def inverse(self) -> "SE3":
        qinv = quat_conjugate(self.q)
        return SE3(qinv, -quat_rotate(qinv, self.t))

    def compose(self, other: "SE3") -> "SE3":
        """self @ other (apply ``other`` first)."""
        return SE3(
            quat_normalize(quat_multiply(self.q, other.q)),
            quat_rotate(self.q, other.t) + self.t,
        )

    @staticmethod
    def exp(tangent) -> "SE3":
        """se3 tangent ``(...,6)`` = [translation, rotation] -> SE3
        (Sophus/twist convention ``t = V(w) @ u``)."""
        u, w = tangent[..., :3], tangent[..., 3:]
        return SE3(so3_exp_quat(w), _apply_V(w, u))

    def log(self):
        w = so3_log(self.q)
        return torch.cat([_apply_V_inv(w, self.t), w], dim=-1)

    def cast(self, dtype) -> "SE3":
        return SE3(self.q.to(dtype), self.t.to(dtype))


def _homogeneous(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


class Sim3(NamedTuple):
    """Similarity transform x -> s R x + t (MeshLab ``.mlp`` global poses)."""

    q: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor  # scale (...,)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Sim3":
        return Sim3(quat_identity(batch_shape, dtype, device),
                    torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device),
                    torch.ones(tuple(batch_shape), dtype=dtype, device=device))

    @staticmethod
    def from_matrix(m) -> "Sim3":
        R = m[..., :3, :3]
        s = torch.linalg.matrix_norm(R) / np.sqrt(3.0)
        return Sim3(quat_from_matrix(R / s[..., None, None]), m[..., :3, 3], s)

    @staticmethod
    def from_se3(se3: SE3, scale=None) -> "Sim3":
        s = (torch.ones(se3.batch_shape, dtype=se3.q.dtype, device=se3.q.device)
             if scale is None else scale)
        return Sim3(se3.q, se3.t, s)

    def se3(self) -> SE3:
        return SE3(self.q, self.t)

    def matrix(self):
        return _homogeneous(quat_to_matrix(self.q) * self.s[..., None, None], self.t)

    def apply(self, p):
        return self.s[..., None] * quat_rotate(self.q, p) + self.t

    def inverse(self) -> "Sim3":
        qinv = quat_conjugate(self.q)
        sinv = 1.0 / self.s
        return Sim3(qinv, -sinv[..., None] * quat_rotate(qinv, self.t), sinv)

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(quat_normalize(quat_multiply(self.q, other.q)),
                    self.s[..., None] * quat_rotate(self.q, other.t) + self.t, self.s * other.s)

    def __matmul__(self, other):
        if isinstance(other, Sim3):
            return self.compose(other)
        return self.apply(other)


def average_quaternions(qs, dim: int = 0):
    """Chordal-L2 rotation average: the principal eigenvector of the sum of
    q q^T, by 50 steps of power iteration."""
    qs = torch.where(qs[..., :1] < 0, -qs, qs)
    M = torch.sum(qs[..., :, None] * qs[..., None, :], dim=dim)
    v = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(50):
        v = torch.sum(M * v[..., None, :], dim=-1)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return quat_normalize(v)
