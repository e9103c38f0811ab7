"""Camera distortion models in torch: the 14 COLMAP models, both directions.

Port of ``dataset_pipeline_tpu/models/cameras.py``: the forward path
(``project``, ``distort``, ``normalized_to_image``, ``in_image``,
``scaled_by``, ``make_camera``, ``init_cutoff``), the inverse path
(``undistort``, ``image_to_normalized``, ``unproject`` by the fixed-count
Gauss-Newton undistortion, and the undistortion lookup table), and the
projection Jacobians by ``torch.func.jacfwd`` under ``vmap``. A :class:`Camera` carries a
static model name and size plus a flat COLMAP-ordered parameter tensor, so
``torch.func.jacfwd`` differentiates through :meth:`Camera.with_params`.

Distortion formulas and parameter layouts are those of the JAX module (radial,
tangential, rational, thin prism, FOV, and the equidistant fisheye pre-warp
``n -> n atan(r)/r``). Pixel centers sit at integer coordinates; the COLMAP
principal point is shifted by -0.5 at the I/O boundary (``io/state.py``).

Squared norms of 2-vectors are the FMA form ``addcmul(x*x, y, y)``, the bits
of XLA's CPU ``sum(xy * xy, -1)``. ``project(..., fused=True)`` ends in the
FMA ``addcmul(c, xy, f)`` that XLA makes of ``xy * f + c`` inside ``jit``
(outside ``jit`` JAX multiplies, then adds): bit-equal to the JAX function in
either context for the models without distortion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from dataset_pipeline_tpu_torch import default_device

_EPS = 1e-6


def _sqnorm(xy, keepdim: bool = True):
    r2 = torch.addcmul(xy[..., 0] * xy[..., 0], xy[..., 1], xy[..., 1])
    return r2[..., None] if keepdim else r2


# ---------------------------------------------------------------------------
# Distortion functions: (dist_params, xy (...,2)) -> xy (...,2)
# ---------------------------------------------------------------------------


def _dist_none(k, xy):
    return xy


def _dist_poly1(k, xy):
    r2 = _sqnorm(xy)
    return xy * (1.0 + r2 * k[0])


def _dist_poly2(k, xy):
    r2 = _sqnorm(xy)
    return xy * (1.0 + r2 * (k[0] + r2 * k[1]))


def _dist_poly3(k, xy):
    r2 = _sqnorm(xy)
    return xy * (1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2])))


def _dist_poly4(k, xy):
    r2 = _sqnorm(xy)
    return xy * (1.0 + r2 * (k[0] + r2 * (k[1] + r2 * (k[2] + r2 * k[3]))))


def _tangential(p1, p2, xy):
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([dx, dy], -1)


def _dist_opencv(k, xy):
    # k = [k1, k2, p1, p2]
    r2 = _sqnorm(xy)
    radial = 1.0 + r2 * (k[0] + r2 * k[1])
    return xy * radial + _tangential(k[2], k[3], xy)


def _dist_full_opencv(k, xy):
    # k = [k1, k2, p1, p2, k3, k4, k5, k6]
    r2 = _sqnorm(xy)
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k[0] * r2 + k[1] * r4 + k[4] * r6) / (
        1.0 + k[5] * r2 + k[6] * r4 + k[7] * r6)
    return xy * radial + _tangential(k[2], k[3], xy)


def _dist_thin_prism(k, xy):
    # k = [k1, k2, p1, p2, k3, k4, sx1, sy1]
    r2 = _sqnorm(xy)
    radial = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * (k[4] + r2 * k[5])))
    prism = torch.cat([k[6] * r2, k[7] * r2], -1)
    return xy * radial + _tangential(k[2], k[3], xy) + prism


def _dist_fov(k, xy):
    omega = k[0]
    r = torch.sqrt(torch.clamp(_sqnorm(xy), min=_EPS * _EPS))
    two_tan_half = 2.0 * torch.tan(0.5 * omega)
    factor = torch.atan(r * two_tan_half) / (r * omega)
    return xy * torch.where(r < _EPS, torch.ones_like(factor), factor)


def _fisheye_prewarp(xy):
    """Equidistant pre-warp n -> n * atan(r)/r."""
    r = torch.sqrt(torch.clamp(_sqnorm(xy), min=_EPS * _EPS))
    theta_by_r = torch.atan(r) / r
    return xy * torch.where(r < _EPS, torch.ones_like(theta_by_r), theta_by_r)


def _fisheye_unwarp(xy):
    """Inverse of the pre-warp: r -> tan(r)/r (invalid past pi/2)."""
    r = torch.sqrt(torch.clamp(_sqnorm(xy), min=_EPS * _EPS))
    factor = torch.tan(torch.clamp(r, max=0.5 * math.pi - 1e-4)) / r
    factor = torch.where(r < _EPS, torch.ones_like(factor), factor)
    factor = torch.where(r > 0.5 * math.pi, torch.full_like(factor, math.inf), factor)
    return xy * factor


class ModelSpec(NamedTuple):
    name: str
    param_count: int
    unique_focal: bool  # single f (params: f cx cy ...) vs fx fy cx cy ...
    fisheye: bool  # equidistant pre-warp before the conventional distortion
    dist_fn: Callable  # (dist_params, xy) -> xy, conventional part only


CAMERA_MODELS: Dict[str, ModelSpec] = {
    s.name: s
    for s in [
        ModelSpec("PINHOLE", 4, False, False, _dist_none),
        ModelSpec("SIMPLE_PINHOLE", 3, True, False, _dist_none),
        ModelSpec("FOV", 5, False, False, _dist_fov),
        ModelSpec("OPENCV_FISHEYE", 8, False, True, _dist_poly4),
        ModelSpec("FISHEYE_POLYNOMIAL_2_TANGENTIAL_2", 8, False, True, _dist_opencv),
        ModelSpec("POLYNOMIAL_3", 7, False, False, _dist_poly3),
        ModelSpec("POLYNOMIAL_4", 8, False, False, _dist_poly4),
        ModelSpec("RADIAL", 5, True, False, _dist_poly2),
        ModelSpec("SIMPLE_RADIAL", 4, True, False, _dist_poly1),
        ModelSpec("RADIAL_FISHEYE", 5, True, True, _dist_poly2),
        ModelSpec("SIMPLE_RADIAL_FISHEYE", 4, True, True, _dist_poly1),
        ModelSpec("OPENCV", 8, False, False, _dist_opencv),
        ModelSpec("FULL_OPENCV", 12, False, False, _dist_full_opencv),
        ModelSpec("THIN_PRISM_FISHEYE", 12, False, True, _dist_thin_prism),
    ]
}


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera: static model/size + flat COLMAP-ordered parameter tensor.

    ``radius_cutoff_sq`` bounds the (pre-warped) normalized-plane radius
    beyond which projection is invalid; inf unless :func:`init_cutoff` set it.
    ``lens``: whether :func:`project` differs from the pinhole projection of
    the focals and principal point (a fisheye pre-warp, the FOV model, or a
    polynomial distortion with a nonzero coefficient), decided from the
    parameters the camera is made with when not given, and kept by
    :meth:`with_params`.
    """

    model: str
    width: int
    height: int
    params: torch.Tensor
    radius_cutoff_sq: torch.Tensor
    lens: Optional[bool] = None

    def __post_init__(self):
        if self.lens is None:
            spec = self.spec
            lens = spec.dist_fn is not _dist_none and (
                spec.fisheye or spec.dist_fn is _dist_fov or bool(torch.any(self.dist_params != 0)))
            object.__setattr__(self, "lens", lens)

    @property
    def spec(self) -> ModelSpec:
        return CAMERA_MODELS[self.model]

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[0] if self.spec.unique_focal else self.params[1]

    @property
    def cx(self):
        return self.params[1] if self.spec.unique_focal else self.params[2]

    @property
    def cy(self):
        return self.params[2] if self.spec.unique_focal else self.params[3]

    @property
    def dist_params(self):
        return self.params[3 if self.spec.unique_focal else 4:]

    def with_params(self, params) -> "Camera":
        return dataclasses.replace(self, params=params)

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, params=self.params.to(device),
                                   radius_cutoff_sq=self.radius_cutoff_sq.to(device))


def make_camera(model: str, width: int, height: int, params, cutoff: bool = True,
                device=None) -> Camera:
    """A camera from its COLMAP parameters. ``params`` that are a tensor keep
    their device unless one is named; anything else goes to ``device``,
    the card when none is named (pass ``"cpu"`` for the CPU)."""
    if not torch.is_tensor(params) or device is not None:
        device = default_device(device)
    params = torch.as_tensor(params, dtype=torch.float32, device=device)
    spec = CAMERA_MODELS[model]
    if tuple(params.shape) != (spec.param_count,):
        raise ValueError(f"{model} expects {spec.param_count} params, got {tuple(params.shape)}")
    cam = Camera(model, int(width), int(height), params,
                 torch.tensor(math.inf, dtype=torch.float32, device=params.device))
    if cutoff and spec.dist_fn is not _dist_none:
        cam = init_cutoff(cam)
    return cam


# ---------------------------------------------------------------------------
# Forward path
# ---------------------------------------------------------------------------


def _warped(cam: Camera, xy):
    """Apply the fisheye pre-warp if the model has one (the radius cutoff
    lives in this space)."""
    return _fisheye_prewarp(xy) if cam.spec.fisheye else xy


def distort(cam: Camera, xy):
    """Normalized image plane -> distorted plane (includes the fisheye pre-warp)."""
    return cam.spec.dist_fn(cam.dist_params, _warped(cam, xy))


def distorted_to_image(cam: Camera, xy, fused: bool = False):
    f = torch.stack([cam.fx, cam.fy])
    c = torch.stack([cam.cx, cam.cy])
    return torch.addcmul(c, xy, f) if fused else xy * f + c


def image_to_distorted(cam: Camera, xy):
    f = torch.stack([cam.fx, cam.fy])
    c = torch.stack([cam.cx, cam.cy])
    return (xy - c) / f


def normalized_to_image(cam: Camera, xy):
    """Normalized plane -> pixels; beyond the radius cutoff -> inf (invalid)."""
    w = _warped(cam, xy)
    out = distorted_to_image(cam, cam.spec.dist_fn(cam.dist_params, w))
    return torch.where(_sqnorm(w) > cam.radius_cutoff_sq, torch.full_like(out, math.inf), out)


def project(cam: Camera, points, fused: bool = False):
    """Camera-frame 3D points ``(...,3)`` -> (pixels ``(...,2)``, valid mask).

    valid = in front of the camera AND inside the radius cutoff AND finite.
    ``fused``: the last step as XLA compiles it inside ``jit``.
    """
    z = points[..., 2:3]
    safe_z = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    n = points[..., :2] / safe_z
    w = _warped(cam, n)
    r2 = _sqnorm(w, keepdim=False)
    pix = distorted_to_image(cam, cam.spec.dist_fn(cam.dist_params, w), fused)
    valid = (z[..., 0] > _EPS) & (r2 <= cam.radius_cutoff_sq) & torch.all(
        torch.isfinite(pix), -1)
    return pix, valid


def in_image(cam: Camera, pix, border: float = 0.0):
    """Mask of pixels inside the image rect (pixel-center convention)."""
    return ((pix[..., 0] >= border) & (pix[..., 1] >= border)
            & (pix[..., 0] <= cam.width - 1 - border)
            & (pix[..., 1] <= cam.height - 1 - border))


# ---------------------------------------------------------------------------
# Gauss-Newton undistortion (used by init_cutoff)
# ---------------------------------------------------------------------------

_UNDIST_ITERS = 100
_UNDIST_EPS = 1e-10


def _conventional_undistort(cam: Camera, dist_xy, init_xy, num_iters=_UNDIST_ITERS):
    """Invert ``spec.dist_fn`` by 2x2 Gauss-Newton from ``init_xy``, batched
    over points, with a fixed iteration count and per-point freezing once
    converged (the JAX ``fori_loop``). The per-point 2x2 Jacobian comes from
    two forward-mode passes (each point depends on its own coordinates only)."""
    k = cam.dist_params

    def dfn(p):
        return cam.spec.dist_fn(k, p)

    e0 = torch.zeros_like(init_xy)
    e0[..., 0] = 1.0
    e1 = torch.zeros_like(init_xy)
    e1[..., 1] = 1.0
    u = init_xy
    done = torch.zeros(init_xy.shape[:-1] + (1,), dtype=torch.bool, device=init_xy.device)
    for _ in range(num_iters):
        d0, c0 = torch.func.jvp(dfn, (u,), (e0,))  # column d/dx
        _, c1 = torch.func.jvp(dfn, (u,), (e1,))  # column d/dy
        resid = d0 - dist_xy
        a, b = c0[..., 0], c1[..., 0]
        c, d = c0[..., 1], c1[..., 1]
        det = a * d - b * c
        safe_det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
        dx = (d * resid[..., 0] - b * resid[..., 1]) / safe_det
        dy = (-c * resid[..., 0] + a * resid[..., 1]) / safe_det
        step = torch.stack([dx, dy], -1)
        conv = torch.sum(resid * resid, -1, keepdim=True) < _UNDIST_EPS
        u = torch.where(done | conv, u, u - step)
        done = done | conv
    return u


def undistort(cam: Camera, dist_xy, num_iters=_UNDIST_ITERS):
    """Distorted plane -> normalized plane (inverts :func:`distort`)."""
    u = _conventional_undistort(cam, dist_xy, dist_xy, num_iters)
    return _fisheye_unwarp(u) if cam.spec.fisheye else u


def image_to_normalized(cam: Camera, pix, num_iters=_UNDIST_ITERS):
    return undistort(cam, image_to_distorted(cam, pix), num_iters)


def _with_depth(n, depth):
    z = torch.as_tensor(depth, dtype=n.dtype, device=n.device)[..., None]
    return torch.cat([n * z, torch.broadcast_to(z, n.shape[:-1] + (1,))], -1)


def unproject(cam: Camera, pix, depth, num_iters=_UNDIST_ITERS):
    """Pixels + depth (z) -> camera-frame 3D points."""
    return _with_depth(image_to_normalized(cam, pix, num_iters), depth)


# ---------------------------------------------------------------------------
# Undistortion lookup table: per-pixel normalized coordinates computed once by
# the full iterative undistortion, served later by a bilinear fetch.
# ---------------------------------------------------------------------------


class UndistortionLUT(NamedTuple):
    values: torch.Tensor  # (gh, gw, 2) normalized coords at grid nodes
    step: float  # grid spacing in pixels (node i,j sits at pixel (j*step, i*step))


def build_undistortion_lut(cam: Camera, step: float = 1.0) -> UndistortionLUT:
    """The pixel-grid -> normalized-plane table (full undistortion, once)."""
    dev = cam.params.device
    gw = int(math.ceil((cam.width - 1) / step)) + 1
    gh = int(math.ceil((cam.height - 1) / step)) + 1
    xs = torch.arange(gw, dtype=torch.float32, device=dev) * step
    ys = torch.arange(gh, dtype=torch.float32, device=dev) * step
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    n = image_to_normalized(cam, torch.stack([gx, gy], -1).reshape(-1, 2))
    return UndistortionLUT(n.reshape(gh, gw, 2), float(step))


def image_to_normalized_lut(cam: Camera, lut: UndistortionLUT, pix):
    """Pixels -> normalized plane by a bilinear fetch from the table."""
    g = pix / lut.step
    gh, gw = lut.values.shape[:2]
    gx = torch.clamp(g[..., 0], 0.0, gw - 1.0)
    gy = torch.clamp(g[..., 1], 0.0, gh - 1.0)
    x0 = torch.clamp(torch.floor(gx).long(), 0, gw - 2)
    y0 = torch.clamp(torch.floor(gy).long(), 0, gh - 2)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    v = lut.values
    v00, v01 = v[y0, x0], v[y0, x0 + 1]
    v10, v11 = v[y0 + 1, x0], v[y0 + 1, x0 + 1]
    return (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)


def unproject_lut(cam: Camera, lut: UndistortionLUT, pix, depth):
    """LUT-served counterpart of :func:`unproject`."""
    return _with_depth(image_to_normalized_lut(cam, lut, pix), depth)


# ---------------------------------------------------------------------------
# Jacobians: forward-mode autodiff on the forward functions
# ---------------------------------------------------------------------------


def _point_to_image(cam: Camera, p):
    z = p[2]
    safe_z = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    return distorted_to_image(cam, distort(cam, p[:2] / safe_z))


def image_jacobian_wrt_point(cam: Camera, point):
    """d pixel / d camera-frame point, shape (...,2,3)."""
    J = torch.func.vmap(torch.func.jacfwd(lambda p: _point_to_image(cam, p)))(
        point.reshape(-1, 3))
    return J.reshape(point.shape[:-1] + (2, 3))


def image_jacobian_wrt_params(cam: Camera, point):
    """d pixel / d camera parameters, shape (...,2,P)."""
    jac = torch.func.jacfwd(lambda params, p: _point_to_image(cam.with_params(params), p))
    J = torch.func.vmap(lambda p: jac(cam.params, p))(point.reshape(-1, 3))
    return J.reshape(point.shape[:-1] + (2, cam.params.shape[0]))


def init_cutoff(cam: Camera, border_samples: int = 64) -> Camera:
    """``radius_cutoff_sq`` from multi-start undistortions of border pixels:
    cutoff^2 = min(max_p(best)^2 * 1.01, min_p(second_best)^2)."""
    dev = cam.params.device
    w, h = cam.width, cam.height
    xs = torch.linspace(0.0, w - 1.0, border_samples, device=dev)
    ys = torch.linspace(0.0, h - 1.0, border_samples, device=dev)
    border = torch.cat([
        torch.stack([xs, torch.zeros_like(xs)], -1),
        torch.stack([xs, torch.full_like(xs, h - 1.0)], -1),
        torch.stack([torch.zeros_like(ys), ys], -1),
        torch.stack([torch.full_like(ys, w - 1.0), ys], -1),
    ])
    dist_pts = image_to_distorted(cam, border)  # (B,2)

    steps, half_extent = 10, 1.5
    offs = (torch.arange(steps, dtype=torch.float32, device=dev) - 0.5 * steps) / (
        0.5 * steps) * half_extent
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)
    inits = dist_pts[:, None, :] + grid[None]  # (B,G,2)
    B, G, _ = inits.shape
    cam_inf = dataclasses.replace(
        cam, radius_cutoff_sq=torch.tensor(math.inf, dtype=torch.float32, device=dev))
    tiled = dist_pts[:, None, :].expand(B, G, 2).reshape(-1, 2)
    sol = _conventional_undistort(cam_inf, tiled, inits.reshape(-1, 2))
    resid = cam.spec.dist_fn(cam.dist_params, sol) - tiled
    converged = torch.sum(resid * resid, -1) < 1e-6
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    radii = torch.where(converged, torch.linalg.vector_norm(sol, dim=-1), inf).reshape(B, G)

    best = torch.min(radii, dim=1).values
    improve = 0.99
    second = torch.min(torch.where(radii > best[:, None] / improve, radii, inf), dim=1).values
    has_best = torch.isfinite(best)
    min_candidate = torch.max(torch.where(has_best, best ** 2, torch.zeros_like(best)))
    max_candidate = torch.min(torch.where(torch.isfinite(second), second ** 2, inf))
    cutoff = torch.minimum(min_candidate * 1.01, max_candidate)
    cutoff = torch.where(cutoff <= 0, inf, cutoff)
    return dataclasses.replace(cam, radius_cutoff_sq=cutoff.to(torch.float32))


def scaled_by(cam: Camera, factor: float) -> Camera:
    """Camera for an image scaled by ``factor`` (center-of-pixel convention)."""
    p = cam.params.clone()
    if cam.spec.unique_focal:
        p[0] = p[0] * factor
        p[1] = factor * (p[1] + 0.5) - 0.5
        p[2] = factor * (p[2] + 0.5) - 0.5
    else:
        p[0] = p[0] * factor
        p[1] = p[1] * factor
        p[2] = factor * (p[2] + 0.5) - 0.5
        p[3] = factor * (p[3] + 0.5) - 0.5
    return dataclasses.replace(cam, width=int(factor * cam.width + 0.5),
                               height=int(factor * cam.height + 0.5), params=p)
