"""The ETH3D-scale DSLR scene seen through ETH3D's own camera model,
THIN_PRISM_FISHEYE, made on the device from a seed.

The surface, its texture, the poses, the start state, the scan and the point
levels are those of ``perfbench/scene/dslr.py`` (imported, nothing there
changed); what differs is the camera:

- its 12 parameters: fx = fy = the configuration's focal, the principal
  point at the image centre (pixel centres at integers) and the
  configuration's ``distortion`` [k1, k2, p1, p2, k3, k4, sx1, sy1];
- each pixel centre's ray inverts the model: Newton on the distortion in
  float64 to a residual below 1e-6 px, then the pre-warp's inverse
  w -> w tan(|w|) / |w| (``perfbench/reference/eth3d_dslr_fisheye_register.py``);
- the images are ray cast along those rays (Newton on the ray parameter, as
  ``dslr.render``);
- the view and scan extents follow the rays of the image border, which
  reach wider than the pinhole's 0.5 W / f.

Every size comes from the configuration file; the seed changes only the
random draws, never a size.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.eth3d_dslr_fisheye_register import undistort, unwarp
from perfbench.reference.geometry import quat_to_matrix, se3_compose, se3_exp
from perfbench.scene.dslr import (
    ROWS_PER_PASS,
    Level,
    Scene,
    _surface_grad,
    base_radius,
    generator,
    level_grid,
    scan_points,
    surface_height,
    texture,
    true_poses,
)

RAY_TOL_PX = 1e-6  # the largest residual of a pixel centre's inverted ray


def lens_params(cfg: dict, device) -> torch.Tensor:
    """(12,) float32: fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1."""
    (W, H), f = cfg["image_size"], cfg["focal"]
    return torch.tensor([f, f, (W - 1) / 2.0, (H - 1) / 2.0] + list(cfg["distortion"]),
                        dtype=torch.float32, device=device)


def pixel_rays(params, u, v):
    """The normalised ray (nx, ny) (z = 1) of each pixel (u, v), float64."""
    wx, wy, res = undistort(params.double(), u.double(), v.double())
    if not res < RAY_TOL_PX:
        raise ValueError(f"the lens's inverse left a residual of {res:.3e} px")
    return unwarp(wx, wy)


def border_reach(cfg: dict, params):
    """The largest |nx| and |ny| of the rays of the image border."""
    W, H = cfg["image_size"]
    dev = params.device
    xs = torch.arange(W, dtype=torch.float64, device=dev)
    ys = torch.arange(H, dtype=torch.float64, device=dev)
    u = torch.cat([xs, xs, torch.zeros_like(ys), torch.full_like(ys, W - 1.0)])
    v = torch.cat([torch.zeros_like(xs), torch.full_like(xs, H - 1.0), ys, ys])
    nx, ny = pixel_rays(params, u, v)
    return float(nx.abs().max()), float(ny.abs().max())


def extents(cfg: dict, params, margin: float):
    """Half extents (x, y) on the mean surface of the cameras' union, the
    lens's reach widened by ``margin`` (1.05 for the scan)."""
    spread = cfg["baseline"] * (math.ceil(math.sqrt(cfg["images"])) - 1) / 2
    rx, ry = border_reach(cfg, params)
    return rx * cfg["depth"] * margin + spread, ry * cfg["depth"] * margin + spread


def render(q, t, cfg: dict, params):
    """Exact render of the textured surface at pose image_T_world (q, t
    float64) through the lens: (H, W) uint8, the gray value at each pixel
    centre's ray hit."""
    (W, H), depth = cfg["image_size"], cfg["depth"]
    dev = q.device
    R = quat_to_matrix(q)
    o = -(R.T @ t)  # camera centre in the world
    u = torch.arange(W, dtype=torch.float64, device=dev)
    out = torch.empty((H, W), dtype=torch.uint8, device=dev)
    for r0 in range(0, H, ROWS_PER_PASS):
        v = torch.arange(r0, min(r0 + ROWS_PER_PASS, H), dtype=torch.float64, device=dev)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        nx, ny = pixel_rays(params, uu, vv)
        d = torch.stack([nx, ny, torch.ones_like(nx)], -1) @ R
        s = (depth - o[2]) / d[..., 2]
        for _ in range(8):
            x, y = o[0] + s * d[..., 0], o[1] + s * d[..., 1]
            zx, zy = _surface_grad(x, y)
            g = o[2] + s * d[..., 2] - surface_height(x, y, depth)
            s = s - g / (d[..., 2] - zx * d[..., 0] - zy * d[..., 1])
        gray = texture(o[0] + s * d[..., 0], o[1] + s * d[..., 1])
        out[r0:r0 + len(v)] = torch.clamp(torch.round(gray), 0, 255).to(torch.uint8)
    return out


def make_scene(cfg: dict, seed: int, device, levels: bool = True) -> Scene:
    """The scene of configuration ``cfg`` (its ``scene`` group) from
    ``seed``: images, poses and scan always, the point levels on request;
    ``Scene.params`` holds the lens's 12 parameters."""
    dev = torch.device(device)
    (W, H), f, depth = cfg["image_size"], cfg["focal"], cfg["depth"]
    params = lens_params(cfg, dev)
    q, t = true_poses(cfg["images"], cfg["baseline"], generator(seed, 0, dev), dev)
    noise = cfg["pose_noise"] * torch.randn((cfg["images"], 6), generator=generator(seed, 1, dev),
                                            device=dev, dtype=torch.float64)
    dq, dt = se3_exp(noise)
    q0, t0 = se3_compose(dq, dt, q, t)
    images = torch.stack([render(q[b], t[b], cfg, params) for b in range(cfg["images"])])
    half_w, half_h = extents(cfg, params, 1.05)
    n_scan = int(cfg["scan_density"] * 4 * half_w * half_h)
    scan, gray = scan_points(n_scan, half_w, half_h, depth, generator(seed, 2, dev), dev)
    scene = Scene(W, H, params, q, t, q0, t0, images, scan, gray)
    if levels:
        vw, vh = extents(cfg, params, 1.0)
        g = generator(seed, 3, dev)
        grids = [level_grid(n, vw, vh, cfg["neighbors"], depth, g, dev) for n in cfg["level_points"]]
        r0 = base_radius(grids[0][0], q, t, f, cfg["min_radius_bias"])
        scene.levels = [Level(p, i, nb, r0 * 2.0 ** l) for l, (p, i, nb) in enumerate(grids)]
    return scene
