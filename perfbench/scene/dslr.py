"""The ETH3D-scale DSLR scene, made on the device from a seed.

Frozen copy of the DSLR scene of ``dataset_pipeline_tpu_torch/utils/synthetic.py``
(``surface_height``, ``texture``, the ray cast of ``render``, ``true_poses``,
``scan_extent``, ``scan_points``, ``surface_mesh``; its ``DSLR``
configuration), rewritten to build everything in memory on the device from
one seed, with torch generators on the device and no file written or read:

- a textured height field ``z = depth + h(x, y)``, seen by cameras on a grid
  looking along +z, each rotated by ``0.01 randn(3)`` rad;
- the images, uint8, ray cast exactly at the true poses (Newton on the ray
  parameter, float64);
- the start state, the true poses perturbed by ``SE3.exp(pose_noise
  randn(6))``;
- the scan, uniform samples of the surface at a density per m^2 of the
  scanned area (the cameras' union plus 5 %), with their gray values;
- the point levels: per level a jittered grid over the cameras' union with a
  point count from the configuration, each point's intensity the texture
  there, and K neighbours drawn per point from the 24 other cells of the 5 x
  5 block around it (grid arithmetic, in place of the registrator's host
  merge and neighbour search); the level radius follows the registrator's
  rule, 1.05 x the radius that projects to half a pixel at the nearest
  observation, doubling per level;
- the occlusion mesh, a grid of the surface at a fixed spacing.

Every size comes from the configuration file; the seed changes only the
random draws, never a size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from perfbench.reference.geometry import quat_from_rotvec, quat_to_matrix, se3_compose, se3_exp

TWO_PI = 2.0 * math.pi
# (amplitude, wavelength x [m], wavelength y [m], phase)
TEXTURE = ((40.0, 0.043, 0.051, 0.3), (30.0, 0.093, -0.11, 1.1),
           (25.0, 0.25, 0.21, 2.0), (15.0, 0.017, 0.015, 0.7))
ROWS_PER_PASS = 512  # image rows ray cast per pass (bounds the temporaries)
SCAN_CHUNK = 1 << 24  # scan points drawn per pass


def surface_height(x, y, depth: float):
    return depth + 0.06 * torch.sin(0.9 * x) * torch.cos(0.7 * y) + 0.03 * torch.sin(2.3 * x + 1.1 * y)


def _surface_grad(x, y):
    zx = 0.06 * 0.9 * torch.cos(0.9 * x) * torch.cos(0.7 * y) + 0.03 * 2.3 * torch.cos(2.3 * x + 1.1 * y)
    zy = -0.06 * 0.7 * torch.sin(0.9 * x) * torch.sin(0.7 * y) + 0.03 * 1.1 * torch.cos(2.3 * x + 1.1 * y)
    return zx, zy


def texture(x, y):
    """Gray value in [3, 250] at world (x, y)."""
    t = torch.full_like(x, 128.0)
    for amp, lx, ly, ph in TEXTURE:
        t = t + amp * torch.sin(TWO_PI * (x / lx + y / ly) + ph)
    return torch.clamp(t, 3.0, 250.0)


@dataclass
class Level:
    points: torch.Tensor  # (N, 3) float32, world frame
    intensities: torch.Tensor  # (N,) float32
    neighbors: torch.Tensor  # (N, K) int64
    radius: float


@dataclass
class Scene:
    width: int
    height: int
    params: torch.Tensor  # (4,) float32 pinhole fx, fy, cx, cy (pixel centres at integers)
    q_true: torch.Tensor  # (B, 4) float64 image_T_world
    t_true: torch.Tensor  # (B, 3) float64
    q_start: torch.Tensor  # (B, 4) float64: the true poses perturbed
    t_start: torch.Tensor  # (B, 3) float64
    images: torch.Tensor  # (B, H, W) uint8
    scan: torch.Tensor  # (M, 3) float32
    scan_gray: torch.Tensor  # (M,) uint8
    levels: List[Level] = field(default_factory=list)
    mesh_vertices: Optional[torch.Tensor] = None  # (V, 3) float32
    mesh_faces: Optional[torch.Tensor] = None  # (F, 3) int64


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The torch generator of one part of the scene: every part draws from a
    stream of its own, so a part is the same whichever others are made."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))


def true_poses(n_images: int, baseline: float, gen, device):
    """Cameras on a square grid around the world origin, each rotated by a
    few milliradians, looking along +z: (q (B, 4), t (B, 3)) float64."""
    cols = int(math.ceil(math.sqrt(n_images)))
    i = torch.arange(n_images, dtype=torch.float64, device=device)
    centers = torch.stack([(i % cols - (cols - 1) / 2) * baseline,
                           (torch.div(i, cols, rounding_mode="floor") - (n_images - 1) // cols / 2)
                           * baseline, torch.zeros_like(i)], -1)
    w = 0.01 * torch.randn((n_images, 3), generator=gen, device=device, dtype=torch.float64)
    q = quat_from_rotvec(w)
    t = -(quat_to_matrix(q) @ centers[..., None])[..., 0]
    return q, t


def scan_extent(cfg: dict):
    """Half extents (x, y) of the scanned area: the cameras' union plus 5 %."""
    spread = cfg["baseline"] * (math.ceil(math.sqrt(cfg["images"])) - 1) / 2
    W, H = cfg["image_size"]
    return (0.5 * W / cfg["focal"] * cfg["depth"] * 1.05 + spread,
            0.5 * H / cfg["focal"] * cfg["depth"] * 1.05 + spread)


def view_extent(cfg: dict):
    """Half extents (x, y) of the cameras' union on the mean surface."""
    spread = cfg["baseline"] * (math.ceil(math.sqrt(cfg["images"])) - 1) / 2
    W, H = cfg["image_size"]
    return (0.5 * W / cfg["focal"] * cfg["depth"] + spread,
            0.5 * H / cfg["focal"] * cfg["depth"] + spread)


def render(q, t, cfg: dict, cx: float, cy: float):
    """Exact render of the textured surface at pose image_T_world (q, t
    float64): (H, W) uint8, the gray value at each pixel centre's ray hit."""
    (W, H), f, depth = cfg["image_size"], cfg["focal"], cfg["depth"]
    dev = q.device
    R = quat_to_matrix(q)
    o = -(R.T @ t)  # camera centre in the world
    u = torch.arange(W, dtype=torch.float64, device=dev)
    out = torch.empty((H, W), dtype=torch.uint8, device=dev)
    for r0 in range(0, H, ROWS_PER_PASS):
        v = torch.arange(r0, min(r0 + ROWS_PER_PASS, H), dtype=torch.float64, device=dev)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        d = torch.stack([(uu - cx) / f, (vv - cy) / f, torch.ones_like(uu)], -1) @ R
        s = (depth - o[2]) / d[..., 2]
        for _ in range(8):
            x, y = o[0] + s * d[..., 0], o[1] + s * d[..., 1]
            zx, zy = _surface_grad(x, y)
            g = o[2] + s * d[..., 2] - surface_height(x, y, depth)
            s = s - g / (d[..., 2] - zx * d[..., 0] - zy * d[..., 1])
        gray = texture(o[0] + s * d[..., 0], o[1] + s * d[..., 1])
        out[r0:r0 + len(v)] = torch.clamp(torch.round(gray), 0, 255).to(torch.uint8)
    return out


def scan_points(n: int, half_w: float, half_h: float, depth: float, gen, device):
    """(n, 3) float32 surface samples and (n,) uint8 gray values."""
    pts = torch.empty((n, 3), dtype=torch.float32, device=device)
    gray = torch.empty((n,), dtype=torch.uint8, device=device)
    for a in range(0, n, SCAN_CHUNK):
        m = min(SCAN_CHUNK, n - a)
        x = (torch.rand(m, generator=gen, device=device, dtype=torch.float64) * 2 - 1) * half_w
        y = (torch.rand(m, generator=gen, device=device, dtype=torch.float64) * 2 - 1) * half_h
        pts[a:a + m] = torch.stack([x, y, surface_height(x, y, depth)], -1).float()
        gray[a:a + m] = torch.round(texture(x, y)).to(torch.uint8)
    return pts, gray


def level_grid(n_target: int, half_w: float, half_h: float, k: int, depth: float, gen, device):
    """A jittered grid of about ``n_target`` points over [-half_w, half_w] x
    [-half_h, half_h] on the surface, with ``k`` neighbours per point drawn
    from the other cells of its 5 x 5 block (moved inside the grid at the
    border): (points (N, 3) float32, intensities (N,) float32, neighbours
    (N, k) int64)."""
    nx = max(5, round(math.sqrt(n_target * half_w / half_h)))
    ny = max(5, round(n_target / nx))
    cw, ch = 2 * half_w / nx, 2 * half_h / ny
    j, i = torch.meshgrid(torch.arange(ny, device=device), torch.arange(nx, device=device),
                          indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    n = nx * ny
    jit = torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64) * 0.8 + 0.1
    x = -half_w + (i + jit[:, 0]) * cw
    y = -half_h + (j + jit[:, 1]) * ch
    pts = torch.stack([x, y, surface_height(x, y, depth)], -1).float()
    inten = texture(x, y).float()
    # the 24 other cells of the 5 x 5 block, the block moved inside the grid
    oy, ox = torch.meshgrid(torch.arange(5, device=device), torch.arange(5, device=device),
                            indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)
    bi = torch.clamp(i - 2, 0, nx - 5)[:, None] + ox
    bj = torch.clamp(j - 2, 0, ny - 5)[:, None] + oy
    cand = bj * nx + bi  # (n, 25), self among them
    keys = torch.rand((n, 25), generator=gen, device=device)
    keys = torch.where(cand == torch.arange(n, device=device)[:, None], 2.0, keys)
    pick = torch.argsort(keys, dim=1)[:, :k]
    return pts, inten, torch.gather(cand, 1, pick)


def base_radius(points, q, t, f: float, bias: float, chunk: int = 1 << 22) -> float:
    """``bias`` x the radius that projects to half a pixel at the nearest
    observation of ``points`` by the cameras (q, t): the registrator's finest
    level radius (pinhole: 0.5 z / f)."""
    R = quat_to_matrix(q)
    best = math.inf
    for a in range(0, points.shape[0], chunk):
        p = points[a:a + chunk].double()
        z = torch.einsum("bij,nj->bni", R, p)[..., 2] + t[:, None, 2]
        best = min(best, float(z[z > 0].min()))
    return bias * 0.5 * best / f


def surface_mesh(half_w: float, half_h: float, spacing: float, depth: float, device):
    """Grid mesh of the height field with vertices every ``spacing`` m:
    (vertices (V, 3) float32, faces (F, 3) int64), two triangles per cell."""
    xs = torch.arange(-half_w, half_w + 0.5 * spacing, spacing, dtype=torch.float64, device=device)
    ys = torch.arange(-half_h, half_h + 0.5 * spacing, spacing, dtype=torch.float64, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    verts = torch.stack([gx, gy, surface_height(gx, gy, depth)], -1).reshape(-1, 3).float()
    nx, ny = len(xs), len(ys)
    j, i = torch.meshgrid(torch.arange(ny - 1, device=device), torch.arange(nx - 1, device=device),
                          indexing="ij")
    v = (j * nx + i).reshape(-1)
    faces = torch.cat([torch.stack([v, v + 1, v + nx], -1),
                       torch.stack([v + 1, v + nx + 1, v + nx], -1)])
    return verts, faces


def make_scene(cfg: dict, seed: int, device, levels: bool = True, mesh: bool = False) -> Scene:
    """The scene of configuration ``cfg`` (its ``scene`` group) from
    ``seed``: images, poses and scan always; the point levels and the
    occlusion mesh on request."""
    dev = torch.device(device)
    (W, H), f, depth = cfg["image_size"], cfg["focal"], cfg["depth"]
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    q, t = true_poses(cfg["images"], cfg["baseline"], generator(seed, 0, dev), dev)
    noise = cfg["pose_noise"] * torch.randn((cfg["images"], 6), generator=generator(seed, 1, dev),
                                            device=dev, dtype=torch.float64)
    dq, dt = se3_exp(noise)
    q0, t0 = se3_compose(dq, dt, q, t)
    images = torch.stack([render(q[b], t[b], cfg, cx, cy) for b in range(cfg["images"])])
    half_w, half_h = scan_extent(cfg)
    n_scan = int(cfg["scan_density"] * 4 * half_w * half_h)
    scan, gray = scan_points(n_scan, half_w, half_h, depth, generator(seed, 2, dev), dev)
    scene = Scene(W, H, torch.tensor([f, f, cx, cy], dtype=torch.float32, device=dev), q, t, q0, t0,
                  images, scan, gray)
    if levels:
        vw, vh = view_extent(cfg)
        g = generator(seed, 3, dev)
        grids = [level_grid(n, vw, vh, cfg["neighbors"], depth, g, dev) for n in cfg["level_points"]]
        r0 = base_radius(grids[0][0], q, t, f, cfg["min_radius_bias"])
        scene.levels = [Level(p, i, nb, r0 * 2.0 ** l) for l, (p, i, nb) in enumerate(grids)]
    if mesh:
        scene.mesh_vertices, scene.mesh_faces = surface_mesh(half_w, half_h, cfg["mesh_spacing"],
                                                             depth, dev)
    return scene
