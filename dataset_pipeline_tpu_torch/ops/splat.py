"""Point / splat z-buffer depth rendering and the cube-map hole fills.

Port of ``dataset_pipeline_tpu/ops/splat.py``: ``zbuffer_min`` (with the
winner's ``aux``), ``render_points_depth[_color]``, ``render_splats_depth``,
``fill_depth_holes``, ``fill_color_from_depth``, ``flood_fill_colors`` and the
cube-face rotations. Every renderer takes a batch of images, ``(B,N,3)``
camera-frame points, and returns ``(B,H,W)``.

``render_splats_depth`` takes the camera: under a camera with a lens
(``Camera.lens``) the splat centres sit at the model's pixels, as the
original pipeline's renderer draws occlusion through the camera model; the
JAX function takes focals and a principal point and places them at the
pinhole's.

The z-buffer is one ``scatter_reduce_(..., "amin")``, which does not depend on
the order of colliding writes, so the result is deterministic on the card as
on the CPU. The winner's ``aux`` is found by a second ``amin`` over the point
indices that reach their pixel's depth: a z-tie goes to the lowest point
index, the rule of the JAX scatter path. (The JAX sorted path is a TPU-only
workaround with the same result and is not ported.)

The fills take ``(..., H, W)`` images. Colour means are sums of at most eight
integers below 256, exact in float32 in any order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.ops import hb_geometry
from dataset_pipeline_tpu_torch.utils.timing import count, span

_INF = float("inf")


def zbuffer_min(flat, z, n_px: int, aux=None):
    """Per-pixel minimum z into a flat (n_px,) buffer: ``flat`` (N,) integer
    pixel ids (out of range, < 0 or >= n_px, dropped), ``z`` (N,) float32.
    Returns (n_px,) float32, inf where empty; with ``aux`` (N,) integers also
    the winning point's aux per pixel (0 where empty), a z-tie going to the
    lowest point index.

    The points that land are selected before the scatter: routing the others
    to one spare slot would make every one of them an atomic on that slot."""
    flat = flat.long()
    n = flat.shape[0]
    idx = torch.nonzero((flat >= 0) & (flat < n_px))[:, 0]  # ascending point index
    f = flat[idx]
    zi = z[idx]
    depth = torch.full((n_px,), _INF, dtype=torch.float32, device=z.device)
    depth.scatter_reduce_(0, f, zi, reduce="amin", include_self=True)
    if aux is None:
        return depth
    won = zi <= depth[f]
    win = torch.full((n_px,), n, dtype=torch.long, device=z.device)
    win.scatter_reduce_(0, f[won], idx[won], reduce="amin", include_self=True)
    av = aux[torch.clamp(win, max=max(n - 1, 0))] if n else win.to(aux.dtype)
    return depth, torch.where(win < n, av, 0)


def _pixel_ids(points_cam, width: int, height: int, fx, fy, cx, cy):
    """Flat pixel id per point of (B,N,3) (truncating pixel assignment,
    (0,0) = upper-left image corner; -1 off the image or behind) and z."""
    B = points_cam.shape[0]
    z = points_cam[..., 2]
    valid = z > 0
    safe_z = torch.where(valid, z, torch.ones_like(z))
    x = fx * points_cam[..., 0] / safe_z + cx
    y = fy * points_cam[..., 1] / safe_z + cy
    # float bounds first: a huge coordinate must not wrap in the int cast
    ix = torch.clamp(torch.floor(x), -1, width).long()
    iy = torch.clamp(torch.floor(y), -1, height).long()
    inside = valid & (ix >= 0) & (iy >= 0) & (ix < width) & (iy < height)
    b_idx = torch.arange(B, device=z.device)[:, None]
    flat = torch.where(inside, (b_idx * height + iy) * width + ix, -1)
    return flat.reshape(-1), torch.where(inside, z, _INF).reshape(-1)


def render_points_depth(points_cam, width: int, height: int, fx, fy, cx, cy):
    """Z-buffer render of (B,N,3) camera-frame points with pinhole
    intrinsics. Returns (B,H,W) float32 depth, inf = empty."""
    B = points_cam.shape[0]
    flat, z = _pixel_ids(points_cam, width, height, fx, fy, cx, cy)
    return zbuffer_min(flat, z, B * height * width).reshape(B, height, width)


def render_points_depth_color(points_cam, colors, width: int, height: int, fx, fy, cx, cy):
    """Like :func:`render_points_depth` plus the colour (N,3) uint8 of each
    pixel's winning point. Returns (depth (B,H,W), colour (B,H,W,3) uint8,
    black = empty)."""
    B, N = points_cam.shape[:2]
    flat, z = _pixel_ids(points_cam, width, height, fx, fy, cx, cy)
    c32 = colors.to(torch.int32)
    packed = (c32[:, 0] << 16) | (c32[:, 1] << 8) | c32[:, 2]
    depth, pimg = zbuffer_min(flat, z, B * height * width, aux=packed.repeat(B))
    img = torch.stack([(pimg >> 16) & 0xFF, (pimg >> 8) & 0xFF, pimg & 0xFF], -1).to(torch.uint8)
    return depth.reshape(B, height, width), img.reshape(B, height, width, 3)


def lens_centres(camera, points_cam):
    """(pix (B,N,2), valid (B,N)) of camera-frame points (B,N,3) by
    ``cameras.project``: on the card, for a model the H,b geometry kernel
    implements, by its ``project`` mode at the identity pose (the pose
    leaves a point's bits as they are), else by the library."""
    if hb_geometry.uses_kernel(camera, points_cam):
        B = points_cam.shape[0]
        q = torch.zeros((B, 4), dtype=torch.float32, device=points_cam.device)
        q[:, 0] = 1.0
        t = torch.zeros((B, 3), dtype=torch.float32, device=points_cam.device)
        return hb_geometry.project(camera, camera.params, q, t, points_cam)
    return cm.project(camera, points_cam)


def render_splats_depth(points_cam, radii_world, camera, max_radius_px: int = 3, timings=None):
    """Z-buffer render of square screen-space splats for a batch of images
    of ``camera`` (a ``cameras.Camera``: its size, focals and principal
    point, and its lens).

    ``points_cam`` (B,N,3) camera-frame points, ``radii_world`` (N,). Each
    point covers the pixels within its pixel radius ``r_px = f r / z``
    (``f = (fx+fy)/2``, clamped to ``max_radius_px``) at its depth. One
    scatter-min into per-radius-tier buffers padded by ``max_radius_px``,
    then tier k is min-dilated over a (2k+1)^2 window and the tiers are
    min-combined: the result of painting every (2k+1)^2 splat. Returns
    (B,H,W) float32, inf = empty.

    Each splat centre is the pinhole pixel ``f X / z + c`` of the points in
    front, unless the camera has a lens (``camera.lens``): then it is
    ``cameras.project``'s pixel (:func:`lens_centres`) and the points that
    projection marks invalid are dropped. The pixel radius stays ``f r /
    z``: under ETH3D's DSLR camera (f = 5600 px, r = 0.03 m, z <= 6 m) every
    splat reaches the clamp of 3 px, f r / z >= 28 px. With ``timings``
    (``utils/timing.py``; on the card inside one of its open stages) the
    lens's projection is the span ``occlusion_depths.project``, and
    ``occlusion_depths.distorted_points`` counts the points x images
    projected through it.
    """
    B = points_cam.shape[0]
    width, height = camera.width, camera.height
    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    z = points_cam[..., 2]
    if camera.lens:
        with span(timings, "occlusion_depths.project", points_cam.device):
            pix, valid = lens_centres(camera, points_cam)
            x, y = pix[..., 0], pix[..., 1]
        count(timings, "occlusion_depths.distorted_points", B * points_cam.shape[1])
        safe_z = torch.where(valid, z, torch.ones_like(z))
    else:
        valid = z > 0
        safe_z = torch.where(valid, z, torch.ones_like(z))
        x = fx * points_cam[..., 0] / safe_z + cx
        y = fy * points_cam[..., 1] / safe_z + cy
    f = 0.5 * (fx + fy)
    r_px = torch.clamp(f * radii_world / safe_z, 0.0, float(max_radius_px))

    R = max_radius_px
    Hp, Wp = height + 2 * R, width + 2 * R
    # float bounds first: a huge coordinate must not wrap in the int cast
    jx = torch.clamp(torch.floor(x), -R - 1, Wp) + R
    jy = torch.clamp(torch.floor(y), -R - 1, Hp) + R
    inside = valid & (jx >= 0) & (jy >= 0) & (jx < Wp) & (jy < Hp)
    k_pt = torch.ceil(r_px).long()
    tier = Hp * Wp
    b_idx = torch.arange(B, device=z.device)[:, None]
    flat = ((b_idx * (R + 1) + k_pt) * tier + jy.long() * Wp + jx.long())
    flat = torch.where(inside, flat, torch.full_like(flat, -1))
    n_px = B * (R + 1) * tier
    buf = zbuffer_min(flat.reshape(-1), z.reshape(-1), n_px).reshape(B, R + 1, Hp, Wp)

    out = buf[:, 0]
    for k in range(1, R + 1):
        # min over a (2k+1)^2 window; max_pool2d pads with -inf, i.e. +inf here
        dil = -F.max_pool2d(-buf[:, k:k + 1], 2 * k + 1, stride=1, padding=k)[:, 0]
        out = torch.minimum(out, dil)
    return out[:, R:R + height, R:R + width]


# ---------------------------------------------------------------------------
# Cube-map hole filling
# ---------------------------------------------------------------------------


def _gather_neighbors(img, fill_value):
    """(...,H,W) -> (...,H,W,8) neighbour values in scan order (dy,dx),
    edges filled with ``fill_value``."""
    H, W = img.shape[-2:]
    padded = F.pad(img, (1, 1, 1, 1), value=fill_value)
    return torch.stack([padded[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx], -1)


def _interior(shape, device):
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[..., 1:-1, 1:-1] = True
    return m


def fill_depth_holes(depth):
    """One median fill-in pass over the invalid interior pixels of
    (...,H,W) depth: the reference's count-dependent choice among the first
    valid neighbours in scan order (count <= 1 keep, 2 min, <= 4 median of
    the first 3, <= 6 of the first 5, else of the first 7). Border pixels
    are kept."""
    nb = _gather_neighbors(depth, _INF)  # (...,H,W,8)
    valid = torch.isfinite(nb)
    count = valid.sum(-1)
    # the valid neighbours first, in scan order (a stable sort of ~valid)
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices[..., :7]
    compact = torch.gather(nb, -1, order)
    compact = torch.where(torch.gather(valid, -1, order), compact, _INF)

    def median_first(m):
        return torch.sort(compact[..., :m], dim=-1).values[..., m // 2]

    fill = torch.where(
        count <= 1, _INF,
        torch.where(count == 2, torch.minimum(compact[..., 0], compact[..., 1]),
                    torch.where(count <= 4, median_first(3),
                                torch.where(count <= 6, median_first(5), median_first(7)))))
    keep = torch.isfinite(depth) | ~_interior(depth.shape, depth.device)
    return torch.where(keep, depth, fill)


def _neighbor_mean(cf, valid):
    """Rounded mean colour of the valid 8-neighbours and their count."""
    vf = valid.to(torch.float32)
    nvalid = _gather_neighbors(vf, 0.0)  # (...,H,W,8)
    cnt = nvalid.sum(-1)
    total = torch.stack([(_gather_neighbors(cf[..., c], 0.0) * nvalid).sum(-1)
                         for c in range(3)], -1)
    mean = total / torch.clamp(cnt, min=1.0)[..., None]
    return torch.floor(mean + 0.5), cnt


def fill_color_from_depth(depth_before_fill, color):
    """Mean-of-valid-neighbour colour for the invalid interior pixels (one
    pass). ``color`` (...,H,W,3) uint8. Returns (colour, valid)."""
    valid = torch.isfinite(depth_before_fill)
    cf = color.to(torch.float32)
    mean, cnt = _neighbor_mean(cf, valid)
    interior = _interior(valid.shape, valid.device)
    take = ~valid & (cnt > 0) & interior
    return torch.where(take[..., None], mean, cf).to(torch.uint8), valid | take


FLOOD_CHECK_EVERY = 8  # flood-fill steps between reads of the device


def flood_fill_colors(color, valid, stats: dict | None = None):
    """Iterative colour flood fill: each step gives every still-invalid
    pixel the rounded mean of its valid neighbours, until every pixel has a
    colour, at most H + W steps (a face with no seed never fills).

    A step after the fill has stopped (every pixel valid, or no pixel with a
    valid neighbour left) changes nothing, so the loop reads the device only
    every ``FLOOD_CHECK_EVERY`` steps and the result equals a check after
    every step. ``stats["flood_fill_steps"]`` receives the steps that filled a
    pixel, ``stats["flood_fill_unfilled"]`` the pixels left without a colour."""
    H, W = color.shape[-3:-1]
    cf = color.to(torch.float32)
    steps = torch.zeros((), dtype=torch.long, device=color.device)
    k = FLOOD_CHECK_EVERY
    for i in range(H + W):
        if i % k == 0 and not bool(torch.any(~valid)):
            break
        mean, cnt = _neighbor_mean(cf, valid)
        take = ~valid & (cnt > 0)
        if i % k == k - 1 and not bool(torch.any(take)):
            break
        steps += torch.any(take).long()
        cf = torch.where(take[..., None], mean, cf)
        valid = valid | take
    if stats is not None:
        stats["flood_fill_steps"] = int(steps)
        stats["flood_fill_unfilled"] = int(torch.sum(~valid))
    return cf.to(torch.uint8)


CUBE_FACE_NAMES = ("front", "left", "back", "right", "down", "up")

# Face rotations (world->face camera), rows = camera axes in world coords.
CUBE_FACE_ROTATIONS = np.asarray(
    [
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],  # front  +Z
        [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],  # left  -X
        [[-1, 0, 0], [0, 1, 0], [0, 0, -1]],  # back  -Z
        [[0, 0, -1], [0, 1, 0], [1, 0, 0]],  # right +X
        [[1, 0, 0], [0, 0, -1], [0, 1, 0]],  # down  +Y
        [[1, 0, 0], [0, 0, 1], [0, -1, 0]],  # up    -Y
    ],
    np.float32,
)
