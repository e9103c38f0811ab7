"""Synthetic registrator scenes: a textured height field, ray cast.

Builds what the ImageRegistrator reads from disk: a coloured scan (PLY) with
its MeshLab project, a COLMAP state whose poses are the true ones perturbed
by ``SE3.exp(POSE_NOISE * randn(6))``, and the images (8-bit PGM) rendered
exactly from the true poses by ray casting the surface (Newton on the ray
parameter) and evaluating the analytic texture at the hit point.

The surface is ``z = depth + h(x, y)`` in the world frame, seen by cameras
looking along +z from near the world origin. The texture mixes wavelengths
from 1.5 cm to 25 cm, so points ~4 mm apart (the finest level at 5 m and
f = 2800) keep contrast for the gradient filter while the coarse levels
give the optimizer a wide basin.

With ``rig`` (an se(3) tangent, the second camera's pose relative to the
first), the images are synchronised sets of a two-camera rig: the first
camera's images lie under ``cam0/``, the second's under ``cam1/`` at the
fixed relative pose, each camera is a COLMAP camera of its own, and the state
holds ``rigs.json`` with the two folders.

With ``n_scans=2`` the surface is scanned twice: scan 1 is a sampling of its
own (another seed) of the same surface, its points written in the true frame
and its ``.mlp`` pose the known error ``SE3.exp(scan1_error)`` (default
``SCAN1_ERROR``), which a joint bundle adjustment has to undo.

For the ground-truth tools: ``surface_depth`` (the ray cast's depth at each
pixel centre, the reference a ground-truth map is held to), ``surface_mesh``
(a grid mesh of the surface, optionally with a rectangular hole) and
``write_state`` (the state with other poses, e.g. the true ones).

For the two-frame alignment harness: ``write_rgbd_pair`` writes two RGB-D
views of the surface in the reference's pair-fixture format (uint16 depth
PNGs with a depth factor, RGB PNGs, the text file with the calibration and
the true relative pose).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device
from dataset_pipeline_tpu_torch.io import colmap as cio
from dataset_pipeline_tpu_torch.io.image import write_pgm
from dataset_pipeline_tpu_torch.io.meshlab import MeshInfo, write_meshlab_project
from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
from dataset_pipeline_tpu_torch.models.lie import SE3, quat_to_matrix

_TWO_PI = 2.0 * np.pi
DEPTH = 5.0  # m, the surface's mean distance from the cameras
POSE_NOISE = 0.002  # initial poses: SE3.exp(POSE_NOISE * randn(6)) of the true ones
_ROWS_PER_PASS = 256  # image rows ray cast per pass (bounds the temporaries)
# The repo's "DSLR production scale" registrator configuration
# (dataset_pipeline_tpu/bench.py bench_registrator_dslr) as a scene: one
# PINHOLE group, 16 images of 3072x2048, f = 2800; the scan's density is in
# points per m^2 of the scanned area. The configuration has ~25.6 M
# observations per iteration (16 views x 1.6 M points, ~0.25 points/px^2 in
# a view). At the CLI's default merge_distance_factor (4) the greedy merge
# keeps seeds >= 2.1 px apart and a view holds at most ~0.19 points/px^2 of
# all levels however dense the scan: < 20 M observations. Hence factor 3.
DSLR = dict(width=3072, height=2048, f=2800.0, n_images=16, baseline=0.2,
            scan_density=200_000, merge_distance_factor=3.0)
# the second scan's .mlp pose error (se(3) tangent [t | w]): (4, -3, 2) mm and
# a 1.97 mrad rotation
SCAN1_ERROR = (0.004, -0.003, 0.002, 0.0012, -0.0010, 0.0012)
# (amplitude, wavelength x [m], wavelength y [m], phase)
_TEXTURE = ((40.0, 0.043, 0.051, 0.3), (30.0, 0.093, -0.11, 1.1),
            (25.0, 0.25, 0.21, 2.0), (15.0, 0.017, 0.015, 0.7))


def surface_height(x, y, depth: float):
    return depth + 0.06 * torch.sin(0.9 * x) * torch.cos(0.7 * y) + 0.03 * torch.sin(2.3 * x + 1.1 * y)


def _surface_grad(x, y):
    zx = 0.06 * 0.9 * torch.cos(0.9 * x) * torch.cos(0.7 * y) + 0.03 * 2.3 * torch.cos(2.3 * x + 1.1 * y)
    zy = -0.06 * 0.7 * torch.sin(0.9 * x) * torch.sin(0.7 * y) + 0.03 * 1.1 * torch.cos(2.3 * x + 1.1 * y)
    return zx, zy


def texture(x, y):
    """Gray value in [3, 238] at world (x, y)."""
    t = torch.full_like(x, 128.0)
    for amp, lx, ly, ph in _TEXTURE:
        t = t + amp * torch.sin(_TWO_PI * (x / lx + y / ly) + ph)
    return torch.clamp(t, 3.0, 250.0)


def _ray_cast(q, t, width: int, height: int, f: float, cx: float, cy: float, depth: float):
    """Per block of image rows: (row slice, camera centre o, world ray
    directions d with camera-frame z = 1, ray parameter s of the surface
    hit), by Newton on g(s) = o_z + s d_z - Z(o + s d). The hit's
    camera-frame depth is s."""
    dev = q.device
    R = quat_to_matrix(q)
    o = -(R.T @ t)  # camera center in the world
    u = torch.arange(width, dtype=torch.float64, device=dev)
    for r0 in range(0, height, _ROWS_PER_PASS):
        v = torch.arange(r0, min(r0 + _ROWS_PER_PASS, height), dtype=torch.float64, device=dev)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        d_cam = torch.stack([(uu - cx) / f, (vv - cy) / f, torch.ones_like(uu)], -1)
        d = d_cam @ R  # world directions R^T d_cam
        s = (depth - o[2]) / d[..., 2]
        for _ in range(8):
            x = o[0] + s * d[..., 0]
            y = o[1] + s * d[..., 1]
            zx, zy = _surface_grad(x, y)
            g = o[2] + s * d[..., 2] - surface_height(x, y, depth)
            s = s - g / (d[..., 2] - zx * d[..., 0] - zy * d[..., 1])
        yield slice(r0, r0 + len(v)), o, d, s


def render(q, t, width: int, height: int, f: float, cx: float, cy: float, depth: float):
    """Exact render of the textured surface for pose ``image_T_world``
    (q wxyz (4,), t (3,) float64 tensors): (H, W) float32 gray values."""
    out = torch.empty((height, width), dtype=torch.float32, device=q.device)
    for rows, o, d, s in _ray_cast(q, t, width, height, f, cx, cy, depth):
        out[rows] = texture(o[0] + s * d[..., 0], o[1] + s * d[..., 1]).float()
    return out


def surface_depth(q, t, width: int, height: int, f: float, cx: float, cy: float, depth: float):
    """Camera-frame depth (z) of the surface at every pixel centre, by the
    ray cast of :func:`render`: (H, W) float64."""
    out = torch.empty((height, width), dtype=torch.float64, device=q.device)
    for rows, _, _, s in _ray_cast(q, t, width, height, f, cx, cy, depth):
        out[rows] = s
    return out


def surface_mesh(half_w: float, half_h: float, spacing: float, depth: float, hole=None):
    """Grid mesh of the height field over [-half_w, half_w] x [-half_h, half_h]
    with vertices on the surface every ``spacing`` m: (vertices (V,3)
    float32, faces (F,3) int32), two triangles per cell. ``hole`` = (x0, x1,
    y0, y1) leaves out the cells whose centre lies in that rectangle."""
    xs = np.arange(-half_w, half_w + 0.5 * spacing, spacing)
    ys = np.arange(-half_h, half_h + 0.5 * spacing, spacing)
    gx, gy = np.meshgrid(xs, ys)
    gz = surface_height(torch.from_numpy(gx), torch.from_numpy(gy), depth).numpy()
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    nx, ny = len(xs), len(ys)
    j, i = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1), indexing="ij")
    v = (j * nx + i).ravel()
    keep = np.ones(v.shape, bool)
    if hole is not None:
        cx, cy = (xs[i] + 0.5 * spacing).ravel(), (ys[j] + 0.5 * spacing).ravel()
        x0, x1, y0, y1 = hole
        keep = ~((cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1))
    v = v[keep]
    faces = np.concatenate([np.stack([v, v + 1, v + nx], -1),
                            np.stack([v + 1, v + nx + 1, v + nx], -1)])
    return verts, faces.astype(np.int32)


def write_state(folder: str, q, t) -> None:
    """A copy of the COLMAP state beside ``folder`` (``<root>/state``) with
    the image poses replaced by ``q`` (B,4), ``t`` (B,3): e.g. the true poses
    that :func:`write_scene` returns, written to ``folder``."""
    model = cio.read_model(os.path.join(os.path.dirname(folder), "state"))
    for i, iid in enumerate(sorted(model.images)):
        model.images[iid].qvec = np.asarray(q[i], np.float64)
        model.images[iid].tvec = np.asarray(t[i], np.float64)
    cio.write_model(folder, model)


def true_poses(n_images: int, baseline: float, seed: int, device=None) -> SE3:
    """Cameras on a small grid around the world origin, each rotated by a
    few milliradians, looking along +z."""
    device = default_device(device)
    rng = np.random.RandomState(seed)
    cols = int(np.ceil(np.sqrt(n_images)))
    centers = np.asarray([[(i % cols - (cols - 1) / 2) * baseline,
                           (i // cols - (n_images - 1) // cols / 2) * baseline, 0.0]
                          for i in range(n_images)])
    rot = SE3.exp(torch.as_tensor(np.concatenate([np.zeros((n_images, 3)),
                                                  0.01 * rng.randn(n_images, 3)], 1),
                                  device=device))
    R = quat_to_matrix(rot.q)
    t = -(R @ torch.as_tensor(centers, device=device)[..., None])[..., 0]
    return SE3(rot.q, t)


def scan_extent(width: int, height: int, f: float, n_images: int, depth: float,
                baseline: float):
    """Half extents (x, y) of the scanned area: the cameras' union plus 5 %."""
    spread = baseline * (np.ceil(np.sqrt(n_images)) - 1) / 2
    return (0.5 * width / f * depth * 1.05 + spread, 0.5 * height / f * depth * 1.05 + spread)


def scan_points(n: int, half_w: float, half_h: float, depth: float, seed: int, device=None):
    """(n,3) float32 surface samples and (n,3) uint8 gray colours."""
    device = default_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.rand(n, generator=g, device=device, dtype=torch.float64) * 2 - 1) * half_w
    y = (torch.rand(n, generator=g, device=device, dtype=torch.float64) * 2 - 1) * half_h
    pts = torch.stack([x, y, surface_height(x, y, depth)], -1).float()
    gray = torch.round(texture(x, y)).to(torch.uint8)
    return pts.cpu().numpy(), gray[:, None].expand(n, 3).cpu().numpy()


def rig_poses(n_images: int, baseline: float, seed: int, rig, device=None) -> SE3:
    """:func:`true_poses` with every odd image replaced by the rig's second
    camera: ``SE3.exp(rig)`` composed with the pose of the image before it."""
    truth = true_poses(n_images, baseline, seed, device)
    rel = SE3.exp(torch.as_tensor(np.asarray(rig, np.float64), device=truth.q.device))
    second = rel.compose(SE3(truth.q[0::2], truth.t[0::2]))
    q, t = truth.q.clone(), truth.t.clone()
    q[1::2], t[1::2] = second.q[: n_images // 2], second.t[: n_images // 2]
    return SE3(q, t)


def scan1_matrix(scan1_error=SCAN1_ERROR) -> np.ndarray:
    """(4,4) float64 ``.mlp`` pose of scan 1: ``SE3.exp(scan1_error)``."""
    return SE3.exp(torch.as_tensor(np.asarray(scan1_error, np.float64))).matrix().numpy()


def write_scene(root: str, width: int, height: int, f: float, n_images: int,
                n_points: int, seed: int, device=None, baseline: float = 0.15, rig=None,
                n_scans: int = 1, scan1_error=SCAN1_ERROR):
    """Write a scene under ``root``: ``scan.ply`` + ``scene.mlp``,
    ``state/`` (COLMAP text, perturbed poses) and ``images/*.pgm`` (with
    ``rig``, ``images/cam0/`` and ``images/cam1/`` and ``state/rigs.json``).
    With ``n_scans=2`` also ``scan1.ply`` (``n_points`` samples of the same
    surface from seed ``seed + 3``, in the true frame) whose ``.mlp`` pose is
    ``scan1_matrix(scan1_error)``. Returns the true poses (q (B,4), t (B,3)
    float64 numpy)."""
    if n_scans not in (1, 2):
        raise ValueError(f"n_scans must be 1 or 2; got {n_scans}")
    dev = default_device(device)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    truth = (true_poses(n_images, baseline, seed, dev) if rig is None
             else rig_poses(n_images, baseline, seed, rig, dev))
    half_w, half_h = scan_extent(width, height, f, n_images, DEPTH, baseline)
    pts, cols = scan_points(n_points, half_w, half_h, DEPTH, seed + 1, dev)
    write_ply(os.path.join(root, "scan.ply"), PointCloud(pts, None, cols))
    infos = [MeshInfo("scan", "scan.ply", np.eye(4))]
    if n_scans == 2:
        pts1, cols1 = scan_points(n_points, half_w, half_h, DEPTH, seed + 3, dev)
        write_ply(os.path.join(root, "scan1.ply"), PointCloud(pts1, None, cols1))
        infos.append(MeshInfo("scan1", "scan1.ply", scan1_matrix(scan1_error)))
    write_meshlab_project(os.path.join(root, "scene.mlp"), infos)
    rng = np.random.RandomState(seed + 2)
    init = SE3.exp(torch.as_tensor(POSE_NOISE * rng.randn(n_images, 6), device=dev)).compose(truth)
    images = {}
    for i in range(n_images):
        img = render(truth.q[i], truth.t[i], width, height, f, cx, cy, DEPTH)
        name = f"img{i:03d}.pgm" if rig is None else f"cam{i % 2}/img{i // 2:03d}.pgm"
        os.makedirs(os.path.dirname(os.path.join(root, "images", name)), exist_ok=True)
        write_pgm(os.path.join(root, "images", name),
                  torch.clamp(torch.round(img), 0, 255).to(torch.uint8).cpu().numpy())
        images[i + 1] = cio.ColmapImage(i + 1, init.q[i].cpu().numpy(), init.t[i].cpu().numpy(),
                                        1 if rig is None else 1 + i % 2, name)
    params = np.asarray([f, f, cx + 0.5, cy + 0.5])
    cams = {c: cio.ColmapCamera(c, "PINHOLE", width, height, params)
            for c in ((1,) if rig is None else (1, 2))}
    cio.write_model(os.path.join(root, "state"), cio.ColmapModel(cams, images, {}))
    if rig is not None:
        cio.write_rigs_json(os.path.join(root, "state", "rigs.json"), [cio.ColmapRig(
            1, [cio.ColmapRigCamera(1, "cam0"), cio.ColmapRigCamera(2, "cam1")])])
    return truth.q.cpu().numpy(), truth.t.cpu().numpy()


def write_scene_at_density(root: str, width: int, height: int, f: float, n_images: int,
                           baseline: float, scan_density: float, seed: int, device=None,
                           rig=None, n_scans: int = 1):
    """:func:`write_scene` with the scans' size given as points per m^2 of
    the scanned area, shared among ``n_scans`` scans. Returns (points per
    scan, true q, true t)."""
    half_w, half_h = scan_extent(width, height, f, n_images, DEPTH, baseline)
    n = int(scan_density * 4 * half_w * half_h) // n_scans
    return (n,) + write_scene(root, width, height, f, n_images, n, seed, device=device,
                              baseline=baseline, rig=rig, n_scans=n_scans)


PAIR_DEPTH_FACTOR = 2e-4  # m per unit of the uint16 depth PNGs: 13.1 m at most


def write_rgbd_pair(root: str, width: int, height: int, f: float, motion,
                    depth_factor: float = PAIR_DEPTH_FACTOR, device=None) -> str:
    """Two views of the surface as a pair fixture under ``root``: frame a at
    the world origin (``image_T_world`` = identity), frame b at
    ``SE3.exp(motion)`` (``b_T_a``); ``a.png`` / ``b.png`` (the gray render
    in three channels), ``a_depth.png`` / ``b_depth.png`` (uint16, camera z
    over ``depth_factor``, rounded; 0 where the depth does not fit) and
    ``pair.txt`` (``calibration w h fx fy cx cy depth_factor``, the file
    names, ``a_t_b`` row-major 3x4, ``average_scene_depth``: frame a's mean
    depth), as ``photometric/pair_alignment.py:load_pair_fixture`` reads it.
    Returns the path of ``pair.txt``."""
    from PIL import Image

    dev = default_device(device)
    os.makedirs(root, exist_ok=True)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    b_T_a = SE3.exp(torch.as_tensor(np.asarray(motion, np.float64), device=dev))
    mean_depth = None
    for name, pose in (("a", SE3.identity(dtype=torch.float64, device=dev)), ("b", b_T_a)):
        img = render(pose.q, pose.t, width, height, f, cx, cy, DEPTH)
        gray = torch.clamp(torch.round(img), 0, 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(np.repeat(gray[..., None], 3, -1)).save(os.path.join(root, f"{name}.png"))
        z = surface_depth(pose.q, pose.t, width, height, f, cx, cy, DEPTH).cpu().numpy()
        units = np.round(z / depth_factor)
        units = np.where((units > 0) & (units < 65536), units, 0).astype(np.uint16)
        Image.fromarray(units).save(os.path.join(root, f"{name}_depth.png"))
        mean_depth = float(z.mean()) if mean_depth is None else mean_depth
    a_T_b = b_T_a.inverse().matrix().cpu().numpy()
    path = os.path.join(root, "pair.txt")
    with open(path, "w") as fh:
        fh.write(f"calibration {width} {height} {f!r} {f!r} {cx!r} {cy!r} {depth_factor!r}\n")
        fh.write("a_image a.png\na_depth a_depth.png\nb_image b.png\nb_depth b_depth.png\n")
        fh.write("a_t_b " + " ".join(repr(float(v)) for v in a_T_b[:3].reshape(-1)) + "\n")
        fh.write(f"average_scene_depth {mean_depth!r}\n")
    return path


# ---------------------------------------------------------------------------
# The joint-BA test scene: two scans of a wavy surface and two rendered images
# (the JAX package's tests/test_joint_ba.py:_build_scene, with the port's ops)
# ---------------------------------------------------------------------------

JBA_TEST_CAMERA = (128, 96, 110.0, 63.5, 47.5)  # width, height, f, cx, cy


def look_at(eye, target=(1.0, 1.0, 0.0)):
    """(R, t) of a camera at ``eye`` looking at ``target``, its x axis level
    (image_T_world, float64 numpy)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    r = np.cross(fwd, [0.0, 1.0, 0.0])
    r = r / np.linalg.norm(r)
    R = np.stack([r, np.cross(fwd, r), fwd])
    return R, -R @ eye


def render_views(points, colors, eyes, width: int, height: int, f: float, cx: float, cy: float,
                 device=None):
    """Gray images (n, H, W) uint8 of coloured points seen from ``eyes``
    (z-buffer, fill-in, colour flood) and their poses' (n, 4, 4) float32
    matrices."""
    from dataset_pipeline_tpu_torch.ops.splat import (
        fill_color_from_depth,
        flood_fill_colors,
        render_points_depth_color,
    )

    dev = default_device(device)
    cols = torch.as_tensor(np.asarray(colors, np.uint8), device=dev)
    mats, imgs = [], []
    for eye in eyes:
        R, t = look_at(eye)
        p_cam = torch.as_tensor(points @ R.T + t, dtype=torch.float32, device=dev)
        d, c = render_points_depth_color(p_cam[None], cols, width, height, f, f, cx, cy)
        cf, v = fill_color_from_depth(d, c)
        imgs.append(flood_fill_colors(cf, v)[0, ..., 0].cpu().numpy())
        m = np.eye(4, dtype=np.float32)
        m[:3, :3], m[:3, 3] = R, t
        mats.append(m)
    return np.stack(imgs), np.stack(mats)


def _wavy(xy, phase):
    x, y = xy[:, 0], xy[:, 1]
    return np.stack([x, y, 0.1 * np.sin(3 * x + phase) * np.cos(2.5 * y)], -1).astype(np.float32)


def _wavy_normals(xy, phase):
    x, y = xy[:, 0], xy[:, 1]
    dzdx = 0.3 * np.cos(3 * x + phase) * np.cos(2.5 * y)
    dzdy = -0.25 * np.sin(3 * x + phase) * np.sin(2.5 * y)
    n = np.stack([-dzdx, -dzdy, np.ones_like(x)], -1)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def joint_ba_test_scene(seed: int, cam, phase: float, scan1_delta, pose_deltas, device=None):
    """One joint-BA scene: two scans of 800 points each of the same wavy
    surface and 2 images rendered from its true poses (``cam`` is a PINHOLE
    camera of ``JBA_TEST_CAMERA``); scan 1 moved by ``SE3.exp(scan1_delta)``
    and the image poses by ``SE3.exp(pose_deltas)`` away from the truth.
    Returns (problem, icp, d_scan, poses_gt): ``icp`` holds the ICP
    correspondences in the perturbed state, each scan-1 point's nearest scan-0
    point within 5 cm, as (ps, ns, pt, nt, src_scan, tgt_scan) numpy."""
    from dataset_pipeline_tpu_torch.ops.knn import knn_bruteforce
    from dataset_pipeline_tpu_torch.photometric.multiscale import PointLevel
    from dataset_pipeline_tpu_torch.photometric.problem import (
        ImageGroup,
        PhotoProblem,
        build_image_pyramid,
        build_photo_level,
    )

    dev = default_device(device)
    rng = np.random.RandomState(seed)
    n_half = 800
    xy0 = rng.uniform(0.2, 1.8, (n_half, 2))
    xy1 = rng.uniform(0.2, 1.8, (n_half, 2))
    pts0, pts1 = _wavy(xy0, phase), _wavy(xy1, phase)
    normals1 = _wavy_normals(xy1, phase)
    inten = np.concatenate([(128 + 60 * np.sin(7 * xy[:, 0]) * np.cos(9 * xy[:, 1])).clip(5, 250)
                            for xy in (xy0, xy1)]).astype(np.float32)
    pts_gt = np.concatenate([pts0, pts1]).astype(np.float32)
    scans = np.concatenate([np.zeros(n_half), np.ones(n_half)]).astype(np.uint8)
    cols = np.stack([inten] * 3, -1).astype(np.uint8)
    W, H, F, CX, CY = JBA_TEST_CAMERA
    imgs, mats = render_views(pts_gt, cols, ([1.0, 1.0, -2.0], [1.3, 1.1, -1.9]), W, H, F, CX, CY,
                              dev)
    poses_gt = SE3.from_matrix(torch.as_tensor(mats, device=dev))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # perturb scan 1 (left-multiplicative, global frame) and the image poses
    d_scan = SE3.exp(f32(scan1_delta))
    pts = pts_gt.copy()
    p1_gt = f32(pts_gt[scans == 1])
    pts[scans == 1] = d_scan.apply(p1_gt).cpu().numpy()
    normals1_p = (d_scan.apply(p1_gt + f32(normals1)) - d_scan.apply(p1_gt)).cpu().numpy()
    poses = SE3.exp(f32(pose_deltas)).compose(poses_gt)

    level = build_photo_level(PointLevel(pts, inten, scans, 0.02), apply_gradient_filter=False,
                              seed=seed, device=dev)
    group = ImageGroup(camera=cam, pyramid=build_image_pyramid(imgs, 2, device=dev), poses=poses,
                       image_ids=[0, 1])
    problem = PhotoProblem(groups=[group], levels=[level], occlusion_points=f32(pts),
                           occlusion_radius=0.03, scale_count=2)

    p1, p0 = pts[scans == 1], pts[scans == 0]
    d2, idx = knn_bruteforce(f32(p1), f32(p0), 1)
    idx = idx[:, 0].cpu().numpy()
    keep = d2[:, 0].cpu().numpy() < 0.05 ** 2
    n0 = _wavy_normals(xy0, phase)
    k = int(keep.sum())
    icp = (p0[idx][keep], n0[idx][keep], p1[keep], normals1_p[keep],
           np.zeros(k, np.int32), np.ones(k, np.int32))
    return problem, icp, d_scan, poses_gt
