"""Benchmark matrix of the port on one card. Prints ONE JSON line.

Counterpart of the JAX package's ``bench.py`` with its sections, sizes,
seeded inputs (``np.random.RandomState`` draws in ``bench.py``'s order) and
key names; the line has ``metric``, ``value``, ``unit``, ``vs_baseline``,
``metrics`` and, when a section failed, ``errors`` (and the tool returns 1).

Headline: ICP inner-LM throughput (correspondences x iterations / s) of the
moment schedule, one moment pass plus 20 O(1) LM steps, measured by
``tools/icp_bench.py`` (repeat slope of the pass, length differencing of the
step), against the measured single-core C++ reference loop
(``refbench.ref_icp_inner``, median of 3) re-accumulating every row per
iteration. The other sections:

- ``photometric_hb``: ``photometric/optimizer.py:_hb_batch`` (B3 in derivs
  mode) at 8 images x 262,144 points, K = 5, 4 levels of 1024x768; CUDA
  events, median.
- ``gather_roofline``: torch advanced indexing at the photometric path's
  gather shapes (scalar rows of 10 floats; 128-float rows of a 32 MB table);
  the JAX package's gathers are XLA's, outside any Pallas kernel.
- ``cubemap``: 2048^2 faces of a 10 M-point cloud end to end
  (``tools/cube_map_renderer.render_cube_map``, host arrays out), the
  renders alone by CUDA events over 9 distinct clouds, and the device-to-host
  copy of the exact faces (the JAX tool's u16 wire format is not ported).
- ``ref_render_baselines``: the C++ cube face and GT-depth frame loops.
- ``gt_depth``: splat occlusion + min-z GT depth, 4 M points at 3072x2048.
- ``registrator_e2e``: two rendered 160x120 frames, ``PhotometricOptimizer.run``
  on a 2-scale problem (the LM runs at scale 0: the coarsest scale is never
  optimised) at 10 iterations after a warm run (B3 in both modes).
- ``registrator_dslr``: 16 x 3072x2048, levels of 1.6 M / 400 k / 100 k
  points, intrinsics optimised: two warm iterations, three timed, then
  ``_lm_step`` alone; the C++ photometric loop beside it.
- ``joint_ba``: the joint system (4 scenes x 8 images of 256x192, 12,000
  points and 50,000 ICP rows each; ``parallel/joint_ba.py``) and the dense
  row step on the joint-BA test scenes (``parallel/ba.py``), B3 in both.
- ``scaling``: ``utils/scaling_bench.py`` in a CPU subprocess (Gloo ranks;
  under ``--toy``, ranks at a small size spawned from this process).

Run: ``python -m dataset_pipeline_tpu_torch.tools.bench [--device cpu]
[--skip a,b] [--toy]``. The default device ``cuda`` raises when CUDA is
absent. On the CPU every kernel runs its plain version, the times are the
host's, and no device-only key (device split, copy rate, share of a peak)
is written. ``--toy`` runs every section at a small size (seconds on the
CPU). On the card each section that samples images reports its B3 launches
(``<section>_b3_launches``).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from dataset_pipeline_tpu_torch import kernels, refbench, resolve_device
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.ops import gn
from dataset_pipeline_tpu_torch.ops.pyramid_sample import flatten_pyramid, pair_rows
from dataset_pipeline_tpu_torch.parallel import ba, joint_ba
from dataset_pipeline_tpu_torch.parallel.mesh import make_data_mesh, shard_rows
from dataset_pipeline_tpu_torch.photometric import optimizer as popt
from dataset_pipeline_tpu_torch.photometric.multiscale import PointLevel, build_multiscale_cloud
from dataset_pipeline_tpu_torch.photometric.problem import (
    ImageGroup,
    PhotoProblem,
    build_image_pyramid,
    build_photo_level,
    image_scale_count,
)
from dataset_pipeline_tpu_torch.tools import icp_bench
from dataset_pipeline_tpu_torch.tools.cube_map_renderer import render_cube_map, render_faces
from dataset_pipeline_tpu_torch.tools.ground_truth_creator import (
    _gt_depth_image,
    render_occlusion_depth,
)
from dataset_pipeline_tpu_torch.utils import scaling_bench, synthetic
from dataset_pipeline_tpu_torch.utils.timing import median_ms, sync, wall_s

ICP_M = icp_bench.ICP_M
B3_COUNTERS = ("pyramid_sample_derivs", "pyramid_sample_value")
# the sections that sample images with B3: on the card each reports its launches
B3_SECTIONS = ("photometric_hb", "registrator_e2e", "joint_ba", "joint_ba_dense", "registrator_dslr")
# a section's keyword arguments under --toy (the defaults are bench.py's sizes)
TOY = {
    "icp": dict(m=98304, engine_ms=(98304,)),
    "photometric_hb": dict(nb=2, n_points=2000, W=128, H=96, reps=2),
    "gt_depth": dict(width=96, height=64, n_points=20_000, frames=2),
    "registrator_e2e": dict(iters=1, warm_iters=1),
    "cubemap": dict(size=64, n_points=20_000, R=2),
    "ref_render_baselines": dict(cube_size=64, cube_points=20_000, gt_w=96, gt_h=64,
                                 gt_points=20_000),
    "gather_roofline": dict(n=20_000, nb=2, reps=2, table_mb=1, n_rows=50_000),
    "joint_ba": dict(n_scenes=2, imgs_per_scene=2, n_pts=1500, n_icp=2000, W=64, H=48, reps=1,
                     lm_iters=1),
    "joint_ba_dense": dict(reps=1),
    "scaling": dict(worlds=(2,), m_per_device=20000, rows_per_device=5000, n_keep=20, reps=2),
    "registrator_dslr": dict(n_images=2, W=192, H=128, iters=1, level_sizes=(4000, 1000, 250)),
    "ref_photo": dict(n_points=20_000, W=384, H=256),
    "ref_icp": dict(m=98304),
}
SECTIONS = tuple(TOY)


def _t(a, device, dtype=None):
    return torch.as_tensor(a, dtype=dtype, device=device)


def _identity_poses(n: int, device):
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * n, dtype=torch.float32, device=device)
    return q, torch.zeros((n, 3), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# The host baselines
# ---------------------------------------------------------------------------


def bench_numpy_cpu_schedule(m=200_000, iters=3):
    """Reference-style per-iteration row accumulation in numpy: corr/s of
    the per-iteration scheme (the stand-in when no C++ compiler exists)."""
    C = 2
    rng = np.random.RandomState(0)
    ps = rng.randn(m, 3).astype(np.float32)
    ns = rng.randn(m, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    pt = ps + 0.01 * rng.randn(m, 3).astype(np.float32)
    nt = ns.copy()
    sid = rng.randint(0, C, m).astype(np.int32)
    tid = ((sid + 1) % C).astype(np.int32)

    def one_iter():
        diff = pt - ps
        r1 = np.sum(ns * diff, -1)
        r2 = -np.sum(nt * diff, -1)
        j1 = np.concatenate([ns, np.cross(pt, ns)], -1)
        j2 = np.concatenate([nt, np.cross(ps, nt)], -1)
        oh_s = np.eye(C, dtype=np.float32)[sid]
        oh_t = np.eye(C, dtype=np.float32)[tid]
        rows1 = ((oh_t - oh_s)[:, :, None] * j1[:, None, :]).reshape(m, 6 * C)
        rows2 = ((oh_s - oh_t)[:, :, None] * j2[:, None, :]).reshape(m, 6 * C)
        rows = np.concatenate([rows1, rows2], 0)
        r = np.concatenate([r1, r2], 0)
        H = rows.T @ rows
        b = rows.T @ r
        x = np.linalg.solve(H[6:, 6:] + 0.1 * np.eye(6 * (C - 1)), b[6:])
        return x, float(r @ r)

    one_iter()
    t0 = time.perf_counter()
    for _ in range(iters):
        one_iter()
    return m / ((time.perf_counter() - t0) / iters)


def bench_ref_icp(m=ICP_M) -> dict:
    """The C++ reference ICP loop (one accumulation over ``m`` rows), median
    of 3 runs: the single-core rate swings with the host's load."""
    rng = np.random.RandomState(0)
    ps = rng.randn(m, 3).astype(np.float32)
    ns = rng.randn(m, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    pt = ps + 0.01 * rng.randn(m, 3).astype(np.float32)
    rates = []
    for _ in range(3):
        out = refbench.ref_icp_inner(ps, ns, pt, ns.copy(), iters=1)
        if out is not None:
            rates.append(m / out[0])
    return {"ref_cpp_icp_corr_per_s": float(np.median(rates))} if rates else {}


def ref_photo_inputs(n_points=500_000, K=5, W=3072, H=2048):
    """The C++ photometric loop's inputs, ``bench.py``'s draws."""
    rng = np.random.RandomState(0)
    f, cx, cy = 2800.0, (W - 1) / 2.0, (H - 1) / 2.0
    u = rng.uniform(64, W - 64, n_points)
    v = rng.uniform(64, H - 64, n_points)
    z = rng.uniform(3.0, 8.0, n_points)
    pts = np.stack([(u - cx) / f * z, (v - cy) / f * z, z], -1).astype(np.float32)
    nbr = rng.randint(0, n_points, (n_points, K)).astype(np.int32)
    desc = (5 * rng.randn(n_points, K)).astype(np.float32)
    lv0 = rng.uniform(10, 200, (H, W)).astype(np.float32)
    lv1 = rng.uniform(10, 200, (H // 2, W // 2)).astype(np.float32)
    sz = rng.uniform(0.1, 0.9, n_points).astype(np.float32)
    return pts, nbr, desc, lv0, lv1, sz, f, cx, cy


def bench_ref_photo(n_points=500_000, W=3072, H=2048) -> dict:
    """The C++ photometric H,b loop at the DSLR scale, two passes a run,
    median of 3 runs (with min and max)."""
    args = ref_photo_inputs(n_points, W=W, H=H)
    rates = []
    for _ in range(3):
        out = refbench.ref_photo_inner(*args, iters=2)
        if out is not None:
            secs, cnt = out
            rates.append(2 * cnt / secs)
    if not rates:
        return {}
    return {"ref_cpp_photo_obs_per_s": float(np.median(rates)),
            "ref_cpp_photo_obs_per_s_min": min(rates), "ref_cpp_photo_obs_per_s_max": max(rates)}


# ---------------------------------------------------------------------------
# Photometric H,b and the gather cost model
# ---------------------------------------------------------------------------


def photometric_hb_inputs(nb=8, n_points=262_144, K=5, L=4, W=1024, H=768) -> dict:
    """``bench_photometric_hb``'s arrays, ``bench.py``'s draws (numpy)."""
    rng = np.random.RandomState(0)
    f, cx, cy = 900.0, (W - 1) / 2.0, (H - 1) / 2.0
    u = rng.uniform(32, W - 32, n_points)
    v = rng.uniform(32, H - 32, n_points)
    z = rng.uniform(2.0, 5.0, n_points)
    pts = np.stack([(u - cx) / f * z, (v - cy) / f * z, z], -1).astype(np.float32)
    nbr = rng.randint(0, n_points, (n_points, K)).astype(np.int32)
    pyr = []
    for s in range(L):
        hs, ws = max(1, round(H * 2.0 ** -s)), max(1, round(W * 2.0 ** -s))
        pyr.append(rng.uniform(10, 200, (nb, hs, ws)).astype(np.float32))
    obs_scale = rng.uniform(0.1, L - 2.1, (nb, n_points)).astype(np.float32)
    return dict(params=[f, f, cx, cy], pts=pts, nbr=nbr, desc=np.zeros((n_points, K), np.float32),
                pyr=pyr, obs_scale=obs_scale)


def photometric_hb_call(x: dict, W: int, H: int, device):
    """A closure running ``_hb_batch`` on the inputs ``x`` (intrinsics and
    the dynamic-scale row optimised, radius 0.01) on ``device``."""
    nb, n = x["obs_scale"].shape
    cam = cm.make_camera("PINHOLE", W, H, x["params"], device=device)
    flat, layout = flatten_pyramid([_t(p, device) for p in x["pyr"]])
    pairs = pair_rows(flat, layout) if flat.is_cuda else None
    pose_q, pose_t = _identity_poses(nb, device)
    args = (cam, cam.params, pose_q, pose_t, _t(x["pts"], device), _t(x["nbr"], device).long(),
            _t(x["desc"], device), flat, layout, _t(x["obs_scale"], device),
            torch.ones((nb, n), dtype=torch.bool, device=device), 0.01)
    return lambda: popt._hb_batch(*args, optimize_intrinsics=True, dynamic_scale=True,
                                  pairs=pairs)


def bench_photometric_hb(device, nb=8, n_points=262_144, K=5, L=4, W=1024, H=768,
                         reps=5) -> dict:
    """Observations per second of ``_hb_batch``, CUDA events (median of
    ``reps``) on the card."""
    run = photometric_hb_call(photometric_hb_inputs(nb, n_points, K, L, W, H), W, H, device)
    count = int(run()[3])
    if not count > nb * n_points // 2:
        raise RuntimeError(f"photometric_hb: only {count} valid observations")
    ms = median_ms(run, device, reps=reps)
    return {"photometric_hb_obs_per_s": nb * n_points / (1e-3 * ms), "photometric_hb_count": count}


def gather_micro(J, idx, x):
    """Per-destination weighted sums of ``K`` gathered ``V``-float rows per
    point: (n,), the rows coupled to the gathering index."""
    acc = torch.zeros_like(J)
    for k in range(idx.shape[1]):
        acc = acc + J[:, idx[:, k], :] * x[None]
    return acc.sum(dim=(0, 2))


def gather_rows(table, i):
    """The sum of the 128-float table rows named by ``i``."""
    return torch.sum(table[i])


def gather_inputs(n=1_600_000, K=5, V=10, nb=8, reps=10, table_mb=32, n_rows=4_000_000):
    """``bench_gather_roofline``'s arrays, ``bench.py``'s draws: (J, idx,
    xs, table, ridx) numpy."""
    rng = np.random.RandomState(0)
    J = rng.randn(nb, n, V).astype(np.float32)
    idx = rng.randint(0, n, (n, K)).astype(np.int32)
    xs = [rng.randn(n, 1).astype(np.float32) for _ in range(reps)]
    t_rows = (table_mb << 20) // (128 * 4)
    table = rng.randn(t_rows, 128).astype(np.float32)
    ridx = [rng.randint(0, t_rows, n_rows).astype(np.int32) for _ in range(reps)]
    return J, idx, xs, table, ridx


def _per_call_s(fn, inputs, device) -> float:
    """Seconds per call of ``fn`` over the distinct ``inputs``, after a
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn(inputs[0])
    return 1e-3 * median_ms(lambda: [fn(a) for a in inputs], device, warmup=0, reps=1) / len(inputs)


def bench_gather_roofline(device, n=1_600_000, K=5, V=10, nb=8, reps=10, table_mb=32,
                          n_rows=4_000_000) -> dict:
    """The gather cost model: ns per gathered item at ``_hb_batch``-like
    shapes (K V-float row gathers per point) and when each gather moves a
    full 128-float row; effective GB/s of each."""
    J, idx, xs, table, ridx = gather_inputs(n, K, V, nb, reps, table_mb, n_rows)
    Jd, idxd = _t(J, device), _t(idx, device).long()
    xd = [_t(x, device) for x in xs]
    del J, xs
    dt = _per_call_s(lambda x: gather_micro(Jd, idxd, x), xd, device)
    n_gathers = nb * n * K
    out = {"gather_micro_gbps": n_gathers * V * 4 / dt / 1e9, "gather_item_ns": dt / n_gathers * 1e9}
    del Jd, idxd, xd
    td = _t(table, device)
    rd = [_t(i, device).long() for i in ridx]
    dt = _per_call_s(lambda i: gather_rows(td, i), rd, device)
    out["gather_row128_gbps"] = n_rows * 512 / dt / 1e9
    out["gather_row128_item_ns"] = dt / n_rows * 1e9
    return out


# ---------------------------------------------------------------------------
# Rendering: cube maps, ground-truth depth, the C++ loops
# ---------------------------------------------------------------------------


def _cube_cloud(n_points, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.uniform(1.0, 20.0, n_points).astype(np.float32)
    v = rng.randn(n_points, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    cols = rng.randint(0, 255, (n_points, 3)).astype(np.uint8)
    return v * d[:, None], cols


def bench_cubemap(device, size=2048, n_points=10_000_000, R=9) -> dict:
    """Faces per second end to end (host arrays in and out) and the pixels
    left uncoloured; on the card also the renders alone (CUDA events over
    ``R`` distinct clouds) and the device-to-host copy of the exact faces."""
    pos, cols = _cube_cloud(n_points)
    render_cube_map(pos, cols, size, device=device)  # warm-up
    stats = {}
    e2e = wall_s(lambda: render_cube_map(pos, cols, size, device=device, stats=stats), device)
    out = {"cubemap_2048_faces_per_s": 6.0 / e2e,
           "cubemap_uncoloured_px": stats["flood_fill_unfilled"]}
    if device.type != "cuda":
        return out
    posd, colsd = _t(pos, device), _t(cols, device)
    depth, color = render_faces(posd, colsd, size)
    sync(device)
    t0 = time.perf_counter()
    host = (depth.cpu(), color.cpu())
    d2h_s = time.perf_counter() - t0
    nbytes = sum(h.numel() * h.element_size() for h in host)
    out.update(cubemap_d2h_mb=nbytes / 1e6, cubemap_d2h_gbps=nbytes / d2h_s / 1e9)
    del depth, color, host
    dxs = _t(1e-5 * np.random.RandomState(1).randn(R, 1, 3), device, torch.float32)
    dt = 1e-3 * median_ms(lambda: [render_faces(posd + dx, colsd, size) for dx in dxs], device,
                          warmup=0, reps=1) / R
    out["cubemap_device_faces_per_s"] = 6.0 / dt
    return out


def gt_depth_points(n_points=4_000_000):
    rng = np.random.RandomState(0)
    return np.stack([rng.uniform(-6, 6, n_points), rng.uniform(-4, 4, n_points),
                     rng.uniform(3, 12, n_points)], -1).astype(np.float32)


def bench_ref_render_baselines(cube_size=2048, cube_points=10_000_000, gt_w=3072, gt_h=2048,
                               gt_points=4_000_000) -> dict:
    """The C++ cube face and GT-depth frame loops, one call each, at the
    shapes of ``bench_cubemap`` / ``bench_gt_depth``. The GT loop reads a
    prebuilt occlusion image, where the port's frame renders its own."""
    out = {}
    pos, cols = _cube_cloud(cube_points)
    f = cube_size / 2.0
    c = float(cube_size // 2)
    t0 = time.perf_counter()
    if refbench.ref_cubemap_face(pos, cols, np.eye(3), f, f, c, c, cube_size, cube_size) is not None:
        out["ref_cpp_cubemap_faces_per_s"] = 1.0 / (time.perf_counter() - t0)
    del pos, cols
    pts = gt_depth_points(gt_points)
    obs = np.full(gt_points, 3, np.int32)
    occl = np.full((gt_h, gt_w), 100.0, np.float32)
    T = np.hstack([np.eye(3), np.zeros((3, 1))])
    fd = 2800.0
    t0 = time.perf_counter()
    if refbench.ref_gt_depth_frame(pts, obs, T, fd, fd, (gt_w - 1) / 2.0, (gt_h - 1) / 2.0,
                                   gt_w, gt_h, occl) is not None:
        out["ref_cpp_gt_depth_frames_per_s"] = 1.0 / (time.perf_counter() - t0)
    return out


def gt_depth_frame(cam, pts, keep, tx: float):
    """One GT depth image from the pose (identity rotation, t = (tx, 0, 0)):
    the splat occlusion render at radius 0.01, then the min-z z-buffer."""
    pose = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=pts.device),
               torch.tensor([tx, 0.0, 0.0], dtype=torch.float32, device=pts.device))
    occ = render_occlusion_depth(cam, pose, pts, splat_radius=0.01)
    return _gt_depth_image(cam, pose.q, pose.t, pts, keep, occ, cam.width, cam.height)


def bench_gt_depth(device, width=3072, height=2048, n_points=4_000_000, frames=4) -> dict:
    """GT depth frames per second (each with its occlusion render) and the
    fewest valid pixels in a frame."""
    f = 2800.0
    cam = cm.make_camera("PINHOLE", width, height, [f, f, (width - 1) / 2.0, (height - 1) / 2.0],
                         device=device)
    pts = _t(gt_depth_points(n_points), device)
    keep = torch.ones((n_points,), dtype=torch.bool, device=device)
    gt_depth_frame(cam, pts, keep, 0.0)  # warm-up
    outs = []
    dt = wall_s(lambda: outs.extend(gt_depth_frame(cam, pts, keep, 0.01 * (i + 1))
                                    for i in range(frames)), device)
    return {"gt_depth_frames_per_s": frames / dt,
            "gt_depth_valid_px_min": min(int(torch.isfinite(d).sum()) for d in outs)}


# ---------------------------------------------------------------------------
# The registrator: two small frames end to end, the DSLR configuration
# ---------------------------------------------------------------------------


def registrator_e2e_problem(device):
    """The two-frame scene of ``bench_registrator_e2e``: a textured height
    field of 120 x 120 points rendered into two 160x120 views, its
    multi-resolution cloud (2 scales) and point levels. Returns a function
    making a fresh problem (the initial state) on each call."""
    W, H = 160, 120
    n = 120
    xs = np.linspace(0, 2, n)
    gx, gy = np.meshgrid(xs, xs)
    gz = 0.1 * np.sin(3 * gx) * np.cos(2.5 * gy)
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1).astype(np.float32)
    tex = (128 + 60 * np.sin(7 * gx) * np.cos(9 * gy)).clip(0, 252)
    cols = np.stack([tex.ravel()] * 3, -1).astype(np.uint8)
    f, cx, cy = 140.0, 79.5, 59.5
    cam = cm.make_camera("PINHOLE", W, H, [f, f, cx, cy], device=device)
    imgs, mats = synthetic.render_views(pts, cols, ([1.0, 1.0, -2.2], [1.25, 1.05, -2.15]),
                                        W, H, f, cx, cy, device)
    poses = SE3.from_matrix(_t(mats, device))
    scale_count = 2
    pyr = build_image_pyramid(imgs, scale_count, device=device)
    levels_raw = build_multiscale_cloud(pts, cols, np.zeros(len(pts), np.uint8), poses, cam,
                                        scale_count)
    levels = [pl for i, lv in enumerate(levels_raw)
              if (pl := build_photo_level(lv, seed=i, device=device)) is not None]
    occl = _t(pts, device)

    def make_problem():
        group = ImageGroup(camera=cam, pyramid=pyr, poses=poses, image_ids=[0, 1])
        return PhotoProblem(groups=[group], levels=levels, occlusion_points=occl,
                            occlusion_radius=0.03, scale_count=scale_count)

    return make_problem


def bench_registrator_e2e(device, iters=10, warm_iters=2) -> dict:
    """Seconds of a two-scale ``PhotometricOptimizer.run`` at ``iters`` LM
    iterations a scale (optimizer set-up included), after a warm run."""
    make_problem = registrator_e2e_problem(device)
    popt.PhotometricOptimizer(make_problem()).run(max_iterations_per_scale=warm_iters)
    return {"registrator_e2e_s": wall_s(lambda: popt.PhotometricOptimizer(make_problem()).run(
        max_iterations_per_scale=iters), device)}


def _dslr_texture(x, y):
    return (128 + 55 * np.sin(2.1 * x) * np.cos(1.7 * y) + 35 * np.sin(5.3 * x + 3.1 * y)).clip(3, 250)


def dslr_inputs(n_images=16, W=3072, H=2048, level_sizes=(1_600_000, 400_000, 100_000)):
    """``bench_registrator_dslr``'s arrays, ``bench.py``'s draws: the raw
    point levels (a smooth height field seen by the frames, radius doubling
    per level), the frames (n, H, W) float32 (analytic texture + noise) and
    the pose tangents (n, 6) float32."""
    rng = np.random.RandomState(0)
    f = 2800.0
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    levels = []
    r0 = 0.0015
    for li, n in enumerate(level_sizes):
        u = rng.uniform(64, W - 64, n)
        v = rng.uniform(64, H - 64, n)
        xn = (u - cx) / f
        yn = (v - cy) / f
        z = (5.0 + 1.2 * np.sin(2.5 * xn) * np.cos(2.0 * yn)).astype(np.float64)
        pts = np.stack([xn * z, yn * z, z], -1).astype(np.float32)
        inten = _dslr_texture(pts[:, 0], pts[:, 1]).astype(np.float32)
        levels.append(PointLevel(pts, inten, np.zeros(n, np.uint8), r0 * (2.0 ** li)))
    xs = np.linspace(-cx / f * 5.0, cx / f * 5.0, W, dtype=np.float32)
    ys = np.linspace(-cy / f * 5.0, cy / f * 5.0, H, dtype=np.float32)
    base = _dslr_texture(xs[None, :], ys[:, None]).astype(np.float32)
    imgs = np.repeat(base[None], n_images, 0)
    imgs += rng.randn(*imgs.shape).astype(np.float32)
    tangents = (0.002 * rng.randn(n_images, 6)).astype(np.float32)
    return levels, imgs, tangents


def dslr_optimizer(device, n_images=16, W=3072, H=2048,
                   level_sizes=(1_600_000, 400_000, 100_000)):
    """The DSLR configuration's optimizer at scale 0 (intrinsics optimised,
    splat occlusion at radius 0.01)."""
    f = 2800.0
    cam = cm.make_camera("PINHOLE", W, H, [f, f, (W - 1) / 2.0, (H - 1) / 2.0], device=device)
    scale_count = image_scale_count(W, H)  # 5 at 3072x2048
    raw, imgs, tangents = dslr_inputs(n_images, W, H, level_sizes)
    levels = [build_photo_level(lv, apply_gradient_filter=False, seed=li, device=device)
              for li, lv in enumerate(raw)]
    pyr = build_image_pyramid(imgs, scale_count, device=device)
    del imgs
    all_pts = np.concatenate([lv.points for lv in raw])
    group = ImageGroup(camera=cam, pyramid=pyr, poses=SE3.exp(_t(tangents, device)),
                       image_ids=list(range(n_images)))
    problem = PhotoProblem(groups=[group], levels=levels, occlusion_points=_t(all_pts, device),
                           occlusion_radius=0.01, scale_count=scale_count)
    opt = popt.PhotometricOptimizer(problem, optimize_intrinsics=True)
    opt.current_scale = 0
    return opt


def bench_registrator_dslr(device, n_images=16, W=3072, H=2048, iters=3,
                           level_sizes=(1_600_000, 400_000, 100_000)) -> dict:
    """The registrator at the DSLR scale: seconds per LM iteration (after
    two warm iterations), the LM step alone, the observations an iteration
    under the engine's own visibility, the first and the optimum cost."""
    opt = dslr_optimizer(device, n_images, W, H, level_sizes)
    opt.run_on_current_scale(max_iterations=2)  # warm-up, through the LM step
    costs = []
    t0 = time.perf_counter()
    report = opt.run_on_current_scale(max_iterations=iters, iteration_costs=costs)
    sync(device)
    iter_s = (time.perf_counter() - t0) / max(report.iterations, 1)
    vis = opt._frozen_vis
    lm_step_s = wall_s(lambda: opt._lm_step(vis), device)
    obs = sum(int(m.sum()) for per_level in vis[0] for (m, _) in per_level)
    return dict(registrator_dslr_iter_s=iter_s, registrator_dslr_lm_step_s=lm_step_s,
                registrator_dslr_points=sum(int(lv.points.shape[0]) for lv in opt.p.levels),
                registrator_dslr_images=n_images, registrator_dslr_obs_per_iter=obs,
                registrator_dslr_obs_per_s=obs / iter_s, registrator_dslr_cost_first=costs[0],
                registrator_dslr_cost_optimum=report.optimum_cost)


# ---------------------------------------------------------------------------
# Joint BA: the packed system, the dense rows
# ---------------------------------------------------------------------------


def joint_ba_scene(seed: int, cam, device, imgs_per_scene=8, n_pts=12_000, n_icp=50_000, W=256,
                   H=192):
    """One scene of ``bench_joint_ba_system``: a wavy surface of ``n_pts``
    points in two interleaved scans, ``imgs_per_scene`` noisy analytic
    frames, poses ``SE3.exp(0.002 randn(6))``, and ``n_icp`` perturbed
    self-correspondences between the scans, ``bench.py``'s draws."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.9, 0.9, (n_pts, 2)).astype(np.float32)
    z = 2.2 + 0.05 * np.sin(3 * xy[:, 0]) * np.cos(2.5 * xy[:, 1])
    pts = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    scans = (np.arange(n_pts) % 2).astype(np.uint8)
    inten = (120 + 70 * np.sin(5 * pts[:, 0] + seed) * np.cos(4 * pts[:, 1])).astype(np.float32)
    imgs = (120 + 70 * np.sin(5 * np.linspace(-1, 1, W)[None, None, :] + seed)
            * np.cos(4 * np.linspace(-0.75, 0.75, H)[None, :, None])).astype(np.float32)
    imgs = np.repeat(imgs, imgs_per_scene, 0)
    imgs += rng.randn(*imgs.shape).astype(np.float32)
    poses = SE3.exp(_t(0.002 * rng.randn(imgs_per_scene, 6), device, torch.float32))
    level = build_photo_level(PointLevel(pts, inten, scans, 0.008), apply_gradient_filter=False,
                              seed=seed, device=device)
    group = ImageGroup(camera=cam, pyramid=build_image_pyramid(imgs, 2, device=device),
                       poses=poses, image_ids=list(range(imgs_per_scene)))
    problem = PhotoProblem(groups=[group], levels=[level], occlusion_points=_t(pts, device),
                           occlusion_radius=0.02, scale_count=2)
    sel = rng.randint(0, n_pts, n_icp)
    ps = pts[sel]
    pt = ps + 0.005 * rng.randn(n_icp, 3).astype(np.float32)
    ns = rng.randn(n_icp, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    icp = (ps, ns, pt.astype(np.float32), ns.copy(), np.zeros(n_icp, np.int32),
           np.ones(n_icp, np.int32))
    return ba.JointScene(problem, 0, icp, icp_weight=5.0)


def bench_joint_ba_system(device, n_scenes=4, imgs_per_scene=8, n_pts=12_000, n_icp=50_000,
                          W=256, H=192, reps=5, lm_iters=3, cost_trace=None) -> dict:
    """The joint multi-scene BA step on a one-rank mesh of ``device``: warm
    seconds per step, residual rows, a short damped descent at frozen
    visibility (``cost_trace``, if given, receives its costs) and the host's
    peak RSS growth."""
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    f = 200.0
    cam = cm.make_camera("PINHOLE", W, H, [f, f, (W - 1) / 2.0, (H - 1) / 2.0], device=device)
    scenes = [joint_ba_scene(11 + i, cam, device, imgs_per_scene, n_pts, n_icp, W, H)
              for i in range(n_scenes)]
    pack = joint_ba.pack_scenes(make_data_mesh(device=device), scenes, optimize_intrinsics=True)
    system = joint_ba.JointBASystem(pack)
    state = joint_ba.make_state(pack)
    vis, obs_scale = system.visibility(state)
    cost0, count = system.cost(state, vis, obs_scale)
    rows = int(count) * int(pack.scene_neighbors.shape[-1]) + 2 * pack.n_icp

    def step(lam):
        xk, xi, cost, _ = system.step(state, vis, obs_scale, lam)
        return xk, xi, float(cost)  # the value syncs

    step(1e-2)  # warm-up
    t0 = time.perf_counter()
    for i in range(reps):
        step(1e-2 * (1.0 + 1e-3 * i))
    step_s = (time.perf_counter() - t0) / reps
    trace = [float(cost0)]
    for _ in range(lm_iters):
        xk, xi, _ = step(1e-2)
        state = joint_ba.apply_delta(pack, state, xk, xi)
        trace.append(float(system.cost(state, vis, obs_scale)[0]))
    if cost_trace is not None:
        cost_trace.extend(trace)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    return dict(joint_ba_step_s=step_s, joint_ba_rows=rows, joint_ba_images=pack.n_images,
                joint_ba_cost0=trace[0], joint_ba_cost_final=trace[-1],
                joint_ba_host_rss_mb=rss1 - rss0)


def joint_ba_dense_scenes(device):
    """The two joint-BA test scenes (``synthetic.joint_ba_test_scene``,
    ``bench.py``'s deltas) as ``JointScene``s at ICP weight 30."""
    W, H, F, CX, CY = synthetic.JBA_TEST_CAMERA
    cam = cm.make_camera("PINHOLE", W, H, [F, F, CX, CY], device=device)
    rng = np.random.RandomState(3)
    scenes = []
    for seed, phase in ((10, 0.0), (20, 0.7)):
        scan1_delta = 0.008 * rng.randn(6).astype(np.float32)
        pose_deltas = 0.003 * rng.randn(2, 6).astype(np.float32)
        problem, icp, _, _ = synthetic.joint_ba_test_scene(seed, cam, phase, scan1_delta,
                                                           pose_deltas, device)
        scenes.append(ba.JointScene(problem, 0, icp, icp_weight=30.0))
    return scenes


def _identity_rows(rows, r, w):
    return rows, r, w


def bench_joint_ba_dense(device, reps=5) -> dict:
    """One damped Schur GN step of the joint scan + image BA on the
    materialised rows (photometric descriptor + symmetric ICP) of the two
    test scenes, on a one-rank mesh of ``device``: seconds per step and
    rows."""
    rows, r, w, n_keep, m = ba.build_joint_rows(joint_ba_dense_scenes(device), obs_scale=0.0)
    mesh = make_data_mesh(device=device)
    inputs = tuple(shard_rows(mesh, a) for a in (rows, r, w))

    def step():
        return ba.joint_ba_step(mesh, _identity_rows, inputs, n_keep, m, lam=1e-3)

    cost = float(step()[2])  # warm-up
    return {"joint_ba_dense_step_s": wall_s(lambda: [step() for _ in range(reps)], device) / reps,
            "joint_ba_dense_rows": len(rows), "joint_ba_dense_cost": cost}


def bench_scaling(worlds=None, **sizes) -> dict:
    """``utils/scaling_bench.py`` at JAX's sizes in a CPU subprocess (Gloo
    ranks at worlds 2 and 8): its JSON object. Given ``worlds`` or
    ``scaling_bench.run``'s size keywords, runs them from this process."""
    if worlds is None and not sizes:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        r = subprocess.run([sys.executable, "-m", "dataset_pipeline_tpu_torch.utils.scaling_bench",
                            "--device", "cpu"], capture_output=True, text=True, timeout=900, cwd=root)
        if r.returncode != 0:
            raise RuntimeError(f"scaling_bench returned {r.returncode}: {r.stderr[-2000:]}")
        return {"scaling": json.loads(r.stdout.strip().splitlines()[-1])}
    worlds = worlds or (2, 8)
    out = {"devices": max(worlds), "method": scaling_bench.METHOD, "device": "cpu"}
    for nd in worlds:
        out[f"nd{nd}"] = scaling_bench.run(nd, torch.device("cpu"), **sizes)[0]
    return {"scaling": out}


# ---------------------------------------------------------------------------
# The line
# ---------------------------------------------------------------------------


def _ratio(metrics: dict, key: str, num: str, den: str) -> None:
    if metrics.get(num) and metrics.get(den):
        metrics[key] = metrics[num] / metrics[den]


def main(argv=None, results: dict | None = None, icp: dict | None = None) -> int:
    """Run the sections and print the JSON line; ``results``, if given,
    receives the same object. ``icp``, if given, is the ICP section's result
    (``icp_bench.measure`` on the same device), used instead of measuring it
    again. Returns 1 when a section failed (listed under ``errors``)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' raises when CUDA is absent")
    p.add_argument("--skip", default="", help=f"comma-separated sections to leave out, of {SECTIONS}")
    p.add_argument("--toy", action="store_true", help="every section at a small size")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    skip = {s for s in args.skip.split(",") if s}
    if skip - set(SECTIONS):
        raise SystemExit(f"--skip: unknown sections {sorted(skip - set(SECTIONS))}")
    sizes = TOY if args.toy else {}
    metrics, errors = {}, {}

    def section(name, fn, *a):
        if name in skip:
            return
        before = [kernels.LAUNCHES[c] for c in B3_COUNTERS]
        try:
            metrics.update(fn(*a, **sizes.get(name, {})))
        except Exception as e:  # noqa: BLE001 - a failed section is reported, and fails the run
            errors[name] = repr(e)
        if on_card and name in B3_SECTIONS:
            metrics[f"{name}_b3_launches"] = sum(kernels.LAUNCHES[c] for c in B3_COUNTERS) - sum(before)
        if on_card:
            torch.cuda.empty_cache()

    def icp_section(m=ICP_M, engine_ms=icp_bench.ENGINE_MS):
        out = dict(icp) if icp is not None else icp_bench.measure(m, list(engine_ms), device)
        out.pop("device", None)
        out["icp_moment_bytes_per_corr"] = out["icp_moment_pass_bytes"] / out["m"]
        out["icp_moment_flops_per_corr"] = gn.MOMENT_FLOPS_PER_ROW
        return out

    metrics["device_kind"] = torch.cuda.get_device_name(device) if on_card else "cpu"
    section("icp", icp_section)
    section("photometric_hb", bench_photometric_hb, device)
    section("gt_depth", bench_gt_depth, device)
    section("registrator_e2e", bench_registrator_e2e, device)
    section("cubemap", bench_cubemap, device)
    section("ref_render_baselines", bench_ref_render_baselines)
    _ratio(metrics, "cubemap_device_vs_ref", "cubemap_device_faces_per_s", "ref_cpp_cubemap_faces_per_s")
    _ratio(metrics, "cubemap_vs_ref", "cubemap_2048_faces_per_s", "ref_cpp_cubemap_faces_per_s")
    _ratio(metrics, "gt_depth_vs_ref", "gt_depth_frames_per_s", "ref_cpp_gt_depth_frames_per_s")
    section("gather_roofline", bench_gather_roofline, device)
    if metrics.get("photometric_hb_obs_per_s") and metrics.get("gather_row128_item_ns"):
        # bench.py's budget: 12 gather units an observation (2 brick rows, 5
        # neighbour J rows, 5 neighbour intensity items) at the row regime's
        # cost an item
        bound = 1e9 / (12.0 * metrics["gather_row128_item_ns"])
        metrics["photometric_hb_gather_bound_obs_per_s"] = bound
        metrics["photometric_hb_gather_bound_pct"] = 100.0 * metrics["photometric_hb_obs_per_s"] / bound
    section("joint_ba", bench_joint_ba_system, device)
    section("joint_ba_dense", bench_joint_ba_dense, device)
    section("scaling", bench_scaling)
    section("registrator_dslr", bench_registrator_dslr, device)
    section("ref_photo", bench_ref_photo)
    _ratio(metrics, "registrator_dslr_vs_ref", "registrator_dslr_obs_per_s", "ref_cpp_photo_obs_per_s")
    section("ref_icp", bench_ref_icp)
    cpu = metrics.get("ref_cpp_icp_corr_per_s")
    if cpu is None and "ref_icp" not in skip:
        cpu = bench_numpy_cpu_schedule()
        metrics["baseline_kind"] = "numpy-standin"
    corr_iters_per_s = metrics.get("icp_gn_corr_iters_per_s", 0.0)
    if cpu and metrics.get("icp_moment_accum_corr_per_s"):
        # kernel against kernel: the accumulation rate, no amortization
        metrics["vs_ref_kernel"] = metrics["icp_moment_accum_corr_per_s"] / cpu

    timer = ("card time (repeat slope of the pass, length differencing of the step, CUDA "
             "events elsewhere)" if on_card else "host time on the CPU (plain versions)")
    result = {
        "metric": "icp_gn_correspondences_per_s",
        "value": corr_iters_per_s,
        "unit": (f"corr*iters/s of the 20-iteration inner LM schedule at {metrics.get('m', ICP_M)} "
                 f"correspondences, {timer}: one moment pass (R=65 repeat slope, median of 5, "
                 "min/max shipped) + 20 x the O(1) LM step; the host's dispatch beside it as "
                 "icp_schedule_dispatch_s; vs_baseline against the measured single-core C++ "
                 "reference loop re-accumulating every row per iteration (median of 3)"),
        "vs_baseline": corr_iters_per_s / cpu if cpu else None,
        "metrics": metrics,
    }
    if errors:
        result["errors"] = errors
    if results is not None:
        results.update(result)
    print(json.dumps(result))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
