"""The port's entry points: the forward step and the multi-device dry run.

Counterpart of the JAX package's ``__graft_entry__``: ``entry()`` is the
Gauss-Newton H, b, cost accumulation at the core of the ICP alignment path,
with example arguments made from a seed by the same numpy recipe;
``dryrun_multichip(n)`` runs every sharded path once over ``n`` ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.icp.moments import se3_exp_np
from dataset_pipeline_tpu_torch.icp.point_to_plane import _icp_hb_cost


def _example_icp_problem(m: int = 4096, num_clouds: int = 2, seed: int = 0, device="cuda"):
    """(q, t, ps, ns, pt, nt, sid, tid, w) tensors on ``device``: ``m``
    correspondences between ``num_clouds`` clouds at identity corrections."""
    rng = np.random.RandomState(seed)
    ps = rng.randn(m, 3).astype(np.float32)
    ns = rng.randn(m, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    pt = ps + np.float32(0.01) * rng.randn(m, 3).astype(np.float32)
    sid = rng.randint(0, num_clouds, m).astype(np.int32)
    tid = ((sid + 1) % num_clouds).astype(np.int32)
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (num_clouds, 1))
    t = np.zeros((num_clouds, 3), np.float32)
    arrays = (q, t, ps, ns, pt, ns, sid, tid, np.ones(m, np.float32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def sharded_icp_problem(m: int, num_clouds: int, seed: int):
    """(q, t, ps, ns, pt, nt, sid, tid, w) numpy arrays: ``m`` correspondences
    between ``num_clouds`` clouds with random per-row cloud ids, weights in
    [0, 1) and cloud 1 moved off the identity; the rows that the card checks
    of ``sharded_icp_hb`` and ``sharded_moment_gram`` shard."""
    rng = np.random.default_rng(seed)
    ps = rng.standard_normal((m, 3), dtype=np.float32)
    ns = rng.standard_normal((m, 3), dtype=np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    pt = ps + np.float32(0.01) * rng.standard_normal((m, 3), dtype=np.float32)
    sid = rng.integers(0, num_clouds, m, dtype=np.int32)
    tid = ((sid + 1) % num_clouds).astype(np.int32)
    w = rng.random(m, dtype=np.float32)
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (num_clouds, 1))
    t = np.zeros((num_clouds, 3), np.float32)
    q[1], t[1] = se3_exp_np(np.asarray([0.01, -0.02, 0.005, 0.004, -0.003, 0.002]))
    return q, t, ps, ns, pt, ns.copy(), sid, tid, w


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` is one H (12,12), b (12,), cost
    accumulation over 4096 correspondences of 2 clouds. The tensors lie on
    the card unless ``device="cpu"``; it raises when CUDA is named and absent."""
    args = _example_icp_problem(device=resolve_device(device))

    def fn(q, t, ps, ns, pt, nt, sid, tid, w):
        return _icp_hb_cost(q, t, ps, ns, pt, nt, sid, tid, w, num_clouds=2)

    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """The sharded paths once each over ``n_devices`` ranks: the counterpart
    of the JAX package's ``__graft_entry__.dryrun_multichip``, with its tiny
    scenes built from the same numpy recipes. It starts ``n_devices``
    processes (``parallel/mesh.py:launch``); each joins the group, builds
    its mesh and runs the six stages, each asserting finite outputs:

    1. one sharded ICP step (``sharded_icp_hb``, solve, pose update);
    2. the sharded moment Gram and ``icp_lm_from_moments``;
    3. one joint-BA step; 4. one rig joint-BA step;
    5. the ICP H, b on the 2-axis mesh, when ``n_devices`` is even and >= 4;
    6. two LM iterations of ``PhotometricOptimizer(mesh=...)``.

    Returns each rank's summary: the stages' costs, the backend, and the
    mesh's collective calls and seconds. The ranks run on the card (one
    rank per card, NCCL; more ranks than cards share them over Gloo) unless
    ``device="cpu"`` (Gloo)."""
    from dataset_pipeline_tpu_torch.parallel.mesh import launch

    return [out for out, _ in launch(_dryrun_rank, n_devices, (n_devices, str(device)),
                                     resolve_device(device))]


def _finite(name: str, *xs) -> None:
    for x in xs:
        if not bool(torch.isfinite(torch.as_tensor(x)).all()):
            raise AssertionError(f"dryrun: {name} produced non-finite values")


def _dryrun_rank(n_devices: int, device: str) -> dict:
    import torch.distributed as dist

    from dataset_pipeline_tpu_torch.icp.moments import icp_lm_from_moments
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.parallel import joint_ba as jb
    from dataset_pipeline_tpu_torch.parallel import joint_ba_rig as jr
    from dataset_pipeline_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_data_mesh,
        make_host_device_mesh,
        shard_rows,
    )
    from dataset_pipeline_tpu_torch.parallel.normal_equations import (
        sharded_icp_hb,
        sharded_moment_gram,
    )

    initialize_distributed(device=device)
    mesh = make_data_mesh(n_devices, device=device)
    dev = mesh.device
    out = {"rank": mesh.rank, "backend": dist.get_backend(), "device": str(dev)}
    C = 2
    q, t, *rows = _example_icp_problem(m=64 * n_devices, num_clouds=C, device="cpu")
    q, t = q.to(dev), t.to(dev)
    ps, ns, pt, nt, sid, tid, w = (shard_rows(mesh, x) for x in rows)

    H, b, cost = sharded_icp_hb(mesh, q, t, ps, ns, pt, nt, sid, tid, w, C)
    lam, n_var = 0.1, 6 * (C - 1)
    x = torch.linalg.solve(H[6:, 6:] + lam * torch.eye(n_var, dtype=H.dtype, device=dev), b[6:])
    delta = torch.cat([torch.zeros(6, dtype=x.dtype, device=dev), -x]).reshape(C, 6).float()
    upd = SE3.exp(delta).compose(SE3(q, t))
    _finite("the sharded ICP step", cost, upd.q, upd.t)
    out["icp_cost"] = float(cost)

    # the default ICP inner path under sharding: the summed moment Gram, then
    # the whole inner LM schedule as O(1) host math
    P = sharded_moment_gram(mesh, ps, ns, pt, nt, w)
    qm, tm, mcost = icp_lm_from_moments([P.cpu().numpy()], [(0, 1)], C, max_iterations=5)
    _finite("the sharded moment Gram", P, qm, tm, mcost)
    out["moment_cost"] = float(mcost)

    pack = jb.pack_scenes(mesh, [_tiny_joint_scene(dev)], optimize_intrinsics=True)
    system = jb.JointBASystem(pack)
    state = jb.make_state(pack)
    xk, xi, ba_cost, _ = system.step(state, *system.visibility(state), 1e-2)
    _finite("the joint-BA step", xk, xi, ba_cost)
    out["joint_ba_cost"] = float(ba_cost)

    rpack = jr.pack_rig_scenes(mesh, [_tiny_rig_scene(dev)], optimize_intrinsics=False)
    rsystem = jr.RigJointBASystem(rpack)
    rstate = jr.make_rig_state(rpack)
    rxk, rxi, rcost, _ = rsystem.step(rstate, *rsystem.visibility(rstate), 1e-2)
    _finite("the rig joint-BA step", rxk, rxi, rcost)
    out["rig_joint_ba_cost"] = float(rcost)

    if n_devices % 2 == 0 and n_devices >= 4:
        hd_mesh = make_host_device_mesh(2, n_devices // 2, device=device)
        _, _, *rows2 = _example_icp_problem(m=64 * n_devices, num_clouds=C, device="cpu")
        H2, b2, c2 = sharded_icp_hb(hd_mesh, q, t, *(shard_rows(hd_mesh, x) for x in rows2), C)
        _finite("the host-device mesh ICP H, b", H2, b2, c2)
        out["host_device_cost"] = float(c2)

    out["photometric_cost"] = _dryrun_photometric(mesh, n_devices, dev)
    out["collective_calls"], out["collective_seconds"] = mesh.calls, mesh.seconds
    return out


def _tiny_joint_scene(device):
    """A tiny 2-scan scene for the joint-BA stage: analytic height-field
    points and normals and an analytic intensity image (no renders), with
    ICP rows from each scan-1 point's nearest scan-0 point."""
    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.ops.knn import knn_bruteforce
    from dataset_pipeline_tpu_torch.parallel.ba import JointScene
    from dataset_pipeline_tpu_torch.photometric.multiscale import PointLevel
    from dataset_pipeline_tpu_torch.photometric.problem import (
        ImageGroup,
        PhotoProblem,
        build_image_pyramid,
        build_photo_level,
    )

    rng = np.random.RandomState(5)
    W, H = 64, 48
    n_half = 150
    xy0 = rng.uniform(-0.6, 0.6, (n_half, 2)).astype(np.float32)
    xy1 = rng.uniform(-0.6, 0.6, (n_half, 2)).astype(np.float32)

    def surf(xy):
        z = 2.2 + 0.05 * np.sin(3 * xy[:, 0]) * np.cos(2.5 * xy[:, 1])
        return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)

    pts = np.concatenate([surf(xy0), surf(xy1)])
    scans = np.concatenate([np.zeros(n_half), np.ones(n_half)]).astype(np.uint8)
    inten = (120 + 80 * np.sin(5 * pts[:, 0]) * np.cos(4 * pts[:, 1])).astype(np.float32)
    imgs = (120 + 80 * np.sin(
        5 * np.linspace(-1, 1, W)[None, None, :]
    ) * np.cos(4 * np.linspace(-0.7, 0.7, H)[None, :, None])).astype(np.float32)
    imgs = np.repeat(imgs, 2, 0)

    cam = cm.make_camera("PINHOLE", W, H, [60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5], device=device)
    poses = SE3.exp(torch.as_tensor(0.002 * rng.randn(2, 6), dtype=torch.float32, device=device))
    level = build_photo_level(PointLevel(pts, inten, scans, 0.02), apply_gradient_filter=False,
                              device=device)
    group = ImageGroup(camera=cam, pyramid=build_image_pyramid(imgs, 2, device=device),
                       poses=poses, image_ids=[0, 1])
    problem = PhotoProblem(groups=[group], levels=[level],
                           occlusion_points=torch.as_tensor(pts, device=device),
                           occlusion_radius=0.03, scale_count=2)
    p0, p1 = pts[:n_half], pts[n_half:]
    _, idx = knn_bruteforce(torch.as_tensor(p1, device=device), torch.as_tensor(p0, device=device),
                            1)
    idx = idx[:, 0].cpu().numpy()

    def normals(xy):
        dzdx = 0.15 * np.cos(3 * xy[:, 0]) * np.cos(2.5 * xy[:, 1])
        dzdy = -0.125 * np.sin(3 * xy[:, 0]) * np.sin(2.5 * xy[:, 1])
        n = np.stack([-dzdx, -dzdy, np.ones_like(dzdx)], -1)
        return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)

    icp = (p0[idx], normals(xy0)[idx], p1, normals(xy1),
           np.zeros(n_half, np.int32), np.ones(n_half, np.int32))
    return JointScene(problem, 0, icp, icp_weight=10.0)


def _tiny_rig_scene(device):
    """``_tiny_joint_scene`` with a second rig slot: the dependent camera's
    pyramid reuses the analytic image; its extrinsics a small x offset."""
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.parallel.ba import JointScene
    from dataset_pipeline_tpu_torch.photometric.problem import ImageGroup, PhotoProblem

    base = _tiny_joint_scene(device)
    prob = base.problem
    g0 = prob.groups[0]
    g0.rig_id = 0
    g0.rig_cam_index = 0
    extr = SE3.exp(torch.as_tensor([[0.0] * 6, [0.02, 0, 0, 0, 0, 0]], dtype=torch.float32,
                                   device=device))
    g1 = ImageGroup(camera=g0.camera, pyramid=[lvl.clone() for lvl in g0.pyramid],
                    poses=g0.poses, image_ids=[10, 11], min_image_scale=0, rig_id=0,
                    rig_cam_index=1, ref_group=0, ref_slots=np.asarray([0, 1]))
    problem = PhotoProblem(groups=[g0, g1], levels=prob.levels,
                           occlusion_points=prob.occlusion_points,
                           occlusion_radius=prob.occlusion_radius,
                           scale_count=prob.scale_count, rig_extrinsics=[extr])
    return JointScene(problem, 0, base.icp, icp_weight=10.0)


def _dryrun_photometric(mesh, n_devices: int, device) -> float:
    """Two LM iterations of the mesh optimizer on a tiny scene of
    max(2, n_devices) images; returns the optimum cost."""
    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.photometric.multiscale import PointLevel
    from dataset_pipeline_tpu_torch.photometric.optimizer import PhotometricOptimizer
    from dataset_pipeline_tpu_torch.photometric.problem import (
        ImageGroup,
        PhotoProblem,
        build_image_pyramid,
        build_photo_level,
    )

    rng = np.random.RandomState(7)
    W, H, B = 64, 48, max(2, n_devices)
    n_pts = 300
    pts = np.stack([
        rng.uniform(-0.8, 0.8, n_pts), rng.uniform(-0.6, 0.6, n_pts),
        rng.uniform(2.0, 2.5, n_pts),
    ], -1).astype(np.float32)
    inten = (120 + 80 * np.sin(5 * pts[:, 0]) * np.cos(4 * pts[:, 1])).astype(np.float32)
    imgs = (120 + 80 * np.sin(
        5 * np.linspace(-1, 1, W)[None, None, :]
    ) * np.cos(4 * np.linspace(-0.7, 0.7, H)[None, :, None])).astype(np.float32)
    imgs = np.repeat(imgs, B, 0) + rng.randn(B, H, W).astype(np.float32)

    cam = cm.make_camera("PINHOLE", W, H, [60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5], device=device)
    deltas = 0.002 * rng.randn(B, 6).astype(np.float32)
    poses = SE3.exp(torch.as_tensor(deltas, device=device))
    level = PointLevel(pts, inten, np.zeros(n_pts, np.uint8), 0.02)
    photo_level = build_photo_level(level, apply_gradient_filter=False, device=device)
    group = ImageGroup(camera=cam, pyramid=build_image_pyramid(imgs, 2, device=device),
                       poses=poses, image_ids=list(range(B)))
    problem = PhotoProblem(groups=[group], levels=[photo_level],
                           occlusion_points=torch.as_tensor(pts, device=device),
                           occlusion_radius=0.03, scale_count=2)
    opt = PhotometricOptimizer(problem, optimize_intrinsics=False, mesh=mesh, image_chunk=B)
    opt.current_scale = 0
    report = opt.run_on_current_scale(max_iterations=2)
    _finite("the mesh photometric optimizer", report.optimum_cost)
    return float(report.optimum_cost)
