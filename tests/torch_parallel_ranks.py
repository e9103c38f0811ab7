"""Rank functions of the port's multi-process tests (``test_torch_parallel*.py``).

Each runs in a process of its own that ``parallel/mesh.py:launch`` starts
(the ``spawn`` method: the child imports this module by name), joins the
Gloo group on the CPU at one thread, builds its inputs from the numpy
arrays the test process computed, and returns numpy results. The module
imports torch and the port only, never JAX, so a rank starts quickly.
"""

import numpy as np
import torch

from dataset_pipeline_tpu_torch.parallel import mesh as tmesh


def _mesh():
    torch.set_num_threads(1)
    tmesh.initialize_distributed(device="cpu")
    return tmesh.make_data_mesh(device="cpu")


def _np(x):
    return x.double().numpy() if torch.is_tensor(x) else np.asarray(x)


def normal_equations(cases: dict) -> dict:
    """The sharded ICP normal equations, moment Grams (and both of one
    problem) and the dense joint-BA step on this world's 1-D mesh, or its
    2 x (world / 2) mesh for a case whose name ends in ``_2d``."""
    from dataset_pipeline_tpu_torch.parallel.ba import joint_ba_step
    from dataset_pipeline_tpu_torch.parallel.normal_equations import (
        sharded_icp_hb,
        sharded_moment_gram,
    )

    mesh = _mesh()
    hd = tmesh.make_host_device_mesh(2, mesh.size // 2, device="cpu")
    out = {}
    for name, c in cases.items():
        m = hd if name.endswith("_2d") else mesh

        def rows(*keys):
            return [tmesh.shard_rows(m, c[k]) for k in keys]

        if name.startswith("icp"):
            H, b, cost = sharded_icp_hb(m, tmesh.replicated(m, c["q"]), tmesh.replicated(m, c["t"]),
                                        *rows("ps", "ns", "pt", "nt", "sid", "tid", "w"), c["C"])
            out[name] = (_np(H), _np(b), float(cost))
        elif name.startswith("gram"):
            out[name] = _np(sharded_moment_gram(m, *rows("ps", "ns", "pt", "nt", "w")))
        elif name == "moment_vs_direct":
            H, b, cost = sharded_icp_hb(m, tmesh.replicated(m, c["q"]), tmesh.replicated(m, c["t"]),
                                        *rows("ps", "ns", "pt", "nt", "sid", "tid", "w"), 2)
            out[name] = (_np(sharded_moment_gram(m, *rows("ps", "ns", "pt", "nt", "w"))), _np(H),
                         float(cost))
        elif name == "dense_step":
            xk, xi, _ = joint_ba_step(m, lambda r_, e_, w_: (r_, e_, w_),
                                      tuple(rows("rows", "r", "w")), c["n_keep"], c["m"], lam=1e-4)
            out[name] = np.concatenate([_np(xk), _np(xi).reshape(-1)])
    return out


def problem_dict(jp) -> dict:
    """A PhotoProblem of either package as the numpy arguments of
    ``problem_from_numpy`` (made in the test process, rebuilt in a rank)."""
    levels = [dict(points=np.asarray(l.points), intensities=np.asarray(l.intensities),
                   scan_indices=np.asarray(l.scan_indices), neighbors=np.asarray(l.neighbors),
                   fixed_descriptors=np.asarray(l.fixed_descriptors), radius=l.radius)
              for l in jp.levels]
    groups = [dict(model=g.camera.model, width=g.camera.width, height=g.camera.height,
                   params=np.asarray(g.camera.params),
                   radius_cutoff_sq=np.asarray(g.camera.radius_cutoff_sq),
                   pyramid=[np.asarray(p) for p in g.pyramid], q=np.asarray(g.poses.q),
                   t=np.asarray(g.poses.t), image_ids=list(g.image_ids),
                   min_image_scale=g.min_image_scale, rig_id=g.rig_id,
                   rig_cam_index=g.rig_cam_index, ref_group=g.ref_group, ref_slots=g.ref_slots)
              for g in jp.groups]
    depth = jp.depth_map_pyramids
    return dict(levels=levels, groups=groups, occlusion_points=np.asarray(jp.occlusion_points),
                occlusion_radius=jp.occlusion_radius, scale_count=jp.scale_count,
                max_valid_intensity=jp.max_valid_intensity,
                occlusion_depth_threshold=jp.occlusion_depth_threshold,
                rig_extrinsics=[(np.asarray(e.q), np.asarray(e.t)) for e in jp.rig_extrinsics],
                depth_map_pyramids=None if depth is None else
                [[np.asarray(p) for p in pg] for pg in depth])


def _port_problem(d: dict):
    from dataset_pipeline_tpu_torch.photometric import problem as tpb

    return tpb.problem_from_numpy(d["levels"], d["groups"], d["occlusion_points"],
                                  d["occlusion_radius"], d["scale_count"],
                                  d["max_valid_intensity"], d["occlusion_depth_threshold"],
                                  device="cpu", rig_extrinsics=d.get("rig_extrinsics", ()),
                                  depth_map_pyramids=d.get("depth_map_pyramids"))


def photometric(args: dict) -> dict:
    """``ShardedPhotometricKernels`` on one chunk of the problem (the three
    H,b builders, and the plain one over a chunk of three images that does
    not divide over the ranks, with shared and with per-image geometry), then ``PhotometricOptimizer(mesh=...)`` over
    a scale from the same problem."""
    from dataset_pipeline_tpu_torch.ops.pyramid_sample import flatten_pyramid
    from dataset_pipeline_tpu_torch.parallel.photometric import ShardedPhotometricKernels
    from dataset_pipeline_tpu_torch.photometric.optimizer import PhotometricOptimizer

    mesh = _mesh()
    kern = ShardedPhotometricKernels(mesh)
    problem = _port_problem(args["problem"])
    g, lv = problem.groups[0], problem.levels[args["level"]]
    mask, scale = (torch.from_numpy(args[k]) for k in ("mask", "scale"))
    out = {}

    def run(fn, *a):
        return tuple(_np(x) for x in fn(*a))

    for name, idx in (("hb_batch", [0, 1]), ("hb_batch_odd_chunk", [0, 1, 0])):
        i = torch.as_tensor(idx)
        flat, layout = flatten_pyramid([p[i] for p in g.pyramid])
        out[name] = run(kern.hb_batch, g.camera, g.camera.params, g.poses.q[i], g.poses.t[i],
                        lv.points, lv.neighbors, lv.fixed_descriptors, flat, layout, scale[i],
                        mask[i], lv.radius, True, True)
    gb = args["geom_batched"]
    i = torch.as_tensor(gb["idx"])
    flat, layout = flatten_pyramid([p[i] for p in g.pyramid])
    out["hb_batch_geom_batched"] = run(
        kern.hb_batch, g.camera, g.camera.params, g.poses.q[i], g.poses.t[i],
        torch.from_numpy(gb["points"]), torch.from_numpy(gb["neighbors"]).to(lv.neighbors.dtype),
        torch.from_numpy(gb["desc"]), flat, layout, torch.from_numpy(gb["scale"]),
        torch.from_numpy(gb["mask"]), lv.radius, True, True, None, True)
    flat, layout = flatten_pyramid(g.pyramid)
    eq, et = (torch.from_numpy(args[k]) for k in ("extr_q", "extr_t"))
    out["hb_rig_batch"] = run(kern.hb_rig_batch, g.camera, g.camera.params, eq, et,
                              g.poses.q, g.poses.t, lv.points, lv.neighbors, lv.fixed_descriptors,
                              flat, layout, scale, mask, lv.radius, True, True)
    dflat, dlayout = flatten_pyramid([torch.from_numpy(p) for p in args["depth_pyramid"]])
    out["hb_depth_batch"] = run(kern.hb_depth_batch, g.camera, g.camera.params, g.poses.q,
                                g.poses.t, lv.points, dflat, dlayout, scale, mask, True)

    problem = _port_problem(args["problem"])
    opt = PhotometricOptimizer(problem, optimize_intrinsics=False, mesh=mesh)
    opt.current_scale = 0
    costs = []
    report = opt.run_on_current_scale(max_iterations=args["iterations"], iteration_costs=costs)
    out["optimizer"] = (_np(problem.groups[0].poses.q), _np(problem.groups[0].poses.t),
                        float(report.optimum_cost), costs, opt.image_chunk)
    return out


def _joint_scenes(scene_data):
    from dataset_pipeline_tpu_torch.parallel.ba import JointScene

    return [JointScene(_port_problem(d["problem"]), d["level_idx"], d["icp"],
                       icp_weight=d["icp_weight"]) for d in scene_data]


def joint_ba(args: dict) -> dict:
    """The sharded joint-BA systems (plain and rig) at JAX's initial states:
    each rank's normal-equation pieces summed (Hkk, bk, cost) or gathered
    (Hki, Hii, bi) over the mesh, and the step at two dampings."""
    from dataset_pipeline_tpu_torch.parallel import joint_ba as jb
    from dataset_pipeline_tpu_torch.parallel import joint_ba_rig as jr

    mesh = _mesh()
    out = {}
    for name, (pack_fn, system_cls), kw in (
            ("plain", (jb.pack_scenes, jb.JointBASystem), {}),
            ("rig", (jr.pack_rig_scenes, jr.RigJointBASystem),
             {"depth_weight": args["rig_depth_weight"]})):
        pack = pack_fn(mesh, _joint_scenes(args[name]["scenes"]), optimize_intrinsics=True, **kw)
        system = system_cls(pack)
        state = jb.state_from_numpy(pack, args[name]["state"])
        # the state of an unpadded pack: identity poses for this mesh's padding
        n = pack.m_pad if name == "plain" else pack.f_pad
        state["pose_q"], state["pose_t"] = jb._identity_poses(state["pose_q"], state["pose_t"], n)
        vis, osc = system.visibility(state)
        Hkk, bk, Hki, Hii, bi, cost, count = system.normal_equations(state, vis, osc)
        pieces = (_np(mesh.all_reduce(Hkk)), _np(mesh.all_reduce(bk)), _np(mesh.all_gather(Hki)),
                  _np(mesh.all_gather(Hii)), _np(mesh.all_gather(bi)),
                  float(mesh.all_reduce(cost)))
        steps = {lam: tuple(_np(x) for x in system.step(state, vis, osc, lam))
                 for lam in args[name]["lams"]}
        out[name] = {"pieces": pieces, "steps": steps, "pad": n,
                     "cost": tuple(_np(x) for x in system.cost(state, vis, osc))}
    return out


def failing(message: str) -> None:
    """Rank 1 raises; rank 0 waits in a collective the other never joins."""
    mesh = _mesh()
    if mesh.rank == 1:
        raise ValueError(message)
    mesh.all_reduce(torch.zeros(1))
