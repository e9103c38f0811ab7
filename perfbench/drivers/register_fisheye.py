"""The registrator cell under ETH3D's DSLR camera model, THIN_PRISM_FISHEYE.

As ``drivers/register.py``, whose ``Recorder``, ``plan_of``, ``window``,
``numbers_of`` and ``restore`` this imports: closed loops of LM episodes on
one image scale, each from the seed's start state, and two recorded
iterations of the first episode checked against the plain reference. Here
the scene is seen through the lens (``perfbench/scene/dslr_fisheye.py``),
the group's camera is a THIN_PRISM_FISHEYE camera with its 12 intrinsics
optimised, and the reference is
``perfbench/reference/eth3d_dslr_fisheye_register.py``.

With a trace, the shapes of the geometry kernel's ``jacobian`` launches in
the window's first iteration are kept, and after the window their bound
(``perfbench/roofline/hb_geometry.py``) is set beside their kernel time from
the device trace. A program without the kernel for this camera launches
none, and the record then holds nothing for that share.
"""

from __future__ import annotations

import argparse
import time

import torch

from perfbench import compare
from perfbench.drivers.register import (  # noqa: F401  (window: this cell's timed loop)
    Recorder,
    _vis_by_level,
    applied_update,
    numbers_of,
    plan_of,
    restore,
    window,
)
from perfbench.harness import sync
from perfbench.reference.eth3d_dslr_fisheye_register import FisheyeRegistratorReference
from perfbench.reference.geometry import Prec
from perfbench.roofline import hb_geometry as geometry_model
from perfbench.scene.dslr_fisheye import make_scene

MODEL = "THIN_PRISM_FISHEYE"
JACOBIAN_KERNEL = "hb_jacobian_kernel"
KERNELS = (JACOBIAN_KERNEL,)  # kernels whose intervals the traced run keeps
WARMUP_ITERATIONS = 1


def build(scene, cfg: dict, device):
    """The registrator's problem and optimizer on ``scene`` at the CLI's
    defaults under the lens: (optimizer, start state (params, q, t))."""
    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.photometric.problem import (
        ImageGroup,
        PhotoLevel,
        PhotoProblem,
        build_image_pyramid,
        image_scale_count,
    )
    from dataset_pipeline_tpu_torch.tools.image_registrator import make_optimizer
    from dataset_pipeline_tpu_torch.utils.params import Parameters

    params = Parameters()
    scales = image_scale_count(scene.width, scene.height, params.max_initial_image_area)
    if scales != cfg["registrator"]["scale_count"]:
        raise ValueError(f"the program counts {scales} image scales; the configuration states "
                         f"{cfg['registrator']['scale_count']}")
    levels = []
    for lv in scene.levels:
        desc = lv.intensities[lv.neighbors] - lv.intensities[:, None]
        levels.append(PhotoLevel(lv.points, lv.intensities,
                                 torch.zeros(lv.points.shape[0], dtype=torch.uint8, device=device),
                                 lv.neighbors, desc, lv.radius))
    cam = cm.make_camera(MODEL, scene.width, scene.height, scene.params, device=device)
    start = (scene.params.clone(), scene.q_start.float(), scene.t_start.float())
    group = ImageGroup(camera=cam, pyramid=build_image_pyramid(scene.images.cpu().numpy(), scales,
                                                               device=device),
                       poses=SE3(start[1].clone(), start[2].clone()),
                       image_ids=list(range(scene.images.shape[0])))
    problem = PhotoProblem(groups=[group], levels=levels, occlusion_points=scene.scan,
                           occlusion_radius=params.splat_radius, scale_count=scales,
                           max_valid_intensity=params.maximum_valid_intensity,
                           occlusion_depth_threshold=params.occlusion_depth_threshold)
    opt = make_optimizer(problem, argparse.Namespace(fix_intrinsics=False), params)
    return opt, start


def jacobian_shapes(rec, fn, stash: list):
    """The geometry kernel's ``jacobian`` entry, keeping the shapes of its
    launches in the window's first iteration."""
    def call(camera, params, pose_q, pose_t, points, radius, dpx, dpy, dvds, optimize_intrinsics,
             dynamic_scale):
        if rec.on and rec.n_acc == 1 and points.shape[-2]:
            stash.append(dict(images=pose_q.shape[0], points=points.shape[-2],
                              per_image=points.dim() == 3, P=params.shape[0],
                              V=(params.shape[0] if optimize_intrinsics else 0) + 6,
                              footprint=bool(dynamic_scale), lens=camera.spec.fisheye))
        return fn(camera, params, pose_q, pose_t, points, radius, dpx, dpy, dvds,
                  optimize_intrinsics, dynamic_scale)
    return call


def prepare(run):
    from dataset_pipeline_tpu_torch.ops import hb_geometry

    cfg, tr, dev = run.config, run.traffic, run.device
    t0 = time.perf_counter()
    scene = make_scene(cfg["scene"], run.seed, dev, levels=True)
    sync(dev)
    t1 = time.perf_counter()
    opt, start = build(scene, cfg, dev)
    sync(dev)
    t2 = time.perf_counter()
    sample, later = plan_of(run.seed, scene.images.shape[0], tr["iterations"])
    rec = Recorder(run, opt, plan={0: "start", later: "later"}, sample_images=sample,
                   stash_b3=False)
    stash, jacobian = None, None
    if run.trace and any(m.startswith("hb_geometry_roofline_share")
                         for m in run.record.get("per_layer", ())):
        stash, jacobian = [], hb_geometry.jacobian
        hb_geometry.jacobian = jacobian_shapes(rec, jacobian, stash)
    # warm-up: every shape of the window (the stop rules' last refresh and final cost too)
    restore(opt, start)
    opt.current_scale = tr["scale"]
    opt.run_on_current_scale(max_iterations=WARMUP_ITERATIONS)
    sync(dev)
    run.notes.append(f"set-up: scene {t1 - t0:.3f} s, problem {t2 - t1:.3f} s, warm-up "
                     f"{time.perf_counter() - t2:.3f} s; levels "
                     + " / ".join(str(lv.points.shape[0]) for lv in scene.levels)
                     + f", scan {scene.scan.shape[0]} points, radius cutoff^2 "
                     f"{float(opt.p.groups[0].camera.radius_cutoff_sq):.6f}")
    return dict(scene=scene, opt=opt, start=start, rec=rec, sample=sample, stash=stash,
                jacobian=jacobian)


def after_trace(run, st, summary) -> None:
    """The geometry kernel's bound over its kernel time, over the
    ``jacobian`` launches of the traced window's first iteration."""
    stash = st.get("stash")
    if not stash:
        return
    times = summary["kernels"].get(JACOBIAN_KERNEL, [])
    nbytes = flops = 0.0
    for shape in stash:
        b, f = geometry_model.launch_work(**shape)
        nbytes, flops = nbytes + b, flops + f
    k = len(stash)
    if len(times) >= k:
        run.record["hb_geometry"] = dict(launches=k, seconds=sum(times[:k]),
                                         bound_s=geometry_model.bound_seconds(nbytes, flops))
    st["stash"] = None


def vis_diff(got_vis, out) -> float:
    """Visibility masks differing, over the reference's visible pairs, at
    every point (the scale band's included: the reference decides those at
    the compared scale), with each point that the reference's ``off`` marks
    counted as differing."""
    mism = sum(float(((p.to(m.device) != m) | o).sum())
               for p, (m, _), o in zip(got_vis, out["vis"], out["off"]))
    return mism / max(sum(float(m.sum()) for m, _ in out["vis"]), 1.0)


def check(run, st, prec: Prec):
    """The numbers compared, each the worst over the recorded iterations
    (the first recorded, from the start state, sets the later one's
    ``first_norm``). A point whose scale lies within ``scale_band`` of an
    integer is decided in the reference at the program's scale where that
    lies within ``scale_band`` of the reference's, and counts against
    ``vis_diff`` where it does not (:func:`vis_diff`)."""
    rec, lim = st["rec"], run.config["limits"]
    ref = FisheyeRegistratorReference(st["scene"], run.config["registrator"], prec)
    numbers: dict = {}
    first_norm = None
    for i, cap in sorted(rec.captures.items()):
        vis = _vis_by_level(cap["vis"])
        scales = [torch.cat([s for _, s in chunks]) for chunks in cap["vis"][0]]
        out = ref.iteration(cap["params"], cap["q"], cap["t"], run.traffic["scale"], cap["lam"],
                            step="post" in cap, decided=list(zip(vis, scales)),
                            band=lim["scale_band"])
        got = dict(occl=cap["occl"], vis=vis, H=cap["H"], b=cap["b"],
                   cost=cap["cost"], x=applied_update(cap) if "post" in cap else None)
        start = cap["kind"] == "start"
        nums = numbers_of(got, out, st["sample"], lim, None if start else first_norm)
        nums["vis_diff"] = vis_diff(got["vis"], out)
        if start and out.get("x") is not None:
            first_norm = compare.h_norm(out["x"], out["H"])
        run.notes.append(f"iteration {i} ({cap['kind']}): " + ", ".join(
            f"{k} {v:.3e}" for k, v in nums.items()))
        for k, v in nums.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers


def control(run, scene, prec: Prec) -> dict:
    """The reference in ``prec`` put in the program's place, against the
    reference: at the seed's start state, and at the later iteration the
    seed draws, reached by following the reference's own ladder; the
    points on a scale threshold are decided at the low-precision run's
    scale, as at the program's in :func:`check`. ``scene``
    is made again through the lens unless it holds the lens's 12
    parameters."""
    if scene.params.numel() != 12:
        scene = make_scene(run.config["scene"], run.seed, run.device, levels=True)
    state = (scene.params, scene.q_start.float(), scene.t_start.float())
    cfg, scale, lam = run.config["registrator"], run.traffic["scale"], 64.0
    B = scene.images.shape[0]
    _, later = plan_of(run.seed, B, run.traffic["iterations"])
    ref64 = FisheyeRegistratorReference(scene, cfg, Prec("float64"))
    low = FisheyeRegistratorReference(scene, cfg, prec)
    numbers: dict = {}
    first_norm = None
    band = run.config["limits"]["scale_band"]
    for i in range(later + 1):
        got = low.iteration(*state, scale, lam) if i in (0, later) else None
        out = ref64.iteration(*state, scale, lam, decided=got and got["vis"], band=band)
        if got is not None:
            got = dict(got, vis=[m for m, _ in got["vis"]])
            nums = numbers_of(got, out, list(range(B)), run.config["limits"],
                              None if i == 0 else first_norm)
            nums["vis_diff"] = vis_diff(got["vis"], out)
            if i == 0 and out["x"] is not None:
                first_norm = compare.h_norm(out["x"], out["H"])
            for k, v in nums.items():
                numbers[k] = max(numbers.get(k, 0.0), v)
        (params, q, t), lam = out["next"]
        state = (params.float(), q.float(), t.float())
    return numbers


def release(st) -> None:
    """Free the program's state before the reference runs, and give the
    kernel's module its own ``jacobian`` back."""
    if st.get("jacobian") is not None:
        from dataset_pipeline_tpu_torch.ops import hb_geometry

        hb_geometry.jacobian = st.pop("jacobian")
    st.pop("opt", None)
    rec = st["rec"]
    rec.opt = rec._orig = None
