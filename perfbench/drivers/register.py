"""The registrator cells: closed loops of LM episodes on one image scale.

Set-up builds the scene from the seed on the device (perfbench.scene.dslr),
the registrator's problem from it (the point levels and their neighbours
are the scene's, in place of the host merge and neighbour search) and the
optimizer as the CLI's ``make_optimizer`` builds it, then warms up with one
short episode. The window runs episodes back to back: each restores the
seed's start state and calls ``PhotometricOptimizer.run_on_current_scale``
at the traffic's scale for its iterations under the CLI's stop rules, until
the window's seconds have passed; ``lm_iteration_s`` is the window's
seconds over the iterations completed.

For ``correct`` the window records two iterations of its first episode as
they happen: the first (from the seed's start state) and a later one drawn
from the seed (from the program's own state). Per iteration: the state it
started from, the occlusion depths of a few images drawn from the seed, the
visibility masks, H, b and the cost, and the state the LM ladder left.
After the window the plain reference (perfbench/reference) computes the
same from the same state and inputs. The applied update is compared at the
first iteration against the reference's (``step_gap``) and at the later one
against the first iteration's reference update (``late_step_gap``), since a
later step shrinks towards the float32 state's rounding.
"""

from __future__ import annotations

import argparse
import time

import torch

from perfbench import compare
from perfbench.harness import sync
from perfbench.reference.eth3d_dslr_register import RegistratorReference
from perfbench.reference.geometry import Prec, se3_log_between
from perfbench.roofline import pyramid_sample as b3_model
from perfbench.scene.dslr import make_scene
from perfbench.trace import span

B3_KERNEL = "pyramid_sample_kernel"
KERNELS = (B3_KERNEL,)  # kernels whose intervals the traced run keeps
WARMUP_ITERATIONS = 1  # one iteration runs every shape: refresh, H,b, ladder, final cost
COMPARED_IMAGES = 4  # occlusion depths compared, of images drawn from the seed


def build(scene, cfg: dict, device):
    """The registrator's problem and optimizer on ``scene`` at the CLI's
    defaults: (optimizer, start state (params, q, t))."""
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
    cam = cm.make_camera("PINHOLE", scene.width, scene.height, scene.params, device=device)
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


def restore(opt, start) -> None:
    from dataset_pipeline_tpu_torch.models.lie import SE3

    g = opt.p.groups[0]
    g.camera = g.camera.with_params(start[0].clone())
    g.poses = SE3(start[1].clone(), start[2].clone())


def state_of(opt):
    g = opt.p.groups[0]
    return g.camera.params.clone(), g.poses.q.clone(), g.poses.t.clone()


class Recorder:
    """Wraps the optimizer's occlusion, accumulation and ladder (instance
    attributes over its methods) to record the planned iterations, and with
    a trace the spans and B3's launches of the window's first iteration."""

    def __init__(self, run, opt, plan, sample_images, stash_b3: bool):
        self.run, self.opt, self.plan, self.sample, self.trace = run, opt, plan, sample_images, run.trace
        self.on = False
        self.t0 = 0.0  # the window's start
        self.n_ladder = 0
        self.n_occl = self.n_acc = 0
        self.current = None
        self.captures = {}
        self.b3_launches = 0
        self.b3_first = None
        self.b3_stash = [] if stash_b3 else None
        self._stashing = False
        self._occl_of = {}
        o = opt
        self._orig = (o._occlusion_depths, o._lm_accumulate, o._lm_solve_apply, o._visibility,
                      o._compute_variable_descriptors, o._total_cost)
        self.cost_calls = 0
        o._occlusion_depths = self._occlusion
        o._lm_accumulate = self._accumulate
        o._lm_solve_apply = self._ladder
        o._total_cost = self._cost
        if self.trace:
            o._visibility = self._spanned("visibility", self._orig[3])
            o._compute_variable_descriptors = self._spanned("variable_descriptors", self._orig[4])

    def _cost(self, *a, **k):
        self.cost_calls += 1
        with span("total_cost", self.trace):
            return self._orig[5](*a, **k)

    def _spanned(self, name, fn):
        def call(*a, **k):
            with span(name, True):
                return fn(*a, **k)
        return call

    def _occlusion(self):
        with span("occlusion", self.trace):
            out = self._orig[0]()
        if self.on:
            if self.n_occl in self.plan:
                self._occl_of[self.n_occl] = out[0][self.sample].clone()
            self.n_occl += 1
        return out

    def _accumulate(self, vis):
        i = self.n_acc if self.on else None
        if self.on:
            self.n_acc += 1
        if self.b3_stash is not None and self.on:
            if i == 0:
                self.b3_first = self.b3_launches
            self._stashing = i == 0
        rec = None
        if i in self.plan:
            p, q, t = state_of(self.opt)
            rec = dict(kind=self.plan[i], params=p, q=q, t=t, lam=self.opt.lam,
                       vis=self.opt._frozen_vis, occl=self._occl_of.pop(i, None))
        with span("hb_accumulate", self.trace):
            out = self._orig[1](vis)
        if rec is not None:
            rec.update(H=out[0], b=out[1], cost=out[2])
            self.captures[i] = rec
        self.current = rec
        return out

    def _ladder(self, *a, **k):
        with span("lm_ladder", self.trace):
            out = self._orig[2](*a, **k)
        if self.current is not None:
            self.current["post"] = state_of(self.opt)
            self.current = None
        if self.on and self.run.tracing:
            # an episode can outlast the traced part: end it at an iteration
            self.n_ladder += 1
            self.run.boundary(time.perf_counter() - self.t0,
                              dict(iterations=self.n_ladder, stages=dict(self.opt.timings)), last=False)
            if not self.run.tracing:
                self.opt.timings = None
        return out

    def sampler(self, fn):
        """B3's entry in the optimizer's module, counting the window's
        launches and keeping the inputs of those of its first iteration."""
        def call(flat, layout, pix0, obs_scale, with_derivs=True, pairs=None):
            if self.on and pix0.shape[1] and flat.is_cuda:
                if self._stashing:
                    self.b3_stash.append((layout, pix0.clone(), obs_scale.clone(), with_derivs))
                self.b3_launches += 1
            return fn(flat, layout, pix0, obs_scale, with_derivs, pairs)
        return call


def plan_of(seed: int, images: int, iterations: int):
    """The images whose occlusion depths are compared and the later
    iteration recorded, drawn from the seed."""
    g = torch.Generator().manual_seed(seed)
    sample = torch.randperm(images, generator=g)[:COMPARED_IMAGES].tolist()
    return sample, 1 + int(torch.randint(iterations - 1, (1,), generator=g))


def prepare(run):
    cfg, tr, dev = run.config, run.traffic, run.device
    t0 = time.perf_counter()
    scene = make_scene(cfg["scene"], run.seed, dev, levels=True)
    sync(dev)
    t1 = time.perf_counter()
    opt, start = build(scene, cfg, dev)
    sync(dev)
    t2 = time.perf_counter()
    sample, later = plan_of(run.seed, scene.images.shape[0], tr["iterations"])
    plan = {0: "start", later: "later"}
    stash = any(m.startswith("b3_roofline_share") for m in run.record.get("per_layer", ()))
    rec = Recorder(run, opt, plan, sample, stash and run.trace)
    sampler = None
    if rec.b3_stash is not None:
        import dataset_pipeline_tpu_torch.photometric.optimizer as po

        sampler = po.pyramid_sample
        po.pyramid_sample = rec.sampler(sampler)
    # warm-up: every shape of the window (the stop rules' last refresh and final cost too)
    restore(opt, start)
    opt.current_scale = tr["scale"]
    opt.run_on_current_scale(max_iterations=WARMUP_ITERATIONS)
    sync(dev)
    run.notes.append(f"set-up: scene {t1 - t0:.3f} s, problem {t2 - t1:.3f} s, warm-up "
                     f"{time.perf_counter() - t2:.3f} s; levels "
                     + " / ".join(str(lv.points.shape[0]) for lv in scene.levels)
                     + f", scan {scene.scan.shape[0]} points")
    return dict(scene=scene, opt=opt, start=start, rec=rec, sample=sample, sampler=sampler)


def window(run, st) -> dict:
    opt, start, rec, tr = st["opt"], st["start"], st["rec"], run.traffic
    if run.tracing:
        opt.timings = {}
    rec.on = True
    iterations = episodes = 0
    lengths = []
    t0 = rec.t0 = time.perf_counter()
    while True:
        restore(opt, start)
        opt.current_scale = tr["scale"]
        t1, c1 = time.perf_counter(), rec.cost_calls
        report = opt.run_on_current_scale(max_iterations=tr["iterations"])
        lengths.append(f"{report.iterations} it {time.perf_counter() - t1:.3f} s {rec.cost_calls - c1} costs")
        iterations += report.iterations
        episodes += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds:
            break
    if run.tracing:  # a window shorter than the traced part
        run.boundary(elapsed, dict(iterations=rec.n_ladder, stages=dict(opt.timings)), last=True)
        opt.timings = None
    sync(run.device)
    seconds = time.perf_counter() - t0
    rec.on = False
    run.notes.append(f"episodes: {'; '.join(lengths)}; observations {opt.observations}")
    return dict(seconds=seconds, attempted=episodes,
                metrics={"lm_iteration_s": seconds / max(iterations, 1)})


def after_trace(run, st, summary) -> None:
    """Per-layer inputs that need the device after the traced window: B3's
    bound over the stashed launches and their kernel times."""
    rec = st["rec"]
    if rec.b3_stash is None or rec.b3_first is None:
        return
    times = summary["kernels"].get(B3_KERNEL, [])
    k = len(rec.b3_stash)
    nbytes = flops = 0.0
    for layout, pix, scale, derivs in rec.b3_stash:
        b, f = b3_model.launch_work(layout, pix, scale, derivs)
        nbytes, flops = nbytes + b, flops + f
    rec.b3_stash = None
    sel = times[rec.b3_first:rec.b3_first + k]
    if len(sel) == k and k:
        run.record["b3"] = dict(launches=k, seconds=sum(sel),
                                bound_s=b3_model.bound_seconds(nbytes, flops))


def _vis_by_level(vis):
    """The optimizer's frozen visibility (one group: per level, per chunk
    (mask, scale)) as per level (B, N) masks."""
    return [torch.cat([m for m, _ in chunks]) for chunks in vis[0]]


def numbers_of(got: dict, out: dict, sample, lim: dict, first_norm=None) -> dict:
    """The numbers compared for one iteration: ``got`` what the program (or
    the control) produced, ``out`` the reference's ``iteration``. The
    applied update is held against the reference's own norm at the
    episode's first iteration (``first_norm`` None), whose step is the
    largest, and against ``first_norm``, the first reference update's, at a
    later one (``late_step_gap``): a later step shrinks towards the float32
    state's rounding, so a gap over its own size grows without a fault."""
    tol_m, scale_band = lim["depth_tol_m"], lim["scale_band"]
    nums = {}
    if got.get("occl") is not None:
        nums["occl_bad"] = max(compare.depth_bad_share(got["occl"][j], out["occl"][b], tol_m)
                               for j, b in enumerate(sample))
    # a decision whose scale lies within ``scale_band`` of an integer (every
    # scale threshold is one) is rounding's: the program's float32
    # footprint scale is good to ~6e-5
    mism = sum(float(((p != m) & ((s - torch.round(s)).abs() >= scale_band)).sum())
               for p, (m, s) in zip(got["vis"], out["vis"]))
    nums["vis_diff"] = mism / max(sum(float(m.sum()) for m, _ in out["vis"]), 1.0)
    nums["H_gap"] = compare.gram_gap(got["H"], out["H"])
    nums["b_gap"] = compare.rhs_gap(got["b"], out["b"], out["H"], out["S"])
    nums["cost_gap"] = compare.relative_gap(got["cost"], out["cost"])
    if got.get("x") is not None and out.get("x") is not None:
        if first_norm is None:
            nums["step_gap"] = compare.step_gap(got["x"], out["x"], out["H"])
        else:
            nums["late_step_gap"] = compare.step_gap(got["x"], out["x"], out["H"], first_norm)
    return nums


def applied_update(cap):
    """The update x the program's ladder applied: ``params - x[:4]``,
    ``exp(-x_pose) . pose``, read from the states before and after."""
    p1, q1, t1 = cap["post"]
    d = se3_log_between(cap["q"], cap["t"], q1, t1)
    return torch.cat([cap["params"].double() - p1.double(), -d.reshape(-1)])


def check(run, st, prec: Prec):
    """The numbers compared, each the worst over the recorded iterations
    (the first recorded, from the start state, sets the later one's
    ``first_norm``)."""
    rec, lim = st["rec"], run.config["limits"]
    ref = RegistratorReference(st["scene"], run.config["registrator"], prec)
    numbers: dict = {}
    first_norm = None
    for i, cap in sorted(rec.captures.items()):
        out = ref.iteration(cap["params"], cap["q"], cap["t"], run.traffic["scale"], cap["lam"],
                            step="post" in cap)
        got = dict(occl=cap["occl"], vis=_vis_by_level(cap["vis"]), H=cap["H"], b=cap["b"],
                   cost=cap["cost"], x=applied_update(cap) if "post" in cap else None)
        start = cap["kind"] == "start"
        nums = numbers_of(got, out, st["sample"], lim, None if start else first_norm)
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
    seed draws, reached by following the reference's own ladder from the
    start."""
    state = (scene.params, scene.q_start.float(), scene.t_start.float())
    cfg, scale, lam = run.config["registrator"], run.traffic["scale"], 64.0
    B = scene.images.shape[0]
    _, later = plan_of(run.seed, B, run.traffic["iterations"])
    ref64 = RegistratorReference(scene, cfg, Prec("float64"))
    low = RegistratorReference(scene, cfg, prec)
    numbers: dict = {}
    first_norm = None
    for i in range(later + 1):
        out = ref64.iteration(*state, scale, lam)
        if i in (0, later):
            got = low.iteration(*state, scale, lam)
            got = dict(got, vis=[m for m, _ in got["vis"]])
            nums = numbers_of(got, out, list(range(B)), run.config["limits"],
                              None if i == 0 else first_norm)
            if i == 0 and out["x"] is not None:
                first_norm = compare.h_norm(out["x"], out["H"])
            for k, v in nums.items():
                numbers[k] = max(numbers.get(k, 0.0), v)
        (params, q, t), lam = out["next"]
        state = (params.float(), q.float(), t.float())
    return numbers


def release(st) -> None:
    """Free the program's state before the reference runs, and give the
    optimizer's module its own B3 entry back."""
    if st.get("sampler") is not None:
        import dataset_pipeline_tpu_torch.photometric.optimizer as po

        po.pyramid_sample = st.pop("sampler")
    st.pop("opt", None)
    rec = st["rec"]
    rec.opt = rec._orig = None
