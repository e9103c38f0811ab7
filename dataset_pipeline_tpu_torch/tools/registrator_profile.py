"""A/B timing and device profile of the registrator's LM iterations.

Writes a synthetic scene (``utils/synthetic.py``; by default the DSLR
configuration that ``chip_smoke.py`` drives), runs the image registrator's
set-up once (``tools.image_registrator.build_problem``), then runs
``--iterations`` LM iterations at full resolution (scale 0) from the same
initial state under each variant, in the order A B C C B A:

- ``base``: the CUDA pyramid sampler and the row-split Gram products, as the
  tool runs;
- ``plain_sampler``: the plain PyTorch sampler (``sample_plain``) in place
  of the kernel;
- ``single_gram``: one Gram product per image over all rows (``_GRAM_ROWS``
  above any level size) in place of the split products.

Then it runs ``base`` for 2 iterations under ``torch.profiler`` and
reports the device busy time (the union of the kernels' intervals), the
idle share of the profiled wall and the top device ops.

Run: ``python -m dataset_pipeline_tpu_torch.tools.registrator_profile
--out reg_profile.json`` (``--device cpu`` and a small
``--width``/``--height``/``--images``/``--scan_density`` for a check
without a GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from dataset_pipeline_tpu_torch import kernels, resolve_device
from dataset_pipeline_tpu_torch.ops import pyramid_sample as ps
from dataset_pipeline_tpu_torch.photometric import optimizer as po
from dataset_pipeline_tpu_torch.tools import image_registrator as reg
from dataset_pipeline_tpu_torch.utils import synthetic
from dataset_pipeline_tpu_torch.utils.timing import StageTimer, stages_text

ORDER = ("base", "plain_sampler", "single_gram", "single_gram", "plain_sampler", "base")
PROFILE_ITERATIONS = 2
SEED = 5


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Variant:
    """Swap the sampler or the Gram row split in ``photometric.optimizer``
    for the duration of a ``with`` block."""

    def __init__(self, name: str):
        self.name = name
        self.saved = (po.pyramid_sample, po._GRAM_ROWS)

    def __enter__(self):
        if self.name == "plain_sampler":
            po.pyramid_sample = plain_sampler
        elif self.name == "single_gram":
            po._GRAM_ROWS = 1 << 40

    def __exit__(self, *exc):
        po.pyramid_sample, po._GRAM_ROWS = self.saved


def plain_sampler(flat, layout, pix0, obs_scale, with_derivs=True, pairs=None):
    """The plain sampler in the kernel wrapper's signature (it reads ``flat``)."""
    return ps.sample_plain(flat, layout, pix0, obs_scale, with_derivs)


def run_iterations(problem, init, args, params, device, iterations: int) -> dict:
    """``iterations`` LM iterations at scale 0 from the state ``init``."""
    for g, (cam, poses) in zip(problem.groups, init):
        g.camera, g.poses = cam, poses
    timings, costs, obs = {}, [], []
    opt = reg.make_optimizer(problem, args, params, timings)
    opt.current_scale = 0
    kernels.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    report = opt.run_on_current_scale(iterations, iteration_costs=costs, observations=obs)
    _sync(device)
    seconds = time.perf_counter() - t0
    return dict(seconds=seconds, s_per_iteration=seconds / report.iterations,
                iterations=report.iterations, optimum_cost=report.optimum_cost,
                iteration_costs=costs, observations=obs, stages=timings,
                launches=dict(kernels.LAUNCHES))


def profile_base(problem, init, args, params, device, iterations: int) -> dict:
    """``base`` under torch.profiler: device busy seconds (union of the
    kernel intervals), idle share of the profiled wall, top device ops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_iterations(problem, init, args, params, device, iterations)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -float("inf")
    for a, b in spans:  # union of the intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:12]
    out = dict(iterations=iterations, wall_s=wall, device_kernels=len(spans),
               device_busy_s=busy_us * 1e-6 if spans else None,
               idle_share=1.0 - busy_us * 1e-6 / wall if spans else None,
               top_device_ops=[dict(name=e.key, self_device_s=e.self_device_time_total * 1e-6,
                                    calls=e.count) for e in ops if e.self_device_time_total > 0])
    out["table"] = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25) \
        if spans else ""
    return out


def main(argv=None) -> int:
    c = synthetic.DSLR
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=c["width"])
    p.add_argument("--height", type=int, default=c["height"])
    p.add_argument("--images", type=int, default=c["n_images"])
    p.add_argument("--scan_density", type=float, default=c["scan_density"])
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="", help="write the JSON result here")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    f = c["f"] * a.width / c["width"]

    result = dict(config=vars(a) | dict(f=f))
    if device.type == "cuda":
        result["device"] = torch.cuda.get_device_name(device)
    with tempfile.TemporaryDirectory() as root:
        n_scan, _, _ = synthetic.write_scene_at_density(
            root, a.width, a.height, f, a.images, c["baseline"], a.scan_density, SEED,
            device=device)
        args, params = reg.parse_args([
            "--scan_alignment_path", os.path.join(root, "scene.mlp"),
            "--image_base_path", os.path.join(root, "images"),
            "--state_path", os.path.join(root, "state"),
            "--output_folder_path", os.path.join(root, "out"),
            "--merge_distance_factor", str(c["merge_distance_factor"]), "--device", a.device])
        timer = StageTimer(device)
        stats = {}
        problem, _, _, _ = reg.build_problem(args, params, device, timer, stats)
    init = [(g.camera, g.poses) for g in problem.groups]
    result.update(scan_points=n_scan, levels=stats["levels"], setup_s=timer.totals, runs=[])
    run_iterations(problem, init, args, params, device, 1)  # warm-up: kernel build, caches
    for name in ORDER:
        with _Variant(name):
            r = run_iterations(problem, init, args, params, device, a.iterations)
        result["runs"].append(dict(variant=name, **r))
        print(f"{name}: {r['seconds']:.3f} s for {r['iterations']} iterations "
              f"({r['s_per_iteration']:.3f} s/iteration); optimum {r['optimum_cost']:.6f}; "
              "stages " + stages_text(r["stages"]))
    prof = profile_base(problem, init, args, params, device, PROFILE_ITERATIONS)
    print(prof.pop("table"))
    result["profile"] = prof
    busy = prof["device_busy_s"]
    print(f"profile: {prof['iterations']} iterations, wall {prof['wall_s']:.3f} s, "
          + (f"device busy {busy:.3f} s, idle share {prof['idle_share']:.3f}, "
             f"{prof['device_kernels']} kernels" if busy is not None
             else "device time not measured (no device events)"))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
