"""How far joint BA recovers a scan-pose error: LM runs from chosen starts.

Builds the joint-BA scenes once (``utils/synthetic.py``: by default the DSLR
configuration, two scenes of 8 images that share the camera, each scanned
twice, scan 1's ``.mlp`` pose off by ``scale * SCAN1_ERROR``), packs them as
``tools/joint_ba.py`` does, and runs the LM loop from several starts, one
JSON line per run: the cost, each scene's scan-1 error |log(C E)| and the
mean image pose error (m at 5 m) after every iteration.

Starts (``--starts``): ``perturbed`` (the state files: perturbed image poses,
scan 1 off), ``true_images`` (the true image poses, scan 1 off), ``truth``
(the true image poses and scan 1 corrected exactly), ``coarse3`` (the state
files, then scales 3..0, ``--iterations`` each, as ``--start_scale 3``).

Run on the card: ``python -m dataset_pipeline_tpu_torch.experiments.joint_ba_study``;
on the CPU at a toy size: ``--device cpu --width 160 --height 120 --images 2
--scan_density 3000 --scenes 1``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.parallel import joint_ba as J
from dataset_pipeline_tpu_torch.tools.joint_ba import build_scene
from dataset_pipeline_tpu_torch.utils import synthetic
from dataset_pipeline_tpu_torch.utils.params import Parameters
from dataset_pipeline_tpu_torch.utils.timing import StageTimer


def parse_args(argv=None):
    c = synthetic.DSLR
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--width", type=int, default=c["width"])
    p.add_argument("--height", type=int, default=c["height"])
    p.add_argument("--f", type=float, default=None, help="focal length (default: the DSLR's, scaled)")
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--scan_density", type=float, default=c["scan_density"],
                   help="points per m^2 over both scans")
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--scales", default="1.0,0.1", help="scan-1 error scales of SCAN1_ERROR")
    p.add_argument("--starts", default="perturbed,true_images,truth,coarse3")
    return p.parse_args(argv)


def _scan1_errors(state, E, n_scenes: int):
    return [float(torch.linalg.norm(SE3.from_matrix(
        SE3(state["corr_q"][si, 1], state["corr_t"][si, 1]).matrix() @ E).log()))
        for si in range(n_scenes)]


def _pose_error(state, tq, tt) -> float:
    """Mean displacement (m) of the point 5 m ahead of each camera."""
    ahead = torch.tensor([0.0, 0.0, 5.0], dtype=torch.float32, device=tq.device).expand(len(tq), 3)
    a = SE3(state["pose_q"], state["pose_t"]).inverse().apply(ahead)
    b = SE3(tq, tt).inverse().apply(ahead)
    return float(torch.linalg.norm(a - b, dim=1).mean())


def study(args, scale: float, device, root: str):
    c = synthetic.DSLR
    f = args.f or c["f"] * args.width / c["width"]
    error = tuple(scale * v for v in synthetic.SCAN1_ERROR)
    params = Parameters()
    params.merge_distance_factor = c["merge_distance_factor"]
    timer = StageTimer(device)
    scenes, clouds, tqs, tts = [], {}, [], []
    t0 = time.perf_counter()
    for si in range(args.scenes):
        d = os.path.join(root, f"scale{scale}_scene{si}")
        hw, hh = synthetic.scan_extent(args.width, args.height, f, args.images, synthetic.DEPTH,
                                       c["baseline"])
        n = int(args.scan_density * 4 * hw * hh) // 2
        tq, tt = synthetic.write_scene(d, args.width, args.height, f, args.images, n, seed=21 + 10 * si,
                                       device=device, baseline=c["baseline"], n_scans=2,
                                       scan1_error=error)
        tqs.append(tq)
        tts.append(tt)
        sc, _, _, pts, normals = build_scene(os.path.join(d, "scene.mlp"), os.path.join(d, "state"),
                                             os.path.join(d, "images"), params, -1, 0.1, 30.0, 8,
                                             device, timer)
        clouds.update({(si, s): (pts[s], normals[s]) for s in range(2)})
        scenes.append(sc)
    pack = J.pack_scenes(device, scenes, occlusion_radius=params.splat_radius,
                         occlusion_depth_threshold=params.occlusion_depth_threshold)
    setup_s = time.perf_counter() - t0
    E = torch.as_tensor(synthetic.scan1_matrix(error), dtype=torch.float32, device=device)
    tq = torch.as_tensor(np.concatenate(tqs), dtype=torch.float32, device=device)
    tt = torch.as_tensor(np.concatenate(tts), dtype=torch.float32, device=device)
    base = J.make_state(pack)
    corr_q, corr_t = base["corr_q"].clone(), base["corr_t"].clone()
    undo = SE3.from_matrix(torch.linalg.inv(E.double()).float())
    corr_q[:, 1], corr_t[:, 1] = undo.q, undo.t
    starts = {"perturbed": base, "true_images": dict(base, pose_q=tq, pose_t=tt),
              "truth": dict(base, pose_q=tq, pose_t=tt, corr_q=corr_q, corr_t=corr_t),
              "coarse3": base}
    icp = dict(pt=pack.icp_pt.clone(), nt=pack.icp_nt.clone(), w0=pack.icp_w0_np.copy())
    for name in args.starts.split(","):
        pack.icp_pt, pack.icp_nt = icp["pt"].clone(), icp["nt"].clone()
        pack.icp_w = torch.as_tensor(icp["w0"], device=device)
        state = start = starts[name]
        trace = []
        t0 = time.perf_counter()
        for level in range(3 if name == "coarse3" else 0, -1, -1):
            state = J.run_joint_ba(
                pack, max_iterations=args.iterations, current_scale=float(level), state=state,
                icp_refresh_fn=lambda pk, st: J.refresh_icp_correspondences(pk, st, clouds, 0.1),
                on_iteration=lambda it, st, cost, level=level: trace.append(
                    {"scale": level, "cost": cost, "scan1_error": _scan1_errors(st, E, len(scenes)),
                     "pose_error_m": _pose_error(st, tq, tt)})).state
        card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(json.dumps({"device": card, "scan1_error_scale": scale, "start": name,
                          "setup_s": setup_s, "seconds": time.perf_counter() - t0,
                          "scan1_error_start": _scan1_errors(start, E, len(scenes)),
                          "pose_error_start_m": _pose_error(start, tq, tt), "trace": trace}),
              flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as root:
        for scale in (float(v) for v in args.scales.split(",")):
            study(args, scale, device, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
