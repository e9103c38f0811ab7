"""The ground-truth cells: closed loops of whole passes over the scene's images.

Set-up builds the scene from the seed on the device at its true poses, the
occlusion mesh's edge tables when the traffic takes the mesh
(``build_occlusion_mesh``, the tool's host set-up), and warms up with one
pass. A pass makes the per-image calls of
``tools/ground_truth_creator.py:main`` in its order: for every image the
occlusion depth (``render_occlusion_depth``), its copy to the host as the
tool converts it before writing, and the view counts (``_visible_mask``);
the counts to the host and the >= 2-view keep back to the device; then for
every image the ground-truth depth (``_gt_depth_image``) and its copy to
the host. The files are not written. The window runs passes back to back
until its seconds have passed; ``images_per_s`` is the images completed over
the window's seconds.

For ``correct`` the host arrays of the window's first pass are kept and,
after the window, held against the plain reference's: every occlusion map,
the view counts and every ground-truth map.
"""

from __future__ import annotations

import time

import torch

from perfbench import compare
from perfbench.harness import sync
from perfbench.reference.eth3d_dslr_gt import GroundTruthReference
from perfbench.reference.geometry import Prec
from perfbench.scene.dslr import make_scene
from perfbench.trace import span


def prepare(run):
    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.ops.mesh_raster import build_occlusion_mesh

    cfg, tr, dev = run.config, run.traffic, run.device
    mesh = tr["occlusion"] == "mesh"
    t0 = time.perf_counter()
    scene = make_scene(cfg["scene"], run.seed, dev, levels=False, mesh=mesh)
    sync(dev)
    t1 = time.perf_counter()
    cam = cm.make_camera("PINHOLE", scene.width, scene.height, scene.params, device=dev)
    poses = [SE3(q, t) for q, t in zip(scene.q_true.float(), scene.t_true.float())]
    occlusion_mesh = None
    if mesh:
        occlusion_mesh = build_occlusion_mesh(scene.mesh_vertices.cpu().numpy(),
                                              scene.mesh_faces.cpu().numpy(), device=dev)
    st = dict(scene=scene, cam=cam, poses=poses, mesh=occlusion_mesh)
    t2 = time.perf_counter()
    one_pass(run, st, timed=False)
    sync(dev)
    run.notes.append(f"set-up: scene {t1 - t0:.3f} s, mesh edges {t2 - t1:.3f} s, warm-up "
                     f"{time.perf_counter() - t2:.3f} s; scan {scene.scan.shape[0]} points")
    return st


def _timed(run, name: str):
    """A synchronised span of the traced run, summed into the record."""
    class Span:
        def __enter__(self):
            self.s = span(name, True)
            self.s.__enter__()
            sync(run.device)
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            sync(run.device)
            st = run.record.setdefault("stages", {})
            st[name] = st.get(name, 0.0) + time.perf_counter() - self.t0
            self.s.__exit__(*exc)
    return Span()


def one_pass(run, st, timed: bool):
    """One pass over the images: (occlusion maps, counts, ground-truth maps)
    on the host."""
    from dataset_pipeline_tpu_torch.tools import ground_truth_creator as gtc
    from dataset_pipeline_tpu_torch.utils.params import Parameters

    cam, poses, pts = st["cam"], st["poses"], st["scene"].scan
    W, H = cam.width, cam.height
    radius = Parameters().splat_radius
    def stage(name):
        return _timed(run, name) if timed else span(name, False)

    counts = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    occl, occl_host, gt_host = [], [], []
    for pose in poses:
        with stage("occlusion"):
            od = gtc.render_occlusion_depth(cam, pose, pts, radius, occlusion_mesh=st["mesh"])
        occl.append(od)
        with stage("gt_depth"):
            vis, _, _, _ = gtc._visible_mask(cam, pose.q, pose.t, pts, od, W, H, None)
            counts += vis.to(torch.int32)
        with stage("d2h"):
            occl_host.append(od.cpu().numpy())
    with stage("gt_depth"):
        counts_host = counts.cpu().numpy()
        keep = torch.from_numpy(counts_host >= 2).to(pts.device)
    for pose, od in zip(poses, occl):
        with stage("gt_depth"):
            d = gtc._gt_depth_image(cam, pose.q, pose.t, pts, keep, od, W, H, None)
        with stage("d2h"):
            gt_host.append(d.cpu().numpy())
    return occl_host, counts_host, gt_host


def window(run, st) -> dict:
    passes = 0
    first = None
    t0 = time.perf_counter()
    while True:
        out = one_pass(run, st, timed=run.tracing)
        if first is None:
            first = out
        passes += 1
        elapsed = time.perf_counter() - t0
        run.boundary(elapsed, dict(images=passes * len(st["poses"]),
                                   stages=dict(run.record.get("stages", {}))),
                     last=elapsed >= run.seconds)
        if elapsed >= run.seconds:
            break
    seconds = time.perf_counter() - t0
    st["first"] = first
    images = passes * len(st["poses"])
    return dict(seconds=seconds, attempted=images, metrics={"images_per_s": images / seconds})


def after_trace(run, st, summary) -> None:
    return None


def numbers_of(occl_got, counts_got, gt_got, ref_products, tol_m: float) -> dict:
    occl, counts, keep, gt = ref_products
    B = len(occl_got)
    return {
        "occl_bad": max(compare.depth_bad_share(occl_got[b], occl[b], tol_m) for b in range(B)),
        "count_diff": compare.mismatch_share(torch.as_tensor(counts_got), counts),
        "keep_diff": compare.mismatch_share(torch.as_tensor(counts_got) >= 2, keep),
        "gt_bad": max(compare.depth_bad_share(gt_got[b], gt[b], tol_m) for b in range(B)),
    }


def check(run, st, prec: Prec):
    ref = GroundTruthReference(st["scene"], run.config["ground_truth"], prec, run.traffic["occlusion"])
    occl_host, counts_host, gt_host = st["first"]
    numbers = numbers_of([torch.from_numpy(o) for o in occl_host], torch.from_numpy(counts_host),
                         [torch.from_numpy(g) for g in gt_host], ref.products(),
                         run.config["limits"]["depth_tol_m"])
    run.notes.append("pass 0: " + ", ".join(f"{k} {v:.3e}" for k, v in numbers.items()))
    return numbers


def control(run, scene, prec: Prec) -> dict:
    """The reference in ``prec`` put in the program's place, against the
    reference."""
    cfg, kind = run.config["ground_truth"], run.traffic["occlusion"]
    out = GroundTruthReference(scene, cfg, Prec("float64"), kind).products()
    occl, counts, _, gt = GroundTruthReference(scene, cfg, prec, kind).products()
    return numbers_of(list(occl), counts, list(gt), out, run.config["limits"]["depth_tol_m"])


def release(st) -> None:
    st.pop("mesh", None)
