"""The THIN_PRISM_FISHEYE registrator cell (``drivers/register_fisheye.py``)
at a toy size on the CPU: the program against the plain fisheye reference,
the TF32 control, the parent's pinhole splats under the lens (which
``correct`` must catch), and the scene's rays through the lens."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from perfbench import compare, harness
from perfbench.reference import eth3d_dslr_fisheye_register as ref
from perfbench.reference.geometry import Prec
from perfbench.scene import dslr_fisheye
from perfbench.tests.toy import TOY_SCENE, run_toy, toy_base, toy_bench

CELL = "toy.fisheye"


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The toy folder with the fisheye configuration cut as the toy cells
    are (2 images of 640x480, ~200,000 scan points) and its traffic mix."""
    b = toy_base(tmp_path_factory.mktemp("toy_fisheye"))
    cfg = harness.load_json("configs", "eth3d_dslr_fisheye_register")
    cfg["scene"].update(TOY_SCENE, level_points=[20000, 6000, 1500])
    cfg["registrator"]["scale_count"] = 3
    (b / "configs" / "toy_fisheye.json").write_text(json.dumps(cfg))
    (b / "traffic" / "toy_fisheye.json").write_text(
        json.dumps({"driver": "register_fisheye", "scale": 0, "iterations": 2}))
    return b


def bench():
    """BENCHMARK.json with the toy cells and the fisheye toy cell, which
    reports every metric of ``dslr_fisheye.full_res``."""
    b = toy_bench()
    b["workloads"].append(dict(name=CELL, config="toy_fisheye", traffic="toy_fisheye", chips=1,
                               why="toy"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "dslr_fisheye.full_res" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    return b


def test_the_program_matches_the_fisheye_reference(base):
    res = run_toy(base, CELL, seed=2**31 + 11, bench=bench())
    assert res["correct"] is True, res["stderr"]
    assert res["attempted"] >= 1 and res["metrics"]["lm_iteration_s"]["value"] > 0


def test_a_traced_run_reports_the_fisheye_layers(base):
    """On the CPU the geometry is the plain jvp (no kernel rows, no launch):
    the kernel's shares are left out, every span-based metric is read."""
    res = run_toy(base, CELL, seed=5, trace=True, bench=bench())
    assert res["correct"] is True, res["stderr"]
    got = set(res["metrics"])
    assert {"hb_accumulate_ms.fisheye", "hb_geometry_ms.fisheye", "hb_gram_ms.fisheye",
            "refresh_ms.fisheye", "occlusion_project_ms.fisheye"} <= got
    assert not {"hb_geometry_kernel_share.fisheye", "hb_geometry_roofline_share.fisheye"} & got
    assert 0 < res["metrics"]["occlusion_project_ms.fisheye"]["value"] < \
        res["metrics"]["refresh_ms.fisheye"]["value"]


def test_the_tf32_control_is_not_correct(base):
    config = harness.load_json("configs", "toy_fisheye", base)
    traffic = harness.load_json("traffic", "toy_fisheye", base)
    run = harness.Run(CELL, config, traffic, 7, 0.5, False, torch.device("cpu"))
    scene = dslr_fisheye.make_scene(config["scene"], 7, "cpu")
    numbers = harness.load_driver(traffic["driver"]).control(run, scene, Prec("tf32"))
    correct, _ = compare.verdict(numbers, config["limits"]["compared"])
    assert not correct, numbers


def test_pinhole_splats_under_the_lens_are_caught(base, monkeypatch):
    """The splat occlusion that places the centres at the pinhole's pixels
    whatever the camera (the program before the lens reached it) is caught
    by the occlusion depths."""
    from dataset_pipeline_tpu_torch.photometric import optimizer as po

    orig = po.render_splats_depth

    def pinhole(points_cam, radii, camera, *a, **k):
        return orig(points_cam, radii, dataclasses.replace(camera, lens=False), *a, **k)

    monkeypatch.setattr(po, "render_splats_depth", pinhole)
    res = run_toy(base, CELL, seed=13, bench=bench())
    assert res["correct"] is False, res["compared"]
    c = res["compared"]["occl_bad"]
    assert c["value"] > 10 * c["limit"]


@pytest.mark.parametrize("fault", ["scale", "mask"])
def test_a_wrong_decision_on_a_scale_threshold_is_caught(base, monkeypatch, fault):
    """The program's frozen visibility altered only at the points whose
    scale lies within ``scale_band`` of an integer, where the reference
    decides at the program's scale: a scale 1e-2 off, or the mask turned
    over, counts against ``vis_diff``."""
    from dataset_pipeline_tpu_torch.photometric import optimizer as po

    orig = po.PhotometricOptimizer._visibility

    def altered(self, occl):
        out = orig(self, occl)
        for g in out:
            for lv in g:
                for i, (m, sc) in enumerate(lv):
                    near = (sc - torch.round(sc)).abs() < 1e-3
                    if fault == "scale":
                        lv[i] = (m, torch.where(near, sc + 1e-2, sc))
                    else:
                        lv[i] = (torch.where(near, ~m, m), sc)
        return out

    monkeypatch.setattr(po.PhotometricOptimizer, "_visibility", altered)
    res = run_toy(base, CELL, seed=17, bench=bench())
    assert res["correct"] is False, res["compared"]
    c = res["compared"]["vis_diff"]
    assert c["value"] > 10 * c["limit"]


def test_the_rays_invert_the_lens():
    """Each pixel centre's ray projects back onto it through the reference's
    projection, and the border's rays reach wider than the pinhole's."""
    cfg = dict(harness.load_json("configs", "eth3d_dslr_fisheye_register")["scene"])
    params = dslr_fisheye.lens_params(cfg, "cpu").double()
    W, H = cfg["image_size"]
    u = torch.tensor([0.0, W - 1.0, 0.5 * (W - 1), 17.0, 3001.0], dtype=torch.float64)
    v = torch.tensor([0.0, H - 1.0, 0.5 * (H - 1), 4000.0, 9.0], dtype=torch.float64)
    nx, ny = dslr_fisheye.pixel_rays(params, u, v)
    x, y, ok = ref.lens_project(torch.stack([3 * nx, 3 * ny, torch.full_like(nx, 3.0)], -1), params,
                                ref.radius_cutoff_sq(params, W, H))
    assert bool(ok.all()) and float((x - u).abs().max()) < 1e-6 and float((y - v).abs().max()) < 1e-6
    rx, ry = dslr_fisheye.border_reach(cfg, params)
    assert rx > 0.5 * W / cfg["focal"] and ry > 0.5 * H / cfg["focal"]
    half_w, half_h = dslr_fisheye.extents(cfg, params, 1.05)
    assert cfg["scan_density"] * 4 * half_w * half_h <= 28_238_400
