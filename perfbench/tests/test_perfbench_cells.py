"""Each traffic mix's set-up, timed loop and comparison at a toy size on the
CPU: the program against the plain reference, the TF32 control, and the
run with the timed path broken underneath, which ``correct`` must catch."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare, harness
from perfbench.reference.geometry import Prec
from perfbench.scene.dslr import make_scene
from perfbench.tests.toy import TOY_SCENE, run_toy, toy_base

CELLS = ["toy.register", "toy.gt_mesh", "toy.gt_splats"]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return toy_base(tmp_path_factory.mktemp("toy"))


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_matches_the_reference(base, cell):
    res = run_toy(base, cell, seed=2**31 + 11)
    assert res["correct"] is True, res["stderr"]
    assert res["attempted"] >= 1
    key = "lm_iteration_s" if "register" in cell else "images_per_s"
    assert res["metrics"][key]["value"] > 0


def test_the_scene_depends_on_the_seed_only_in_its_draws():
    cfg = dict(harness.load_json("configs", "eth3d_dslr_register")["scene"], **TOY_SCENE,
               level_points=[2000, 600])
    a, b, c = (make_scene(cfg, s, "cpu") for s in (5, 5, 6))
    assert torch.equal(a.images, b.images) and torch.equal(a.scan, b.scan)
    assert torch.equal(a.levels[0].neighbors, b.levels[0].neighbors)
    assert a.scan.shape == c.scan.shape and not torch.equal(a.scan, c.scan)
    assert [lv.points.shape for lv in a.levels] == [lv.points.shape for lv in c.levels]
    nb = a.levels[0].neighbors
    assert bool((nb != torch.arange(nb.shape[0])[:, None]).all())
    assert all(len(set(r)) == nb.shape[1] for r in nb[:200].tolist())


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(base, cell):
    """The reference computed with TF32 products in the program's place
    fails the cell's limits."""
    config = harness.load_json("configs", "toy_" + ("register" if "register" in cell else "gt"), base)
    traffic = harness.load_json("traffic", cell.replace("toy.", "toy_"), base)
    run = harness.Run(cell, config, traffic, 7, 0.5, False, torch.device("cpu"))
    scene = make_scene(config["scene"], 7, "cpu", levels=traffic["driver"] == "register",
                       mesh=traffic.get("occlusion") == "mesh")
    numbers = harness.load_driver(traffic["driver"]).control(run, scene, Prec("tf32"))
    correct, _ = compare.verdict(numbers, config["limits"]["compared"])
    assert not correct, numbers


def _not_correct(base, cell, monkeypatch, target, replacement):
    monkeypatch.setattr(target[0], target[1], replacement)
    res = run_toy(base, cell, seed=13)
    assert res["correct"] is False, res["compared"]
    return res


def test_a_step_that_leaves_the_state_unchanged_is_caught(base, monkeypatch):
    from dataset_pipeline_tpu_torch.photometric.optimizer import PhotometricOptimizer

    res = _not_correct(base, "toy.register", monkeypatch, (PhotometricOptimizer, "_lm_solve_apply"),
                       lambda self, H, bb, initial, offsets, vis: (True, 1.0))
    assert res["compared"]["step_gap"]["value"] == pytest.approx(1.0)


def test_a_later_step_applied_double_is_caught(base, monkeypatch):
    """A ladder that applies twice its update at every iteration after an
    episode's first passes the first step's check and is caught by the
    later one's."""
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.photometric.optimizer import PhotometricOptimizer
    from perfbench.reference.geometry import se3_compose, se3_exp, se3_log_between

    orig, start = PhotometricOptimizer._lm_solve_apply, []

    def doubled(self, *a, **k):
        g = self.p.groups[0]
        p0, q0, t0 = g.camera.params.clone(), g.poses.q.clone(), g.poses.t.clone()
        out = orig(self, *a, **k)
        if not start:
            start.append(q0)
        if torch.equal(q0, start[0]):  # an episode's first iteration
            return out
        p1, q1, t1 = g.camera.params, g.poses.q, g.poses.t
        dq, dt = se3_exp(se3_log_between(q0, t0, q1, t1))
        q2, t2 = se3_compose(dq, dt, q1.double(), t1.double())
        g.camera = g.camera.with_params(2 * p1 - p0)
        g.poses = SE3(q2.float(), t2.float())
        return out

    res = _not_correct(base, "toy.register", monkeypatch, (PhotometricOptimizer, "_lm_solve_apply"),
                       doubled)
    c = res["compared"]
    assert c["step_gap"]["value"] <= c["step_gap"]["limit"]
    assert c["late_step_gap"]["value"] > c["late_step_gap"]["limit"]


def test_half_the_images_left_out_of_h_b_is_caught(base, monkeypatch):
    from dataset_pipeline_tpu_torch.parallel import photometric as pp

    orig = pp.ShardedPhotometricKernels.hb_batch

    def half(self, camera, params, pose_q, pose_t, points, neighbors, desc, flat, layout, obs_scale,
             contrib, *a, **k):
        contrib = contrib.clone()
        contrib[contrib.shape[0] // 2:] = False
        return orig(self, camera, params, pose_q, pose_t, points, neighbors, desc, flat, layout,
                    obs_scale, contrib, *a, **k)

    res = _not_correct(base, "toy.register", monkeypatch, (pp.ShardedPhotometricKernels, "hb_batch"), half)
    assert res["compared"]["H_gap"]["value"] > 0.5


def test_an_occlusion_depth_altered_where_made_is_caught(base, monkeypatch):
    from dataset_pipeline_tpu_torch.photometric import optimizer as po

    orig = po.render_splats_depth
    _not_correct(base, "toy.register", monkeypatch, (po, "render_splats_depth"),
                 lambda *a, **k: orig(*a, **k) - 0.01)


def test_half_the_images_left_out_of_the_counts_is_caught(base, monkeypatch):
    from dataset_pipeline_tpu_torch.tools import ground_truth_creator as gtc

    orig, seen = gtc._visible_mask, []

    def half(camera, pose_q, pose_t, points, occl_depth, width, height, eval_mask=None):
        vis, ix, iy, z = orig(camera, pose_q, pose_t, points, occl_depth, width, height, eval_mask)
        seen.append(1)
        return (vis & (len(seen) % 2 == 0)), ix, iy, z

    res = _not_correct(base, "toy.gt_splats", monkeypatch, (gtc, "_visible_mask"), half)
    assert res["compared"]["count_diff"]["value"] > 0.1


@pytest.mark.parametrize("cell", ["toy.gt_mesh", "toy.gt_splats"])
def test_a_ground_truth_depth_altered_where_made_is_caught(base, monkeypatch, cell):
    from dataset_pipeline_tpu_torch.tools import ground_truth_creator as gtc

    orig = gtc._gt_depth_image

    def altered(*a, **k):
        d = orig(*a, **k).clone()
        d[: d.shape[0] // 8] += 0.01
        return d

    res = _not_correct(base, cell, monkeypatch, (gtc, "_gt_depth_image"), altered)
    assert res["compared"]["gt_bad"]["value"] > 0.01
