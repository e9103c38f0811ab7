"""Port vs JAX: the bench tool (``tools/bench.py``) on the CPU at toy sizes.

The JAX package's ``bench.py`` is loaded by path. Its sections draw their
inputs inside their bodies, so a test runs a section with one JAX function
wrapped (``capture``): the wrapper keeps that call's arguments (and result),
then stops the section. The port's inputs are held equal to what the JAX
section passed; ``_hb_batch`` on the photometric_hb inputs is held to the
bounds of ``tests/test_torch_photometric.py:113-115`` (count equal, cost 1e-5
relative, H and b 1e-4 of their largest entry); a GT depth frame bit for bit,
as the ground-truth tool's files are. The tool's own line: one JSON object,
rc 0 and the documented keys at toy sizes, every value finite, no share of a
card's peak from a CPU run; rc 1 with ``errors`` when a section raises.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu_torch.tools import bench

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def load_bench_py():
    spec = importlib.util.spec_from_file_location("_jax_side_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Stop(Exception):
    """Raised by a captured function once it has what the test needs."""


def capture(monkeypatch, module, name: str, run: bool = True) -> list:
    """Wrap ``module.name``: its first call's (args, kwargs, result) is kept
    (the function runs only with ``run``), then ``Stop`` is raised."""
    calls, orig = [], getattr(module, name)

    def wrapped(*args, **kw):
        calls.append((args, kw, orig(*args, **kw) if run else None))
        raise Stop

    monkeypatch.setattr(module, name, wrapped)
    return calls


def np_(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


ICP_KEYS = {"m", "iters", "icp_lm_step_s", "icp_schedule_s", "icp_schedule_dispatch_s",
            "icp_schedule_final_cost", "icp_moment_accum_corr_per_s", "hbm_copy_gbps",
            "icp_moment_pass_event_s", "icp_moment_pass_bytes", "icp_engine_speedup_0m",
            "kernel_variants_ms", "icp_moment_bytes_per_corr", "icp_moment_flops_per_corr"}
ICP_KEYS |= {f"{k}{s}" for k in ("icp_moment_pass_s", "icp_moment_pass_gbps", "icp_gn_corr_iters_per_s")
             for s in ("", "_min", "_max")}
ICP_KEYS |= {f"icp_engine_{k}_{v}_0m" for k in ("moment", "direct", "device_lm") for v in ("s", "cost")}
ICP_KEYS |= {"icp_engine_moment_pose_gap_0m", "icp_engine_device_lm_pose_gap_0m"}
SECTION_KEYS = {
    "device_kind", "photometric_hb_obs_per_s", "photometric_hb_count", "gt_depth_frames_per_s",
    "gt_depth_valid_px_min", "registrator_e2e_s", "cubemap_2048_faces_per_s", "cubemap_uncoloured_px",
    "ref_cpp_cubemap_faces_per_s", "ref_cpp_gt_depth_frames_per_s", "cubemap_vs_ref",
    "gt_depth_vs_ref", "gather_micro_gbps", "gather_item_ns", "gather_row128_gbps",
    "gather_row128_item_ns", "photometric_hb_gather_bound_obs_per_s",
    "photometric_hb_gather_bound_pct", "joint_ba_step_s", "joint_ba_rows", "joint_ba_images",
    "joint_ba_cost0", "joint_ba_cost_final", "joint_ba_host_rss_mb", "joint_ba_dense_step_s",
    "joint_ba_dense_rows", "joint_ba_dense_cost", "scaling", "registrator_dslr_iter_s",
    "registrator_dslr_lm_step_s", "registrator_dslr_points", "registrator_dslr_images",
    "registrator_dslr_obs_per_iter", "registrator_dslr_obs_per_s", "registrator_dslr_cost_first",
    "registrator_dslr_cost_optimum", "ref_cpp_photo_obs_per_s", "ref_cpp_photo_obs_per_s_min",
    "ref_cpp_photo_obs_per_s_max", "registrator_dslr_vs_ref", "ref_cpp_icp_corr_per_s",
    "vs_ref_kernel"}


def test_main_prints_one_json_line_with_every_key(capsys):
    results = {}
    assert bench.main(["--device", "cpu", "--toy"], results=results) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out == results and len([ln for ln in lines if ln.startswith("{")]) == 1
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "metrics"}
    assert out["metric"] == "icp_gn_correspondences_per_s" and "host time on the CPU" in out["unit"]
    m = out["metrics"]
    # no share of a card's peak, no device split or copy rate, no kernel launch from a CPU run
    assert set(m) == ICP_KEYS | SECTION_KEYS, set(m) ^ (ICP_KEYS | SECTION_KEYS)
    assert m["device_kind"] == "cpu" and m["scaling"]["device"] == "cpu"
    for k, v in _flat({"value": out["value"], "vs_baseline": out["vs_baseline"], **m}):
        if isinstance(v, str):
            continue
        assert math.isfinite(v) and v >= 0, (k, v)
    assert out["value"] == m["icp_gn_corr_iters_per_s"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / m["ref_cpp_icp_corr_per_s"])
    toy = bench.TOY
    assert m["photometric_hb_count"] > toy["photometric_hb"]["nb"] * toy["photometric_hb"]["n_points"] // 2
    assert m["cubemap_uncoloured_px"] == 0 and m["gt_depth_valid_px_min"] > 0
    assert m["registrator_dslr_obs_per_iter"] > 0 and m["joint_ba_rows"] > 0
    assert m["registrator_dslr_images"] == toy["registrator_dslr"]["n_images"]
    assert m["photometric_hb_gather_bound_obs_per_s"] == pytest.approx(
        1e9 / (12 * m["gather_row128_item_ns"]))


def test_a_failed_section_gives_rc_1_and_errors(monkeypatch, capsys):
    def broken(*a, **kw):
        raise ValueError("planted")

    monkeypatch.setattr(bench, "bench_gt_depth", broken)
    skip = ",".join(s for s in bench.SECTIONS if s not in ("gt_depth", "ref_render_baselines"))
    results = {}
    assert bench.main(["--device", "cpu", "--toy", "--skip", skip], results=results) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == results
    assert set(out["errors"]) == {"gt_depth"} and "planted" in out["errors"]["gt_depth"]
    assert "gt_depth_frames_per_s" not in out["metrics"] and "gt_depth_vs_ref" not in out["metrics"]
    assert out["metrics"]["ref_cpp_gt_depth_frames_per_s"] > 0
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--skip", "no_such_section"])


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run the whole bench on it")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])


def test_cube_cloud_and_gather_inputs_are_bench_py_s(monkeypatch):
    import jax.numpy as jnp

    jb = load_bench_py()
    for a, b in zip(bench._cube_cloud(5000), jb._cube_cloud(5000)):
        np.testing.assert_array_equal(a, b)
    # bench.py's gather section hands each array it draws to jnp.asarray: J,
    # idx, the xs, the 32 MB table, the row indices (4 M each, fixed there)
    n, reps, drawn, orig = 5000, 2, [], jnp.asarray

    def keep(x, *a, **kw):
        if isinstance(x, np.ndarray):
            drawn.append(x.copy())
            if len(drawn) == 2 * reps + 3:
                raise Stop
        return orig(x, *a, **kw)

    monkeypatch.setattr(jnp, "asarray", keep)
    with pytest.raises(Stop):
        jb.bench_gather_roofline(n=n, nb=2, reps=reps)
    J, idx, xs, table, ridx = bench.gather_inputs(n=n, nb=2, reps=reps, table_mb=32,
                                                  n_rows=4_000_000)
    for a, b in zip([J, idx, *xs, table, *ridx], drawn, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_gather_sums_match_numpy():
    """The gather section's two functions on its own toy inputs: within 1e-5
    of a float64 numpy evaluation, relative to the magnitudes added."""
    J, idx, xs, table, ridx = bench.gather_inputs(n=5000, K=5, V=10, nb=2, reps=2, table_mb=1,
                                                  n_rows=20_000)
    assert len(xs) == len(ridx) == 2 and table.shape == (2048, 128)
    got = bench.gather_micro(torch.from_numpy(J), torch.from_numpy(idx).long(),
                             torch.from_numpy(xs[1])).numpy()
    J64, x64 = J.astype(np.float64), xs[1].astype(np.float64)
    want = sum(J64[:, idx[:, k], :] * x64[None] for k in range(idx.shape[1])).sum(axis=(0, 2))
    scale = sum(np.abs(J64[:, idx[:, k], :] * x64[None]) for k in range(idx.shape[1])).sum(axis=(0, 2))
    assert np.all(np.abs(got - want) <= 1e-5 * scale)
    got = float(bench.gather_rows(torch.from_numpy(table), torch.from_numpy(ridx[0]).long()))
    rows = table[ridx[0]].astype(np.float64)
    assert abs(got - rows.sum()) <= 1e-5 * np.abs(rows).sum()


def test_photometric_hb_inputs_and_hb_batch_match_jax(monkeypatch):
    """The photometric_hb section's inputs are bench.py's, and the port's
    ``_hb_batch`` on them equals JAX's."""
    import dataset_pipeline_tpu.photometric.optimizer as jpo

    size = dict(nb=2, n_points=2000, K=5, L=4, W=128, H=96)
    calls = capture(monkeypatch, jpo, "_hb_batch")
    with pytest.raises(Stop):
        load_bench_py().bench_photometric_hb(**size, reps=1)
    (cam, params, pose_q, pose_t, pts, nbr, desc, pyr, obs_scale, contrib, radius), kw, jout = calls[0]
    assert kw == dict(optimize_intrinsics=True, dynamic_scale=True) and radius == 0.01
    x = bench.photometric_hb_inputs(**size)
    np.testing.assert_array_equal(np.asarray(params), np.float32(x["params"]))
    assert (cam.model, cam.width, cam.height) == ("PINHOLE", 128, 96)
    for got, want in ((x["pts"], pts), (x["nbr"], nbr), (x["desc"], desc), (x["obs_scale"], obs_scale)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(x["pyr"]) == len(pyr) == 4
    for got, want in zip(x["pyr"], pyr):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert np.asarray(contrib).all() and not np.asarray(pose_t).any()

    H, b, c, n = (np.asarray(v) for v in jout)
    tH, tb, tc, tn = (v.numpy() for v in bench.photometric_hb_call(x, 128, 96, CPU)())
    assert int(tn) == int(n) > size["nb"] * size["n_points"] // 2
    np.testing.assert_allclose(tc, c, rtol=1e-5)
    np.testing.assert_allclose(tH, H, rtol=0, atol=1e-4 * np.abs(H).max())
    np.testing.assert_allclose(tb, b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_gt_depth_frame_matches_jax_bit_for_bit(monkeypatch):
    """The GT section's first frame (splat occlusion + min-z depth) at a
    quarter of the DSLR width with 200,000 points: equal to JAX's."""
    import dataset_pipeline_tpu.tools.ground_truth_creator as jgt

    size = dict(width=768, height=512, n_points=200_000)
    calls = capture(monkeypatch, jgt, "_gt_depth_image")
    with pytest.raises(Stop):
        load_bench_py().bench_gt_depth(**size, frames=1)
    (cam, q, t, pts, keep, occ, w, h), _, want = calls[0]
    np.testing.assert_array_equal(bench.gt_depth_points(size["n_points"]), np.asarray(pts))
    from dataset_pipeline_tpu_torch.models import cameras as cm

    tcam = cm.make_camera("PINHOLE", w, h, np.asarray(cam.params), device="cpu")
    tpts = torch.from_numpy(np.asarray(pts))
    got = bench.gt_depth_frame(tcam, tpts, torch.ones(len(tpts), dtype=torch.bool), 0.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.isfinite(got).sum() > 1000


def test_dslr_inputs_are_bench_py_s(monkeypatch):
    """The DSLR section's problem at a toy size: levels (points, intensities,
    neighbours, descriptors, radii), pyramid, poses and camera as bench.py
    builds them."""
    import dataset_pipeline_tpu.photometric.optimizer as jpo

    size = dict(n_images=2, W=192, H=128, level_sizes=(4000, 1000, 250))
    calls = capture(monkeypatch, jpo, "PhotometricOptimizer", run=False)
    with pytest.raises(Stop):
        load_bench_py().bench_registrator_dslr(**size, iters=1)
    (jp,), kw, _ = calls[0]
    assert kw == dict(optimize_intrinsics=True)
    tp = bench.dslr_optimizer(CPU, **size).p
    assert tp.scale_count == jp.scale_count and tp.occlusion_radius == jp.occlusion_radius
    np.testing.assert_array_equal(np_(tp.occlusion_points), np.asarray(jp.occlusion_points))
    assert len(tp.levels) == len(jp.levels) == 3
    for tl, jl in zip(tp.levels, jp.levels):
        assert tl.radius == jl.radius
        for k in ("points", "intensities", "neighbors", "fixed_descriptors", "scan_indices"):
            np.testing.assert_array_equal(np_(getattr(tl, k)), np.asarray(getattr(jl, k)), err_msg=k)
    tg, jg = tp.groups[0], jp.groups[0]
    np.testing.assert_array_equal(np_(tg.camera.params), np.asarray(jg.camera.params))
    assert len(tg.pyramid) == len(jg.pyramid)
    for a, b in zip(tg.pyramid, jg.pyramid):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    # SE3.exp of the same float32 tangents, each package's float32 expression
    # of the small-angle series (measured 1.4e-8 apart in t)
    np.testing.assert_allclose(np_(tg.poses.q), np.asarray(jg.poses.q), rtol=0, atol=1e-7)
    np.testing.assert_allclose(np_(tg.poses.t), np.asarray(jg.poses.t), rtol=0, atol=1e-7)


def test_joint_ba_scenes_are_bench_py_s(monkeypatch):
    """The joint-BA system section's scenes at a toy size, as bench.py
    builds them."""
    import dataset_pipeline_tpu.parallel.joint_ba as jjb

    size = dict(imgs_per_scene=2, n_pts=1500, n_icp=2000, W=64, H=48)
    calls = capture(monkeypatch, jjb, "pack_scenes", run=False)
    with pytest.raises(Stop):
        load_bench_py().bench_joint_ba_system(n_scenes=2, **size)
    (_, jscenes), kw, _ = calls[0]
    assert kw == dict(optimize_intrinsics=True) and len(jscenes) == 2
    from dataset_pipeline_tpu_torch.models import cameras as cm

    cam = cm.make_camera("PINHOLE", 64, 48, np.asarray(jscenes[0].problem.groups[0].camera.params),
                         device="cpu")
    for i, js in enumerate(jscenes):
        ts = bench.joint_ba_scene(11 + i, cam, CPU, **size)
        assert ts.icp_weight == js.icp_weight == 5.0 and ts.level_idx == js.level_idx
        for a, b in zip(ts.icp, js.icp):
            np.testing.assert_array_equal(a, b)
        tl, jl = ts.problem.levels[0], js.problem.levels[0]
        for k in ("points", "intensities", "neighbors", "fixed_descriptors", "scan_indices"):
            np.testing.assert_array_equal(np_(getattr(tl, k)), np.asarray(getattr(jl, k)), err_msg=k)
        tg, jg = ts.problem.groups[0], js.problem.groups[0]
        np.testing.assert_array_equal(np_(tg.pyramid[0]), np.asarray(jg.pyramid[0]))
        # the 2x2 box mean of float frames: XLA's CPU reduction adds the four
        # values in another order at this shape (one float32 ulp, ~1.2e-7)
        np.testing.assert_allclose(np_(tg.pyramid[1]), np.asarray(jg.pyramid[1]), rtol=2.5e-7, atol=0)
        np.testing.assert_allclose(np_(tg.poses.q), np.asarray(jg.poses.q), rtol=0, atol=1e-7)
        np.testing.assert_allclose(np_(tg.poses.t), np.asarray(jg.poses.t), rtol=0, atol=1e-7)
        assert ts.problem.occlusion_radius == js.problem.occlusion_radius
        np.testing.assert_array_equal(np_(ts.problem.occlusion_points),
                                      np.asarray(js.problem.occlusion_points))
