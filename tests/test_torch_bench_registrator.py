"""Port vs JAX: the bench tool's two registrator sections on the CPU.

- ``registrator_e2e``: the JAX section's warm run (2 LM iterations a scale)
  is kept by a recording subclass of its optimizer, which stops the section at
  its second run; the port's scene (``bench.registrator_e2e_problem``) equals
  its inputs (levels, pyramid bit for bit, poses within 1e-7) and the port's
  run at 2 iterations a scale equals its costs and result at the bounds of
  ``tests/test_torch_photometric.py:151-157`` (costs 1e-4 relative, poses 1e-5,
  intrinsics 1e-3 px). The costs are compared on the same visibility: an
  observation whose footprint scale lies at the scale gate's edge can fall on
  either side in the two packages (their scales agree within 5e-4), and one
  such flip moves a 2,000-observation mean cost by more than 1e-4.
- ``registrator_dslr`` at a toy size (2 images of 192x128, levels 4000 / 1000
  / 250, one timed iteration): ``registrator_dslr_points`` equal, the
  observations an iteration within 1e-3 (the visibility's footprint test
  compares projections of float32 geometry; measured equal here).
"""

import numpy as np
import pytest
import torch

import dataset_pipeline_tpu.photometric.optimizer as jpo
from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
from dataset_pipeline_tpu_torch.tools import bench
from test_torch_bench import Stop, load_bench_py, np_

torch.set_num_threads(2)
CPU = torch.device("cpu")


SCALE_TOL = 5e-4  # obs_scale, port vs JAX (tests/test_torch_photometric.py's bound)


def _instrument(opt, vis_log: list, costs: list, cost_on=None):
    """Record each refresh's visibility (numpy) and each LM accumulation's
    entry cost; with ``cost_on(k)``, also the cost of the k-th accumulation's
    state on another visibility."""
    visibility, accumulate = opt._visibility, opt._lm_accumulate

    def vis_rec(occl):
        out = visibility(occl)
        vis_log.append([(np_(per_level[0][0]), np_(per_level[0][1])) for per_level in out[0]])
        return out

    def acc_rec(vis):
        out = accumulate(vis)
        other = None if cost_on is None else accumulate(cost_on(len(costs)))[2]
        costs.append((out[2], other))
        return out

    opt._visibility, opt._lm_accumulate = vis_rec, acc_rec


def test_registrator_e2e_matches_jax_at_two_iterations(monkeypatch):
    """Inputs equal; each LM accumulation's cost within 1e-4 of JAX's on
    JAX's visibility; the masks equal but for observations whose scale lies
    within 5e-4 (the bound of the two packages' footprint scales) of the
    gate's ends, [current scale, scale count - 1); where the masks agree, the
    port's own cost within 1e-4; poses 1e-5, intrinsics 1e-3 px after the run.
    Measured: the second refresh flips one observation a level at the gate
    (JAX scale 5.6e-5 / 1.00005), which moves that iteration's mean cost by
    4.3e-4 relative; on JAX's masks the port's cost is within 6.5e-7."""
    made = []

    class Recording(jpo.PhotometricOptimizer):
        def __init__(self, problem, *a, **kw):
            if made:
                raise Stop  # the section's timed run: the warm run is what we keep
            g = problem.groups[0]
            self.initial = (np.asarray(g.poses.q), np.asarray(g.poses.t))
            super().__init__(problem, *a, **kw)
            self.vis_log, self.costs = [], []
            _instrument(self, self.vis_log, self.costs)
            made.append(self)

    monkeypatch.setattr(jpo, "PhotometricOptimizer", Recording)
    with pytest.raises(Stop):
        load_bench_py().bench_registrator_e2e()
    jo = made[0]

    tp = bench.registrator_e2e_problem(CPU)()
    assert len(tp.levels) == len(jo.p.levels) and tp.scale_count == jo.p.scale_count == 2
    for tl, jl in zip(tp.levels, jo.p.levels):
        assert tl.radius == jl.radius
        for k in ("points", "intensities", "neighbors", "fixed_descriptors"):
            np.testing.assert_array_equal(np_(getattr(tl, k)), np.asarray(getattr(jl, k)), err_msg=k)
    tg, jg = tp.groups[0], jo.p.groups[0]
    for a, b in zip(tg.pyramid, jg.pyramid):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    np.testing.assert_allclose(np_(tg.poses.q), jo.initial[0], rtol=0, atol=1e-7)
    np.testing.assert_allclose(np_(tg.poses.t), jo.initial[1], rtol=0, atol=1e-7)

    def jax_vis(k):
        return [[[(torch.from_numpy(m), torch.from_numpy(s))] for (m, s) in jo.vis_log[k]]]

    to = tpo.PhotometricOptimizer(tp)
    vis_log, costs = [], []
    _instrument(to, vis_log, costs, jax_vis)
    to.run(max_iterations_per_scale=2)
    assert len(costs) == len(jo.costs) == 2 and len(vis_log) == len(jo.vis_log)
    gate = (0.0, tp.scale_count - 1.0)
    for k, (own, on_jax) in enumerate(costs):
        np.testing.assert_allclose(on_jax, jo.costs[k][0], rtol=1e-4)
        agree = True
        for (tm, ts), (jm, js) in zip(vis_log[k], jo.vis_log[k]):
            flips = tm != jm
            agree &= not flips.any()
            edge = np.min([np.abs(js - g) for g in gate], axis=0)
            assert np.all(edge[flips] <= SCALE_TOL), (k, edge[flips])
            both = tm & jm
            np.testing.assert_allclose(ts[both], js[both], rtol=0, atol=SCALE_TOL)
        if agree:
            np.testing.assert_allclose(own, jo.costs[k][0], rtol=1e-4)
    tg, jg = tp.groups[0], jo.p.groups[0]
    np.testing.assert_allclose(np_(tg.poses.q), np.asarray(jg.poses.q), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_(tg.poses.t), np.asarray(jg.poses.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_(tg.camera.params), np.asarray(jg.camera.params), rtol=0, atol=1e-3)
    assert np.abs(np_(tg.poses.t) - jo.initial[1]).max() > 1e-4  # the run moved the poses


def test_registrator_dslr_toy_matches_jax():
    size = dict(n_images=2, W=192, H=128, iters=1, level_sizes=(4000, 1000, 250))
    want = load_bench_py().bench_registrator_dslr(**size)
    got = bench.bench_registrator_dslr(CPU, **size)
    assert got["registrator_dslr_points"] == want["registrator_dslr_points"] == 5250
    assert got["registrator_dslr_images"] == want["registrator_dslr_images"] == 2
    obs, jobs = got["registrator_dslr_obs_per_iter"], want["registrator_dslr_obs_per_iter"]
    assert jobs > 0 and abs(obs - jobs) <= 1e-3 * jobs
    assert got["registrator_dslr_cost_optimum"] <= got["registrator_dslr_cost_first"]
