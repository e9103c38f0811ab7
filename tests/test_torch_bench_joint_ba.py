"""Port vs JAX: the bench tool's two joint-BA sections on the CPU.

- ``joint_ba`` (the packed system, ``bench_joint_ba_system``) at a toy size
  (2 scenes x 2 images of 64x48, 1500 points and 2000 ICP rows each, one
  damped step): the JAX section on a one-device mesh, its ``JointBASystem.cost``
  recorded; ``joint_ba_rows`` equal and the cost trace within ``COST_RTOL``
  (``tests/test_torch_joint_ba.py:45``).
- ``joint_ba_dense``: the port's own joint-BA test scenes
  (``synthetic.joint_ba_test_scene``, rendered with the port's splat ops, ICP
  pairs from its brute-force kNN) through ``build_joint_rows`` and
  ``joint_ba_step`` against the JAX package's ``_build_scene`` path, under the
  bounds of ``tests/test_torch_joint_ba.py``'s ``close`` / ``close_step``
  (rows 1e-3 of their largest entry, r 1e-4 / 1e-3, w 1e-5 / 1e-6, the cost
  ``COST_RTOL``, the solved step 2 % of its largest entry), and the row count
  of the JAX section ``bench_joint_ba``. The scenes' inputs agree to the last
  bit but for scan 1's correction, whose float32 ``SE3.exp`` differs in the
  last bit between the packages (the small-angle ``theta - sin theta``
  cancels); one point of 3200 then finds other neighbours, and the rows of
  that point's components (4) are left out of the per-row bounds, the cost
  and the step still held whole.
"""

import sys

import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

import dataset_pipeline_tpu.parallel.joint_ba as jjb
import dataset_pipeline_tpu.parallel.mesh as jmesh
import test_joint_ba as tjb_jax
from dataset_pipeline_tpu.parallel import ba as jba
from dataset_pipeline_tpu_torch.parallel import ba as tba
from dataset_pipeline_tpu_torch.tools import bench
from test_torch_bench import load_bench_py, np_
from test_torch_joint_ba import COST_RTOL, close, close_step

torch.set_num_threads(2)
CPU = torch.device("cpu")


def one_device_mesh(monkeypatch):
    """JAX's mesh of the port's world size (one rank) in place of all devices."""
    make = jmesh.make_data_mesh
    monkeypatch.setattr(jmesh, "make_data_mesh", lambda *a, **kw: make(1))


def test_joint_ba_system_toy_matches_jax(monkeypatch):
    one_device_mesh(monkeypatch)
    jcosts = []
    cost = jjb.JointBASystem.cost

    def record(self, *a):
        out = cost(self, *a)
        jcosts.append(float(out[0]))
        return out

    monkeypatch.setattr(jjb.JointBASystem, "cost", record)
    size = dict(bench.TOY["joint_ba"])
    want = load_bench_py().bench_joint_ba_system(**size)
    trace = []
    got = bench.bench_joint_ba_system(CPU, **size, cost_trace=trace)
    assert got["joint_ba_rows"] == want["joint_ba_rows"] > 0
    assert got["joint_ba_images"] == want["joint_ba_images"] == 4
    assert len(trace) == len(jcosts) == size["lm_iters"] + 1
    np.testing.assert_allclose(trace, jcosts, rtol=COST_RTOL)


def test_joint_ba_test_scenes_rows_and_step_match_jax(monkeypatch):
    cam = tjb_jax.cm.make_camera("PINHOLE", tjb_jax.W, tjb_jax.H,
                                 [tjb_jax.F, tjb_jax.F, tjb_jax.CX, tjb_jax.CY])
    rng = np.random.RandomState(3)
    jscenes = []
    for seed, phase in [(10, 0.0), (20, 0.7)]:
        problem, icp, _, _ = tjb_jax._build_scene(seed, cam, phase, 0.008 * rng.randn(6).astype(np.float32),
                                                  0.003 * rng.randn(2, 6).astype(np.float32))
        jscenes.append(jba.JointScene(problem, 0, icp, icp_weight=30.0))
    tscenes = bench.joint_ba_dense_scenes(CPU)
    # SE3.exp's (theta - sin theta) cancels in float32, so the two packages'
    # scan-1 corrections differ in the last bit and a tie in the neighbour
    # search can fall the other way: such points' residual rows are other rows
    other = sum(int((np_(t.problem.levels[0].neighbors) != np.asarray(j.problem.levels[0].neighbors))
                    .any(1).sum()) for t, j in zip(tscenes, jscenes))
    n_points = sum(int(j.problem.levels[0].points.shape[0]) for j in jscenes)
    assert other <= 1e-3 * n_points  # measured: 1 of 3200
    K, n_img = jscenes[0].problem.levels[0].neighbors.shape[1], jscenes[0].num_images
    jrows, jr, jw, jk, jm = jba.build_joint_rows(jscenes, obs_scale=0.0)
    trows, tr, tw, tk, tm = tba.build_joint_rows(tscenes, obs_scale=0.0)
    assert (tk, tm) == (jk, jm) and trows.shape == jrows.shape
    off = ~(np.isclose(tr, jr, rtol=1e-4, atol=1e-3) & np.isclose(tw, jw, rtol=1e-5, atol=1e-6)
            & np.isclose(trows, jrows, rtol=1e-3, atol=1e-3 * np.abs(jrows).max()).all(1)
            & ((tw > 0) == (jw > 0)))
    assert off.sum() <= other * K * n_img, int(off.sum())  # measured: 4 rows
    close(tr[~off], jr[~off], 1e-4, 1e-3, "r")
    close(tw[~off], jw[~off], 1e-5, 1e-6, "w")
    close(trows[~off], jrows[~off], 1e-3, 1e-3 * np.abs(jrows).max(), "rows")

    def row_fn(rows, r, w):
        return rows, r, w

    xk_j, xi_j, c_j = jba.joint_ba_step(jmesh.make_data_mesh(1), row_fn,
                                        tuple(jnp.asarray(a) for a in (jrows, jr, jw)),
                                        (P("data"),) * 3, jk, jm, lam=1e-3)
    xk_t, xi_t, c_t = tba.joint_ba_step(CPU, row_fn, tuple(torch.from_numpy(a) for a in (trows, tr, tw)),
                                        tk, tm, lam=1e-3)
    close(c_t, float(c_j), COST_RTOL, 0, "dense cost")
    close_step(xk_t, np.asarray(xk_j), "dense x_keep")
    close_step(xi_t, np.asarray(xi_j), "dense x_img")

    # the sections themselves: the same rows, the port's step cost as above
    one_device_mesh(monkeypatch)
    monkeypatch.setattr(sys, "path", list(sys.path))  # bench.py puts tests/ on the path
    _, n_rows = load_bench_py().bench_joint_ba(reps=1)
    got = bench.bench_joint_ba_dense(CPU, reps=1)
    assert got["joint_ba_dense_rows"] == n_rows == len(jrows)
    close(got["joint_ba_dense_cost"], float(c_j), COST_RTOL, 0, "section cost")
