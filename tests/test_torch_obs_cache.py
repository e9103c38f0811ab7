"""Port vs JAX: the observations cache (``photometric/obs_cache.py``) and the
optimizer's cache half.

On the two-frame scene of ``tests/scenes.py`` (the JAX problem carried into
the port):

- ``build_level_view`` on the toy level of ``tests/test_obs_cache.py``:
  closure under the neighbour relation, remapped neighbours, padding rows,
  the power-of-two bucket, and every array equal to the JAX view's;
- ``build_observations_cache``: the same candidate views per (group, image,
  level), the same ``stats()``; visibility counts on the views per image
  equal to the dense pipeline's (and to JAX's), costs within 1e-5 relative;
  the variable descriptors scattered back from the views within 1e-3 with
  equal masks; the LM system on the views within 1e-4 of its largest entry
  of JAX's, and a full LM step that applies;
- ``obs_cache_hit_rate`` and ``_check_obs_cache_drift`` (the drift guard of
  ``tests/test_obs_cache.py``): 1 on a fresh cache, below 0.98 after a
  sideways pan, equal to JAX's rate (1e-6), and a rebuild that restores it;
- the cache file written by one package and loaded by the other gives the
  same views.
"""

import numpy as np
import pytest
import torch

import dataset_pipeline_tpu.photometric.optimizer as jpo
import jax.numpy as jnp
from dataset_pipeline_tpu.models.lie import SE3 as JSE3
from dataset_pipeline_tpu.photometric import obs_cache as joc
from dataset_pipeline_tpu.photometric.problem import PhotoLevel as JLevel
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.photometric import obs_cache as toc
from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
from dataset_pipeline_tpu_torch.photometric.problem import PhotoLevel as TLevel
from scenes import synthetic_two_frame_problem
from test_torch_photometric import _to_port

torch.set_num_threads(2)
VIEW_FIELDS = ("gather_idx", "scatter_idx", "core", "points", "neighbors", "fixed_descriptors")


def _toy_levels(n=20, k=3, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32)
    nbr = np.stack([(np.arange(n) + d) % n for d in range(1, k + 1)], -1).astype(np.int32)
    desc = rng.randn(n, k).astype(np.float32)
    j = JLevel(jnp.asarray(pts), jnp.asarray(np.zeros(n, np.float32)),
               jnp.asarray(np.zeros(n, np.uint8)), jnp.asarray(nbr), jnp.asarray(desc), 0.1)
    t = TLevel(torch.from_numpy(pts), torch.zeros(n), torch.zeros(n, dtype=torch.uint8),
               torch.from_numpy(nbr).long(), torch.from_numpy(desc), 0.1)
    return j, t


def _same_view(a, b):
    assert a.count == b.count and a.size == b.size
    for f in VIEW_FIELDS:
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))


def test_level_view_matches_jax():
    jl, tl = _toy_levels()
    cand = np.zeros(20, bool)
    cand[[2, 7]] = True
    view = toc.build_level_view(tl, cand)
    _same_view(joc.build_level_view(jl, cand), view)
    gi, core, m = view.gather_idx.numpy(), view.core.numpy(), view.count
    assert set(gi[:m].tolist()) == {2, 7, 3, 4, 5, 8, 9, 10}
    assert set(gi[:m][core[:m]].tolist()) == {2, 7}
    assert not core[m:].any() and (view.scatter_idx.numpy()[m:] == 20).all()
    assert view.size >= m and (view.size & (view.size - 1)) == 0


@pytest.fixture(scope="module")
def pair():
    jp = synthetic_two_frame_problem()
    tp = _to_port(jp)
    jo = jpo.PhotometricOptimizer(jp, optimize_intrinsics=False, variable_weight=1.0)
    to = tpo.PhotometricOptimizer(tp, optimize_intrinsics=False, variable_weight=1.0)
    jo.current_scale = to.current_scale = 0
    return jo, to


def _counts(vis, rows, l, b):
    bi, j = rows(l, b)
    return int(np.asarray(vis[0][l][bi][0][j]).sum())


def test_views_reproduce_dense_pipeline_and_jax(pair):
    jo, to = pair
    to.obs_cache = None
    to._attach_views()
    tocc = to._occlusion_depths()
    dense = to._visibility(tocc)
    params, poses = [g.camera.params for g in to.p.groups], [g.poses for g in to.p.groups]
    c_dense = to._total_cost(params, poses, dense)
    L = len(to.p.levels)
    counts_dense = [_counts(dense, lambda l, b: to._batch_row[0][b], l, b)
                    for b in range(2) for l in range(L)]

    jo.build_observations_cache()
    to.build_observations_cache()
    assert to.obs_cache.stats() == jo.obs_cache.stats()
    real, _ = to.obs_cache.stats()
    assert 0 < real <= sum(len(l.points) for l in to.p.levels) * 2
    for key in jo.obs_cache._views:
        _same_view(jo.obs_cache.view(*key), to.obs_cache.view(*key))
        np.testing.assert_array_equal(to.obs_cache.candidates(*key), jo.obs_cache.candidates(*key))

    jv = jo._visibility(jo._occlusion_depths())
    tv = to._visibility(tocc)
    counts_view = [_counts(tv, lambda l, b: to._batch_row[0][b], l, b)
                   for b in range(2) for l in range(L)]
    counts_jax = [_counts(jv, lambda l, b: jo._batch_row[(0, l)][b], l, b)
                  for b in range(2) for l in range(L)]
    assert counts_view == counts_dense == counts_jax
    c_view = to._total_cost(params, poses, tv)
    assert abs(c_view - c_dense) <= 1e-5 * max(abs(c_dense), 1.0)
    jparams, jposes = [g.camera.params for g in jo.p.groups], [g.poses for g in jo.p.groups]
    np.testing.assert_allclose(c_view, jo._total_cost(jparams, jposes, jv), rtol=1e-5)

    jo._var_desc = jo._compute_variable_descriptors(jv)
    to._var_desc = to._compute_variable_descriptors(tv)
    for (jd, jm), (td, tm) in zip(jo._var_desc, to._var_desc):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-3)
    H, b, c, _ = jo._lm_accumulate(jv)
    tH, tb, tc, _ = to._lm_accumulate(tv)
    np.testing.assert_allclose(tc, c, rtol=1e-5)
    np.testing.assert_allclose(tH, H, rtol=0, atol=1e-4 * np.abs(H).max())
    np.testing.assert_allclose(tb, b, rtol=0, atol=1e-4 * np.abs(b).max())
    to._frozen_vis = tv
    applied, max_change = to._lm_step(tv)
    assert applied and np.isfinite(max_change)


def test_drift_guard_matches_jax():
    jp = synthetic_two_frame_problem()
    # cameras closer, so that each image sees only part of the cloud
    g = jp.groups[0]
    g.poses = JSE3(g.poses.q, g.poses.t + jnp.asarray([0.0, 0.0, 1.2]))
    tp = _to_port(jp)
    jo = jpo.PhotometricOptimizer(jp, optimize_intrinsics=False)
    to = tpo.PhotometricOptimizer(tp, optimize_intrinsics=False)
    jo.build_observations_cache()
    to.build_observations_cache()
    r0 = to.obs_cache_hit_rate()
    assert r0 > 0.999
    shift = np.asarray([0.35, 0.0, 0.0], np.float32)
    jg, tg = jo.p.groups[0], to.p.groups[0]
    jg.poses = JSE3(jg.poses.q, jg.poses.t + jnp.asarray(shift))
    tg.poses = SE3(tg.poses.q, tg.poses.t + torch.from_numpy(shift))
    r1 = to.obs_cache_hit_rate()
    assert r1 < 0.98
    assert r1 == pytest.approx(jo.obs_cache_hit_rate(), abs=1e-6)
    before = to.obs_cache
    to._check_obs_cache_drift()
    assert to.obs_cache is not before and to.obs_cache_hit_log[-1] == pytest.approx(r1, abs=1e-6)
    assert to.obs_cache_hit_rate() > 0.999


def test_cache_file_written_by_one_package_loads_in_the_other(tmp_path):
    jp = synthetic_two_frame_problem()
    tp = _to_port(jp)
    jo = jpo.PhotometricOptimizer(jp, optimize_intrinsics=False)
    to = tpo.PhotometricOptimizer(tp, optimize_intrinsics=False)
    jo.build_observations_cache(save_path=str(tmp_path / "jax.npz"))
    to.build_observations_cache(save_path=str(tmp_path / "port.npz"))
    to2 = tpo.PhotometricOptimizer(_to_port(jp), optimize_intrinsics=False)
    loaded = to2.build_observations_cache(load_path=str(tmp_path / "jax.npz"))
    jl = joc.ObservationsCache.load(str(tmp_path / "port.npz"), jp.levels)
    for key in jo.obs_cache._views:
        _same_view(jo.obs_cache.view(*key), loaded.view(*key))
        _same_view(jl.view(*key), to.obs_cache.view(*key))
    assert to2._obs_cache_save_path == str(tmp_path / "jax.npz")
    assert all(b.views is not None for b in to2._batches[0])
