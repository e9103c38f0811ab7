"""Port vs JAX: the exact adaptive kNN and the outlier filter
(``ops/knn.py:knn_adaptive`` / ``radius_search``, ``ops/outlier.py``).

Seeded clouds: a thin slab (a scan-like surface) with 1 % planted points
hovering 4-12 point spacings above it, where the local statistics remove
them. ``knn_adaptive`` must return the exact k nearest neighbours (checked in
float64) and the JAX indices, distances within rtol 1e-6, wherever the JAX
function's result is exact: the port sizes its grid from exact k-th
neighbour distances of a sample (ROADMAP C), the JAX function from a
brute-force estimate whose norm expansion can collapse, and the JAX
brute-force repair orders near-equal distances by that expansion. The filters' masks must be equal; a point whose
mask differs is allowed only where its mean distance lies within one float32
ulp of its threshold (the per-row sums run in another order). Sizes: the
brute-force path at 6,000 points, the adaptive path at 21,000-30,000, and
``remove_outliers``'s native host path at 250,000 (above its 200,000 switch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.ops import knn as jk
from dataset_pipeline_tpu.ops import outlier as jo
from dataset_pipeline_tpu_torch.ops import knn as tk
from dataset_pipeline_tpu_torch.ops import outlier as to

torch.set_num_threads(2)


def _cloud(n, seed, planted=0.01):
    """n points on a 4 x 3 m slab 2 mm thick, then 1 % planted 4-12 point
    spacings above it."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * np.asarray([4.0, 3.0, 0.002])).astype(np.float32)
    s = np.sqrt(12.0 / n)
    far = rng.rand(int(planted * n), 3) * np.asarray([4.0, 3.0, 8 * s]) + np.asarray([0, 0, 4 * s])
    return np.concatenate([pts, far.astype(np.float32)])


def _assert_masks_equal(jmask, tmask, pts, k, factor, filtered=None):
    """Equal masks, except where the mean distance is within one ulp of its
    threshold (recomputed here in float64 from the port's kNN)."""
    jmask, tmask = np.asarray(jmask), np.asarray(tmask)
    diff = np.flatnonzero(jmask != tmask)
    if diff.size:
        d2, idx = tk.knn_bruteforce(torch.from_numpy(pts), torch.from_numpy(pts), k + 1)
        mean_dist, local_mean = (x.numpy() for x in to._filter_from_knn(d2, idx))
        thr = local_mean[diff] * np.float32(factor)
        assert np.all(np.abs(mean_dist[diff] - thr) <= np.spacing(np.abs(thr))), diff
    assert diff.size <= max(2, len(pts) // 10_000)


@pytest.mark.parametrize("k", [9, 30])
def test_knn_adaptive_matches_jax(k):
    pts = _cloud(30_000, seed=1)
    jd, ji = jk.knn_adaptive(pts, pts[:3000], k)
    stats = {}
    td, ti = tk.knn_adaptive(torch.from_numpy(pts), torch.from_numpy(pts[:3000]), k, stats=stats)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    # exact: the chosen neighbours are the nearest, in float64 (500 queries)
    q = pts[:500].astype(np.float64)
    d64 = ((q[:, None, :] - pts[None].astype(np.float64)) ** 2).sum(-1)
    chosen = np.sort(np.take_along_axis(d64, ti[:500].numpy(), 1), 1)
    np.testing.assert_allclose(chosen, np.sort(d64, 1)[:, :k], rtol=1e-5, atol=1e-12)
    assert stats["grid_cells"] < 2 ** 31 and stats["cap"] >= 8


def test_knn_adaptive_repairs_match_jax():
    """A dense clump beside a sparse fringe: the first grid pass cannot
    certify every query, so the ring/cap repair and the brute force run."""
    rng = np.random.RandomState(3)
    pts = np.concatenate([(rng.randn(20_000, 3) * 0.01).astype(np.float32),
                          (rng.rand(4_000, 3) * 3.0).astype(np.float32)])
    jd, ji = jk.knn_adaptive(pts, pts[::8], 12)
    stats = {}
    td, ti = tk.knn_adaptive(torch.from_numpy(pts), torch.from_numpy(pts[::8]), 12, stats=stats)
    assert stats["grid_repairs"] or stats["bruteforce_repairs"]
    ti, ji = ti.numpy(), np.asarray(ji)
    q = pts[::8].astype(np.float64)
    d64 = ((q[:, None, :] - pts[None].astype(np.float64)) ** 2).sum(-1)
    ref = np.sort(d64, 1)[:, :12]
    # float32 distances order float64 near-ties by their rounding: rtol 1e-5
    np.testing.assert_allclose(np.take_along_axis(d64, ti, 1), ref, rtol=1e-5, atol=1e-14)
    # a row may differ from JAX's only at distances equal within float32
    # rounding, or where JAX's brute-force repair ordered by its expansion
    rows = np.flatnonzero((ti != ji).any(1))
    assert len(rows) <= len(q) // 100


def test_knn_adaptive_far_from_the_origin():
    """A surface 5 m from the origin with ~1 mm spacing: the JAX function's
    brute-force spacing estimate, |q|^2 + |p|^2 - 2 q.p in float32,
    collapses to 0 (one ulp of 25 m^2 is 2e-6 m^2), which sizes its grid to
    more than 2^31 cells (the int32 cell-id overflow); the port's sizing
    stays a few thousand cells and its result is exact."""
    rng = np.random.RandomState(11)
    n = 25_000
    xy = rng.rand(n, 2) * 0.35
    pts = np.stack([xy[:, 0], xy[:, 1], 5.0 + 0.01 * np.sin(9 * xy[:, 0])], -1).astype(np.float32)
    sample = pts[np.random.RandomState(0).choice(n, size=4096, replace=False)]
    d2s, _ = jk.knn_bruteforce(jnp.asarray(sample), jnp.asarray(pts), 2)
    typical = max(float(np.median(np.sqrt(np.asarray(d2s)[:, 1]))), 1e-9)
    jax_dims = np.ceil((pts.max(0) - pts.min(0) + typical * 48 ** (1 / 3)) / (typical * 48 ** (1 / 3)))
    assert np.prod(jax_dims) > 2 ** 31
    stats = {}
    td, ti = tk.knn_adaptive(torch.from_numpy(pts), torch.from_numpy(pts[:500]), 20, stats=stats)
    assert stats["grid_cells"] < 2 ** 31
    q = pts[:500].astype(np.float64)
    d64 = ((q[:, None, :] - pts[None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(np.take_along_axis(d64, ti.numpy(), 1), np.sort(d64, 1)[:, :20],
                               rtol=1e-5, atol=1e-14)


def test_radius_search_matches_jax():
    pts = _cloud(5000, seed=4)
    jg, tg = jk.build_grid(pts, 0.1), tk.build_grid(pts, 0.1)
    jd, ji = jk.radius_search(jg, jnp.asarray(pts[:700]), 0.08, 16)
    td, ti = tk.radius_search(tg, torch.from_numpy(pts[:700]), 0.08, 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert (ti.numpy() < 0).any() and (ti.numpy() >= 0).any()


@pytest.mark.parametrize("k,factor", [(20, 1.15), (8, 1.5)])
def test_bruteforce_filter_matches_jax(k, factor):
    pts = _cloud(6000, seed=5)
    jm = jo.local_statistical_outliers_bruteforce(jnp.asarray(pts), k, factor)
    tm = to.local_statistical_outliers_bruteforce(torch.from_numpy(pts), k, factor)
    _assert_masks_equal(jm, tm.numpy(), pts, k, factor)


def test_grid_filter_matches_jax():
    pts = _cloud(6000, seed=6)
    jg, tg = jk.build_grid(pts, 0.08), tk.build_grid(pts, 0.08)
    jm = jo.local_statistical_outliers_grid(jg, jnp.asarray(pts), 12, 1.2)
    tm = to.local_statistical_outliers_grid(tg, torch.from_numpy(pts), 12, 1.2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_adaptive_filter_matches_jax():
    n = 21_000
    pts = _cloud(n, seed=7)
    jm = np.asarray(jo._outliers_from_adaptive_knn(pts, 20, 1.15))
    tm = to._outliers_from_adaptive_knn(torch.from_numpy(pts), 20, 1.15).numpy()
    _assert_masks_equal(jm, tm, pts, 20, 1.15)
    assert tm[:n].mean() > 0.9 and tm[n:].mean() < 0.5


def test_remove_outliers_matches_jax_both_paths():
    """Two filters in sequence; at 6,000 points through the brute force, at
    250,000 through the native host kNN (both packages)."""
    filters = [(30, 1.15), (20, 1.15)]
    small = _cloud(6000, seed=8)
    _assert_masks_equal(jo.remove_outliers(small, filters[:1]),
                        to.remove_outliers(small, filters[:1]), small, 30, 1.15)
    np.testing.assert_array_equal(to.remove_outliers(small, filters),
                                  jo.remove_outliers(small, filters))
    big = _cloud(250_000, seed=9)
    timings = {}
    tm = to.remove_outliers(big, filters, timings=timings)
    jm = jo.remove_outliers(big, filters)
    assert "knn_host" in timings and "knn_device" not in timings
    assert (tm != jm).sum() <= 25  # threshold ulps only (checked on the small cloud)
    assert tm[:250_000].mean() > 0.9 and tm[250_000:].mean() < 0.5
