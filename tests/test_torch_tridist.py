"""Port vs JAX: point-triangle distances on the triangle grid (``ops/tridist.py``)
and the splat creator's functions.

``point_triangle_dist_sq`` against the JAX function inside ``jit`` (the form
``min_dist_sq_within`` runs; the port writes its fused multiply-adds) on
points in every Voronoi region of random triangles: bit for bit.
``build_triangle_grid``'s tables and ``min_dist_sq_within`` against JAX, bit
for bit, at several chunks (the chunk must not change a result), plus the
cases of ``tests/test_tridist.py``: ``unit_orthogonal`` and
``create_splats`` on a plane whose mesh covers only x < 0.4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.ops import tridist as jtd
from dataset_pipeline_tpu.tools import splat_creator as jsc
from dataset_pipeline_tpu_torch.ops import tridist as ttd
from dataset_pipeline_tpu_torch.tools import splat_creator as tsc

torch.set_num_threads(2)


def test_point_triangle_dist_sq_matches_jax_jit():
    rng = np.random.RandomState(13)
    tri = rng.randn(400, 3, 3).astype(np.float32)
    # points around each triangle: near vertices, edges, the face and far off
    bary = rng.uniform(-0.6, 1.6, (400, 3)).astype(np.float32)
    p = (np.einsum("nk,nkd->nd", bary, tri) + 0.3 * rng.randn(400, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jtd.point_triangle_dist_sq)(*(jnp.asarray(x) for x in (
        p, tri[:, 0], tri[:, 1], tri[:, 2]))))
    got = ttd.point_triangle_dist_sq(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        p, tri[:, 0], tri[:, 1], tri[:, 2]))).numpy()
    np.testing.assert_array_equal(got, ref)


def test_point_triangle_distance_regions():
    a, b, c = (torch.tensor(v) for v in ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    cases = [([0.25, 0.25, 1.0], 1.0), ([-1.0, -1.0, 0.0], 2.0), ([2.0, 0.0, 0.0], 1.0),
             ([0.5, -1.0, 0.0], 1.0), ([1.0, 1.0, 0.0], 0.5), ([0.2, 0.3, 0.0], 0.0)]
    for p, expected in cases:
        d2 = float(ttd.point_triangle_dist_sq(torch.tensor(p), a, b, c))
        np.testing.assert_allclose(d2, expected, atol=1e-5, err_msg=str(p))


def _wavy_mesh(n=24, hole=True):
    xs, ys = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    zs = 0.05 * np.sin(6 * xs) * np.cos(5 * ys)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for j in range(n - 1):
        for i in range(n - 1):
            if hole and 0.3 < i / n < 0.6 and 0.3 < j / n < 0.6:
                continue
            v = j * n + i
            faces += [[v, v + 1, v + n], [v + 1, v + n + 1, v + n]]
    return verts, np.asarray(faces, np.int32)


@pytest.mark.parametrize("cell", [0.02, 0.05])
def test_triangle_grid_and_query_match_jax(cell):
    verts, faces = _wavy_mesh()
    jg = jtd.build_triangle_grid(verts, faces, cell)
    tg = ttd.build_triangle_grid(verts, faces, cell, device="cpu")
    assert tg.dims == jg.dims and tg.cell_size == jg.cell_size
    np.testing.assert_array_equal(tg.cell_tris.numpy(), np.asarray(jg.cell_tris))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    rng = np.random.RandomState(5)
    q = np.concatenate([rng.uniform(-0.1, 1.1, (3000, 2)), rng.uniform(-0.1, 0.1, (3000, 1))],
                       1).astype(np.float32)
    ref = np.asarray(jtd.min_dist_sq_within(jg, jnp.asarray(q)))
    for chunk in (8192, 1000, 77):
        got = ttd.min_dist_sq_within(tg, torch.from_numpy(q), chunk=chunk).numpy()
        np.testing.assert_array_equal(got, ref)
    assert np.isinf(ref).any() and np.isfinite(ref).mean() > 0.2


def test_grid_distance_query():
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    grid = ttd.build_triangle_grid(verts, faces, 0.05, device="cpu")
    pts = torch.tensor([[0.5, 0.5, 0.02], [0.5, 0.5, 0.2], [0.2, 0.8, 0.04], [5.0, 5.0, 5.0]])
    d2 = ttd.min_dist_sq_within(grid, pts).numpy()
    np.testing.assert_allclose(d2[0], 0.02 ** 2, atol=1e-6)
    assert np.isinf(d2[1]) and np.isinf(d2[3])
    np.testing.assert_allclose(d2[2], 0.04 ** 2, atol=1e-6)


def test_unit_orthogonal_matches_jax():
    rng = np.random.RandomState(2)
    n = rng.randn(200, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = np.concatenate([n, np.asarray([[0, 0, 1], [0, 0, -1]], np.float32)])
    np.testing.assert_array_equal(tsc.unit_orthogonal(n), jsc.unit_orthogonal(n))


def test_create_splats_matches_jax():
    xs, ys = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21))
    pts = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], -1).astype(np.float32)
    normals = np.tile(np.asarray([[0, 0, 1]], np.float32), (len(pts), 1))
    verts = np.asarray([[0, 0, 0], [0.4, 0, 0], [0.4, 1, 0], [0, 1, 0]], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    jv, jf, jn = jsc.create_splats(pts, normals, verts, faces, 0.02, 0.25)
    tv, tf, tn = tsc.create_splats(pts, normals, verts, faces, 0.02, 0.25, device="cpu")
    assert tn == jn > 0
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    centers = tv.reshape(-1, 4, 3).mean(1)
    interior = ((centers[:, 0] > 0.08) & (centers[:, 0] < 0.32)
                & (centers[:, 1] > 0.08) & (centers[:, 1] < 0.92))
    assert not interior.any()
    assert tn >= (pts[:, 0] > 0.45).sum()
