"""Neighbor search: tiled brute force and voxel-grid search, in torch.

Port of ``dataset_pipeline_tpu/ops/knn.py``. Results match the JAX functions
index for index, so the orderings that decide ties are kept on purpose:

- ``build_grid`` sorts cell ids with a STABLE sort, as ``jnp.argsort`` does:
  points inside a cell keep their original order, and the ``max_per_cell``
  cap keeps the same points.
- ``jax.lax.top_k`` puts the lower index first on equal keys. ``k == 1`` uses
  ``argmin`` (first occurrence), ``k > 1`` a stable ascending sort.
- Squared norms of 3-vectors are one fused multiply-add chain,
  ``fma(z, z, fma(y, y, x * x))``, which is how XLA's CPU backend evaluates
  ``sum(d * d, -1)``; ``addcmul`` gives the same bits.

Empty result slots are ``(inf, -1)``. The query loops run ``chunk`` queries at
a time; the chunk only bounds memory and never changes a result. Every
function runs on the device of the tensors it is given: a CUDA tensor stays on
the card, and only a few scalars (the sizing of ``knn_adaptive``'s grid) come
to the host.

The grid's cell ids are int32, as in the JAX package: a grid of 2^31 cells or
more wraps around (``knn_adaptive`` sizes its cells from the data, so a sparse
cloud over a large box can get there); callers that can meet such clouds
check ``grid_cells`` first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _sqnorm3(d):
    """Squared norm over the last axis (size 3) as one FMA chain."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.addcmul(torch.addcmul(x * x, y, y), z, z)


def _smallest_k(d2, k: int):
    """(values, positions) of the ``k`` smallest entries per row, ascending,
    lower position first on ties (the order of ``jax.lax.top_k(-d2, k)``)."""
    if k == 1:
        sel = torch.argmin(d2, dim=1, keepdim=True)
        return torch.gather(d2, 1, sel), sel
    _, sel = torch.topk(d2, k, dim=1, largest=False, sorted=False)
    # order the selected set by (value, position), as a stable sort would
    sel, _ = torch.sort(sel, dim=1)
    vals, order = torch.sort(torch.gather(d2, 1, sel), dim=1, stable=True)
    sel = torch.gather(sel, 1, order)
    # where the k-th value ties with an entry left out, topk may have kept a
    # higher position: redo those (rare) rows with a full stable sort
    tied = torch.nonzero(torch.sum(d2 <= vals[:, -1:], 1) > k)[:, 0]
    if tied.numel():
        v, s = torch.sort(d2[tied], dim=1, stable=True)
        vals[tied], sel[tied] = v[:, :k], s[:, :k]
    return vals, sel


# ---------------------------------------------------------------------------
# Brute force (tiled)
# ---------------------------------------------------------------------------


def knn_bruteforce(queries, points, k: int, chunk: int = 4096):
    """Exact k nearest neighbors of each query among ``points``.

    Returns (distances_sq (Q,k), indices (Q,k)), sorted ascending.
    """
    k = min(k, points.shape[0])
    p_norm = _sqnorm3(points)  # (N,)
    d2_out, idx_out = [], []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        cross = q @ points.T  # strict fp32: the package disables TF32
        d2 = torch.clamp((_sqnorm3(q)[:, None] + p_norm[None, :]) - 2.0 * cross, min=0.0)
        v, i = _smallest_k(d2, k)
        d2_out.append(v)
        idx_out.append(i)
    return torch.cat(d2_out), torch.cat(idx_out)


# ---------------------------------------------------------------------------
# Voxel grid
# ---------------------------------------------------------------------------


class VoxelGrid(NamedTuple):
    """Points sorted by voxel cell id over a bounded uniform grid."""

    points: torch.Tensor  # (N,3) sorted by cell id
    order: torch.Tensor  # (N,) original index of each sorted point
    cell_ids: torch.Tensor  # (N,) sorted cell id per point
    origin: torch.Tensor  # (3,)
    cell_size: torch.Tensor  # scalar
    dims: tuple  # (nx, ny, nz)


def build_grid(points, cell_size: float, origin=None, dims=None) -> VoxelGrid:
    """Bin points into a uniform grid and sort by cell id (stable).

    ``origin``/``dims`` default to the data's bounding box (computed on the
    host) padded by half a cell.
    """
    points = torch.as_tensor(points, dtype=torch.float32)
    if origin is None or dims is None:
        pts_np = points.cpu().numpy()
        lo = pts_np.min(0) - 0.5 * cell_size
        hi = pts_np.max(0) + 0.5 * cell_size
        origin = lo
        dims = tuple(int(v) for v in np.maximum(np.ceil((hi - lo) / cell_size), 1))
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=points.device)
    cs = torch.tensor(cell_size, dtype=torch.float32, device=points.device)
    nx, ny, nz = dims
    hi_ijk = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32, device=points.device)
    ijk = torch.floor((points - origin) / cs).to(torch.int32)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi_ijk)
    ids = ijk[:, 0] + nx * (ijk[:, 1] + ny * ijk[:, 2])
    order = torch.argsort(ids, stable=True)
    return VoxelGrid(points[order], order, ids[order], origin, cs, tuple(dims))


def _neighbor_cell_ids(grid: VoxelGrid, queries, rings: int = 1):
    """(Q,(2r+1)^3) cell ids around each query; -1 for out-of-grid cells."""
    nx, ny, nz = grid.dims
    dev = queries.device
    base = torch.floor((queries - grid.origin) / grid.cell_size).to(torch.int32)  # (Q,3)
    r = torch.arange(-rings, rings + 1, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    cells = base[:, None, :] + offs[None]  # (Q,ncells,3)
    dims_t = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    inside = torch.all((cells >= 0) & (cells < dims_t), dim=-1)
    ids = cells[..., 0] + nx * (cells[..., 1] + ny * cells[..., 2])
    return torch.where(inside, ids, -1)


def _gather_candidates(grid: VoxelGrid, queries, max_per_cell: int, rings: int = 1):
    """For each query: candidate point indices (into sorted order) from the
    (2*rings+1)^3 surrounding cells, padded with -1, plus the number of
    candidates DROPPED per query by the ``max_per_cell`` cap."""
    ids = _neighbor_cell_ids(grid, queries, rings)  # (Q,ncells)
    start = torch.searchsorted(grid.cell_ids, ids, right=False)
    end = torch.searchsorted(grid.cell_ids, ids, right=True)
    count = torch.where(ids >= 0, end - start, 0)
    dropped = torch.sum(torch.clamp(count - max_per_cell, min=0), -1)  # (Q,)
    slots = torch.arange(max_per_cell, device=queries.device)
    cand = start[..., None] + slots  # (Q,ncells,M)
    valid = slots < torch.clamp(count, max=max_per_cell)[..., None]
    cand = torch.where(valid, cand, -1)
    return cand.reshape(queries.shape[0], -1), dropped


def knn_grid(grid: VoxelGrid, queries, k: int, max_per_cell: int = 32,
             chunk: int = 16384, rings: int = 1):
    """k nearest neighbors within the (2*rings+1)^3-cell neighborhood.

    Returns (d2 (Q,k), idx (Q,k), dropped (Q,)) with ORIGINAL point indices;
    empty slots are (inf, -1). ``dropped[q] > 0`` means the ``max_per_cell``
    cap truncated some cells for this query and the result may be inexact.
    """
    queries = torch.as_tensor(queries, dtype=torch.float32)
    k = min(k, (2 * rings + 1) ** 3 * max_per_cell)
    d2_out, idx_out, drop_out = [], [], []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        cand, dropped = _gather_candidates(grid, q, max_per_cell, rings)
        valid = cand >= 0
        safe = torch.clamp(cand, min=0)
        d2 = _sqnorm3(grid.points[safe] - q[:, None, :])
        d2 = torch.where(valid, d2, torch.inf)
        v, sel = _smallest_k(d2, k)
        sel_cand = torch.gather(safe, 1, sel)
        sel_valid = torch.gather(valid, 1, sel)
        d2_out.append(v)
        idx_out.append(torch.where(sel_valid, grid.order[sel_cand], -1))
        drop_out.append(dropped)
    return torch.cat(d2_out), torch.cat(idx_out), torch.cat(drop_out)


def grid_cells(points, cell_size: float) -> int:
    """Cells of the grid :func:`build_grid` lays over ``points`` (its cell
    ids are int32: at 2^31 cells or more they wrap around)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    lo = pts.amin(0).cpu().numpy() - 0.5 * cell_size
    hi = pts.amax(0).cpu().numpy() + 0.5 * cell_size
    return int(np.prod(np.maximum(np.ceil((hi - lo) / cell_size), 1)))


_SAMPLE = 4096  # points whose exact k-th neighbour distance sizes the grid
_SLOTS = 1 << 25  # candidate slots per pass of the grid kNN (bounds its temporaries)


def _sample_kth_distances(points, k: int):
    """Exact k-th neighbour distances (the point itself counted, as a query
    that is one of the points sees it) of a seeded sample of ``points``, by
    coordinate differences on the points' device."""
    n = points.shape[0]
    rng = np.random.RandomState(0)
    sample = points[torch.from_numpy(rng.choice(n, size=min(n, _SAMPLE), replace=False))
                    .to(points.device)]
    rows = max(1, _SLOTS // n)
    kth = []
    for s in range(0, sample.shape[0], rows):
        d2 = _sqnorm3(points[None] - sample[s:s + rows, None])
        kth.append(torch.topk(d2, k, dim=1, largest=False, sorted=False)[0].amax(1))
    return torch.sqrt(torch.cat(kth)).cpu().numpy().astype(np.float64)


def adaptive_grid(points, k: int):
    """(cell size, max_per_cell) of :func:`knn_adaptive`'s first grid pass
    (one ring): the cell is 1.05x the 99th percentile of a 4096-point sample's
    exact k-th neighbour distance, so that one ring reaches the k-th
    neighbour of all but the sparsest queries, whatever the cloud's
    dimension (a scan is a surface); the cap is 1.5x the 99th percentile of
    the occupied cells' counts."""
    cell = max(1.05 * float(np.quantile(_sample_kth_distances(points, k), 0.99)), 1e-9)
    grid = build_grid(points, cell)
    counts = torch.unique_consecutive(grid.cell_ids, return_counts=True)[1].double()
    cap = max(8, int(np.ceil(1.25 * float(torch.quantile(counts, 0.99)))))
    return grid, cell, cap


def knn_adaptive(points, queries, k: int, stats: dict | None = None):
    """Exact kNN at production scale: a sized voxel-grid pass, a repair of
    the queries it could not certify with two more rings and twice the cap
    (twice), then a brute-force repair of what is left.

    A query's grid result is certified iff none of its cells hit the
    ``max_per_cell`` cap and its k-th neighbour lies within the rings' reach
    ``rings * cell``. The grid is sized from exact k-th neighbour distances
    of a sample (:func:`adaptive_grid`). ``stats``, if given, receives the
    sizing (``cell``, ``cap``, ``grid_cells``) and the number of queries each
    repair took. Returns (d2 (Q,k), idx (Q,k)) sorted ascending, on the
    points' device.
    """
    pts = torch.as_tensor(points, dtype=torch.float32)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(pts.device)
    n, Q = pts.shape[0], queries.shape[0]
    k = min(k, n)
    if n <= max(4 * k, 20_000):
        return knn_bruteforce(queries, pts, k)
    grid, cell, cap = adaptive_grid(pts, k)
    rings = 1

    def grid_pass(q, rings_, cap_):
        return knn_grid(grid, q, k, cap_, max(1, _SLOTS // ((2 * rings_ + 1) ** 3 * cap_)), rings_)

    def uncertified(d2_, idx_, dropped_, reach):
        kth = torch.sqrt(torch.clamp(d2_[:, -1], min=0.0))
        return (dropped_ > 0) | (idx_[:, -1] < 0) | ~(kth <= reach)

    d2, idx, dropped = grid_pass(queries, rings, cap)
    bad = uncertified(d2, idx, dropped, rings * cell)
    repairs = []
    for _ in range(2):
        sel = torch.nonzero(bad)[:, 0]
        if sel.numel() == 0:
            break
        rings += 2
        cap *= 2
        repairs.append(int(sel.numel()))
        d2r, idxr, dropr = grid_pass(queries[sel], rings, cap)
        d2[sel], idx[sel] = d2r, idxr
        bad = torch.zeros_like(bad)
        bad[sel[uncertified(d2r, idxr, dropr, rings * cell)]] = True
    sel = torch.nonzero(bad)[:, 0]
    if sel.numel():
        if sel.numel() > Q // 10:
            print(f"knn_adaptive: brute-force repair of {sel.numel()}/{Q} queries "
                  f"(cell={cell:.4g})")
        d2[sel], idx[sel] = knn_bruteforce(queries[sel], pts, k)
    if stats is not None:
        stats.update(cell=cell, cap=cap,
                     grid_cells=int(np.prod(grid.dims)), grid_repairs=repairs,
                     bruteforce_repairs=int(sel.numel()))
    return d2, idx


def radius_search(grid: VoxelGrid, queries, radius, max_results: int, max_per_cell: int = 32,
                  chunk: int = 16384):
    """All neighbors within ``radius`` (up to ``max_results`` nearest).

    Requires ``radius <= cell_size``. Returns (d2, idx) padded with (inf,-1).
    """
    d2, idx, _ = knn_grid(grid, queries, max_results, max_per_cell, chunk)
    keep = d2 <= torch.tensor(radius, dtype=torch.float32) ** 2
    return torch.where(keep, d2, torch.inf), torch.where(keep, idx, -1)


def nearest_neighbor(grid: VoxelGrid, queries, max_per_cell: int = 32, chunk: int = 16384):
    """Single nearest neighbor within the cell neighborhood: (d2 (Q,), idx (Q,))."""
    d2, idx, _ = knn_grid(grid, queries, 1, max_per_cell, chunk)
    return d2[:, 0], idx[:, 0]
