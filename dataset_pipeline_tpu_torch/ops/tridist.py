"""Point-to-triangle-mesh distance queries on a uniform triangle grid.

Port of ``dataset_pipeline_tpu/ops/tridist.py``: a uniform grid over the
triangles' bounding boxes (built on the host by the native gridder's
``insert_triangles``, as the JAX package does), then the exact
point-triangle distance to every candidate triangle of the 27 cells around a
query, in closed form.

The JAX query runs inside ``jit``, so the distance is written as the fused
multiply-adds XLA's CPU backend makes of it (3-vector dots as an FMA chain,
``a*b - c*d`` as ``fma(a, b, -(c*d))``, ``a + ab*v`` as one FMA): the
minimum distances match the JAX function bit for bit on the CPU, and the
card computes the same ops. Only the (query, triangle) pairs of occupied
cells are evaluated, and the minimum per query is a ``scatter_reduce_``
``amin``: the result does not depend on the chunk of queries, so the card may
take larger chunks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device, native
from dataset_pipeline_tpu_torch.models.lie import dot3_fused, fms


def _nonzero_div(n, d):
    return n / torch.where(d == 0, 1e-30, d)


def point_triangle_dist_sq(p, a, b, c):
    """Exact squared distance point -> triangle, batched (Ericson's method).
    All inputs (...,3); returns (...,)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot3_fused(ab, ap)
    d2 = dot3_fused(ac, ap)
    bp = p - b
    d3 = dot3_fused(ab, bp)
    d4 = dot3_fused(ac, bp)
    cp = p - c
    d5 = dot3_fused(ab, cp)
    d6 = dot3_fused(ac, cp)

    va = fms(d3, d6, d5, d4)
    vb = fms(d5, d2, d1, d6)
    vc = fms(d1, d4, d3, d2)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    v_ab = torch.clamp(_nonzero_div(d1, d1 - d3), 0.0, 1.0)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    w_ac = torch.clamp(_nonzero_div(d2, d2 - d6), 0.0, 1.0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    w_bc = torch.clamp(_nonzero_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    denom = va + vb + vc
    denom = torch.where(denom == 0, 1e-30, denom)
    v = vb / denom
    w = vc / denom
    closest = torch.addcmul(torch.addcmul(a, ab, v[..., None]), ac, w[..., None])
    closest = torch.where(on_bc[..., None], torch.addcmul(b, c - b, w_bc[..., None]), closest)
    closest = torch.where(on_ac[..., None], torch.addcmul(a, ac, w_ac[..., None]), closest)
    closest = torch.where(on_ab[..., None], torch.addcmul(a, ab, v_ab[..., None]), closest)
    closest = torch.where(in_c[..., None], c, closest)
    closest = torch.where(in_b[..., None], b, closest)
    closest = torch.where(in_a[..., None], a, closest)
    d = p - closest
    return dot3_fused(d, d)


class TriangleGrid(NamedTuple):
    vertices: torch.Tensor  # (V,3)
    faces: torch.Tensor  # (F,3) int64
    cell_tris: torch.Tensor  # (num_cells, M) int32 triangle ids, -1 padded
    origin: torch.Tensor  # (3,)
    cell_size: float
    dims: tuple


def build_triangle_grid(vertices: np.ndarray, faces: np.ndarray, cell_size: float,
                        max_tris_per_cell: int = 64, device=None) -> TriangleGrid:
    """Host-side insertion of triangles (by bounding box) into a uniform grid;
    the tensors go to ``device`` (the card when none is named)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    tv = vertices[faces]  # (F,3,3)
    lo = tv.min(1)
    hi = tv.max(1)
    origin = vertices.min(0) - 0.5 * cell_size
    dims = np.maximum(
        np.ceil((vertices.max(0) + 0.5 * cell_size - origin) / cell_size), 1
    ).astype(np.int64)
    lo_c = np.clip(np.floor((lo - origin) / cell_size).astype(np.int64), 0, dims - 1)
    hi_c = np.clip(np.floor((hi - origin) / cell_size).astype(np.int64), 0, dims - 1)
    table = native.insert_triangles(lo_c, hi_c, dims, max_tris_per_cell)
    num_cells = int(dims[0] * dims[1] * dims[2])
    max_needed = int((table >= 0).sum(1).max()) if num_cells else 0
    M = max(min(max_needed, max_tris_per_cell), 1)
    dev = default_device(device)
    return TriangleGrid(
        torch.from_numpy(vertices.copy()).to(dev), torch.from_numpy(faces.copy()).to(dev),
        torch.from_numpy(np.ascontiguousarray(table[:, :M])).to(dev),
        torch.from_numpy(origin.astype(np.float32)).to(dev),
        float(cell_size), tuple(int(d) for d in dims),
    )


def min_dist_sq_within(grid: TriangleGrid, points, chunk: int = 8192):
    """Min squared distance to any triangle within ~cell_size of each point;
    points farther than the grid's cell size from all triangles get +inf."""
    nx, ny, nz = grid.dims
    dev = points.device
    r = torch.arange(-1, 2, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
    dims = torch.tensor([nx, ny, nz], device=dev)
    out = torch.full((points.shape[0],), float("inf"), dtype=torch.float32, device=dev)
    for s in range(0, points.shape[0], chunk):
        q = points[s:s + chunk]
        base = torch.floor((q - grid.origin) / grid.cell_size).long()
        cells = base[:, None, :] + offs[None]
        inside = torch.all((cells >= 0) & (cells < dims), -1)
        ids = (cells[..., 0] * ny + cells[..., 1]) * nz + cells[..., 2]
        cand = grid.cell_tris[torch.where(inside, ids, 0)]  # (C,27,M)
        cand = torch.where(inside[..., None], cand, -1).reshape(q.shape[0], -1)
        qi, ci = torch.nonzero(cand >= 0, as_tuple=True)
        tri = grid.faces[cand[qi, ci].long()]
        v = grid.vertices
        d2 = point_triangle_dist_sq(q[qi], v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]])
        out[s:s + chunk].scatter_reduce_(0, qi, d2, reduce="amin", include_self=True)
    return out
