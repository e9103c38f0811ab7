"""Sharded Gauss-Newton normal-equation accumulation over a process mesh.

Counterpart of ``dataset_pipeline_tpu/parallel/normal_equations.py``: each
rank accumulates H, b over ITS shard of the residual rows (ICP
correspondences), the small per-rank blocks are summed over the mesh with
``all_reduce`` (JAX: ``psum``), and every rank holds the replicated reduced
system. The rows of a rank are what ``mesh.shard_rows`` gives it: a
contiguous slice, the padding rows with ``w = 0``.

The per-rank sums are the one-device kernels: B4a (``ops/gn.py:gn_rows``)
for the ICP H, b, cost and B2 (``ops/gn.py:moment_gram_partials``) for the
moment Gram, on the card; their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from dataset_pipeline_tpu_torch.icp.moments import pack_group_data
from dataset_pipeline_tpu_torch.ops.gn import icp_hb_cost_rows, moment_gram_partials
from dataset_pipeline_tpu_torch.parallel.mesh import Mesh

MOMENT_CHUNK = 49152  # the engine's chunk (icp/moments.py:compute_group_moments)


def sharded_icp_hb(mesh: Mesh, q, t, ps, ns, pt, nt, src_id, tgt_id, w, num_clouds: int):
    """ICP H (6C,6C), b (6C,), cost of this rank's correspondence rows at
    the replicated corrections ``q (C,4)``, ``t (C,3)``, summed over the
    mesh: replicated float64 tensors (B4a's output type; JAX's are
    float32). The rows are ``(M_r, 3)`` global-frame correspondences with
    per-row cloud ids, as ``_icp_hb_cost`` takes them."""
    H, b, cost = icp_hb_cost_rows(q, t, ps, ns, pt, nt, src_id, tgt_id, w, num_clouds)
    return mesh.all_reduce(H), mesh.all_reduce(b), mesh.all_reduce(cost)


def sharded_moment_gram(mesh: Mesh, ps, ns, pt, nt, w, chunk: int = MOMENT_CHUNK):
    """The monomial moment Gram P = sum m m^T of ONE correspondence group
    whose rows are sharded over ``mesh``: this rank's rows packed and taken
    through one B2 pass, its partial Grams summed in float64 (as the
    one-device path sums them), then summed over the mesh. Returns the
    replicated (42, 42) float64 tensor; the inner LM schedule after it
    (``icp_lm_from_moments``) is O(1) host math, whatever the mesh size."""
    data, _ = pack_group_data([dict(ps=ps, ns=ns, pt=pt, nt=nt, w=w)], chunk, rows=13,
                              device=ps.device)
    parts, _ = moment_gram_partials(data, chunk)
    return mesh.all_reduce(parts.sum(0, dtype=torch.float64))
