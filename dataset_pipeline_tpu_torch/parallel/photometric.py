"""Mesh-sharded photometric normal-equation accumulation.

Counterpart of ``dataset_pipeline_tpu/parallel/photometric.py``. The
optimizer's batched dispatch (``photometric/optimizer.py:_hb_batch`` and its
rig and depth twins) takes one image chunk; here each rank of the mesh
takes its contiguous share of the chunk's images:

- each rank runs the same per-chunk function on its images (B3 on the card)
  with the replicated level geometry;
- the per-image (V,V) / (V,) blocks are ``all_gather``ed in image order
  (per-image pose blocks never interact across ranks, so JAX leaves them
  sharded and fetches them; here every rank receives all of them);
- the chunk's cost and count are ``all_reduce``d.

Every rank then assembles the same big system, the shared intrinsics block
summed on the host exactly as in the sequential path. The level geometry
(points, neighbors, descriptors) is shared by every image, or with
``geom_batched`` stacked per image (the observations cache's views and the
variable descriptors gathered into them), and then sharded with the images,
as JAX's ``geom_batched`` does.

A chunk whose image count is not a multiple of the mesh size is padded for
the gather: a rank's missing images repeat the chunk's last one with an
empty observation mask, which adds nothing, and the padding blocks are cut
off after the gather (the optimizer rounds ``image_chunk`` up to a multiple
of the mesh size, so only a chunk's remainder is padded).
"""

from __future__ import annotations

import torch

from dataset_pipeline_tpu_torch.parallel.mesh import Mesh
from dataset_pipeline_tpu_torch.photometric import optimizer as _opt


def shard_image_axis(mesh: Mesh, nb: int):
    """This rank's images of an ``nb``-image chunk: ``(index, valid)``, a
    slice and None where the share lies inside the chunk, else an index
    tensor that repeats the last image and the (k,) mask of real images.
    Every rank's share has ``ceil(nb / mesh.size)`` entries."""
    k = -(-nb // mesh.size)
    start, stop = mesh.rank * k, (mesh.rank + 1) * k
    if stop <= nb:
        return slice(start, stop), None
    idx = torch.arange(start, stop, device=mesh.device)
    return idx.clamp(max=nb - 1), idx < nb


class ShardedPhotometricKernels:
    """The optimizer's batched H,b dispatches (``_hb_batch``,
    ``_hb_rig_batch``, ``_hb_depth_batch``, with their arguments and results
    and JAX's ``geom_batched``) over the ranks of ``mesh``. On a one-rank
    mesh a rank's share is the whole chunk and the collectives are the
    identity, so the result is the dispatch's own. ``timings`` goes to the
    dispatch, whose child spans time this rank's share."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _shard(self, nb: int, contrib, per_image, geometry, geom_batched: bool):
        """This rank's images: (contrib, per-image tensors, geometry), the
        geometry sliced with them when ``geom_batched``."""
        sel, valid = shard_image_axis(self.mesh, nb)
        contrib = contrib[sel] if valid is None else contrib[sel] & valid[:, None]
        return (contrib, [None if x is None else x[sel] for x in per_image],
                [x[sel] for x in geometry] if geom_batched else geometry)

    def _reduce(self, nb: int, out):
        H, b, cost, count = out
        gather = self.mesh.all_gather
        return (gather(H)[:nb], gather(b)[:nb], self.mesh.all_reduce(cost),
                self.mesh.all_reduce(count))

    def hb_batch(self, camera, params, pose_q, pose_t, points, neighbors, desc, flat, layout,
                 obs_scale, contrib, radius, optimize_intrinsics: bool, dynamic_scale: bool,
                 pairs=None, geom_batched: bool = False, timings=None):
        nb = pose_q.shape[0]
        contrib, (q, t, f, s, pr), (pts, nbr, d) = self._shard(
            nb, contrib, (pose_q, pose_t, flat, obs_scale, pairs), (points, neighbors, desc),
            geom_batched)
        return self._reduce(nb, _opt._hb_batch(camera, params, q, t, pts, nbr, d, f, layout, s,
                                               contrib, radius, optimize_intrinsics,
                                               dynamic_scale, pr, timings=timings))

    def hb_rig_batch(self, camera, params, extr_q, extr_t, ref_q, ref_t, points, neighbors, desc,
                     flat, layout, obs_scale, contrib, radius, optimize_intrinsics: bool,
                     dynamic_scale: bool, pairs=None, geom_batched: bool = False, timings=None):
        nb = ref_q.shape[0]
        contrib, (q, t, f, s, pr), (pts, nbr, d) = self._shard(
            nb, contrib, (ref_q, ref_t, flat, obs_scale, pairs), (points, neighbors, desc),
            geom_batched)
        return self._reduce(nb, _opt._hb_rig_batch(camera, params, extr_q, extr_t, q, t, pts, nbr,
                                                   d, f, layout, s, contrib, radius,
                                                   optimize_intrinsics, dynamic_scale, pr,
                                                   timings=timings))

    def hb_depth_batch(self, camera, params, pose_q, pose_t, points, flat, layout, obs_scale,
                       contrib, optimize_intrinsics: bool, pairs=None,
                       geom_batched: bool = False, timings=None):
        nb = pose_q.shape[0]
        contrib, (q, t, f, s, pr), (pts,) = self._shard(
            nb, contrib, (pose_q, pose_t, flat, obs_scale, pairs), (points,), geom_batched)
        return self._reduce(nb, _opt._hb_depth_batch(camera, params, q, t, pts, f, layout, s,
                                                     contrib, optimize_intrinsics, pr,
                                                     timings=timings))
