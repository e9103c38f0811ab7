"""The port's forward-step entry point.

Counterpart of the JAX package's ``__graft_entry__.entry()``: the
Gauss-Newton H, b, cost accumulation at the core of the ICP alignment path,
with example arguments made from a seed by the same numpy recipe.
"""

from __future__ import annotations

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.icp.point_to_plane import _icp_hb_cost


def _example_icp_problem(m: int = 4096, num_clouds: int = 2, seed: int = 0, device="cuda"):
    """(q, t, ps, ns, pt, nt, sid, tid, w) tensors on ``device``: ``m``
    correspondences between ``num_clouds`` clouds at identity corrections."""
    rng = np.random.RandomState(seed)
    ps = rng.randn(m, 3).astype(np.float32)
    ns = rng.randn(m, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    pt = ps + np.float32(0.01) * rng.randn(m, 3).astype(np.float32)
    sid = rng.randint(0, num_clouds, m).astype(np.int32)
    tid = ((sid + 1) % num_clouds).astype(np.int32)
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (num_clouds, 1))
    t = np.zeros((num_clouds, 3), np.float32)
    arrays = (q, t, ps, ns, pt, ns, sid, tid, np.ones(m, np.float32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` is one H (12,12), b (12,), cost
    accumulation over 4096 correspondences of 2 clouds. The tensors lie on
    the card unless ``device="cpu"``; it raises when CUDA is named and absent."""
    args = _example_icp_problem(device=resolve_device(device))

    def fn(q, t, ps, ns, pt, nt, sid, tid, w):
        return _icp_hb_cost(q, t, ps, ns, pt, nt, sid, tid, w, num_clouds=2)

    return fn, args
