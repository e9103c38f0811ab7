"""Disk caches of the registrator's set-up (restart resilience).

Port of ``dataset_pipeline_tpu/photometric/cache.py``: the multi-resolution
point cloud (one ``level_<i>.npz`` per point level plus ``metadata.json``) and
the processed photo levels with their seeded K-neighbour indices and fixed
descriptors (``photo_level_<i>.npz`` plus ``photo_metadata.json``). A cache
whose parameters differ from the run's is ignored and rebuilt, with a note of
what changed.

The files are the JAX package's: the same JSON text and the same arrays under
the same names, dtypes and order (neighbours as int32), so either package
loads what the other wrote.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from dataset_pipeline_tpu_torch.photometric.multiscale import PointLevel

CACHE_VERSION = 1


def _meta(params: dict) -> dict:
    return {"version": CACHE_VERSION, **{k: float(v) if isinstance(v, (int, float)) else v
                                          for k, v in params.items()}}


def _read_meta(path: str, params: dict, what: str) -> Optional[dict]:
    """The metadata at ``path`` if it matches ``params``, else None."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        meta = json.load(f)
    expected = _meta(params)
    mismatched = [k for k in expected if meta.get(k) != expected[k]]
    if mismatched:
        print(f"{what} cache invalidated (changed: {', '.join(mismatched)}); regenerating")
        return None
    return meta


def save_multiscale_cache(cache_dir: str, levels: List[PointLevel], params: dict) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, "metadata.json"), "w") as f:
        json.dump({**_meta(params), "num_levels": len(levels)}, f)
    for i, lv in enumerate(levels):
        np.savez(os.path.join(cache_dir, f"level_{i}.npz"),
                 points=lv.points, intensities=lv.intensities,
                 scan_indices=lv.scan_indices, radius=np.float64(lv.radius))


def load_multiscale_cache(cache_dir: str, params: dict) -> Optional[List[PointLevel]]:
    meta = _read_meta(os.path.join(cache_dir, "metadata.json"), params, "multiscale")
    if meta is None:
        return None
    levels = []
    for i in range(int(meta["num_levels"])):
        path = os.path.join(cache_dir, f"level_{i}.npz")
        if not os.path.exists(path):
            return None
        z = np.load(path)
        levels.append(PointLevel(z["points"], z["intensities"], z["scan_indices"],
                                 float(z["radius"])))
    return levels


def save_photo_levels_cache(cache_dir: str, photo_levels, params: dict) -> None:
    """Persist the processed point levels with the seeded K-neighbour indices
    and fixed descriptors, so a restart skips the kNN search and the
    gradient filter."""
    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, "photo_metadata.json"), "w") as f:
        json.dump({**_meta(params), "num_levels": len(photo_levels)}, f)
    for i, pl in enumerate(photo_levels):
        np.savez(os.path.join(cache_dir, f"photo_level_{i}.npz"),
                 points=pl.points.cpu().numpy(),
                 intensities=pl.intensities.cpu().numpy(),
                 scan_indices=pl.scan_indices.cpu().numpy(),
                 neighbors=pl.neighbors.cpu().numpy().astype(np.int32),
                 fixed_descriptors=pl.fixed_descriptors.cpu().numpy(),
                 radius=np.float64(pl.radius))


def load_photo_levels_cache(cache_dir: str, params: dict, device=None):
    """The cached photo levels on ``device``; None on a miss or mismatch."""
    from dataset_pipeline_tpu_torch.photometric.problem import _level_to_device

    meta = _read_meta(os.path.join(cache_dir, "photo_metadata.json"), params, "photo-level")
    if meta is None:
        return None
    levels = []
    for i in range(int(meta["num_levels"])):
        path = os.path.join(cache_dir, f"photo_level_{i}.npz")
        if not os.path.exists(path):
            return None
        z = np.load(path)
        levels.append(_level_to_device(z["points"], z["intensities"], z["scan_indices"],
                                       z["neighbors"], z["fixed_descriptors"], float(z["radius"]),
                                       device))
    return levels
