"""Observations cache: per-image compaction of the candidate points.

Port of ``dataset_pipeline_tpu/photometric/obs_cache.py``. For every (group,
image, point level) the candidate set is

  1. computed with the loosest visibility gate the schedule will use
     (``current_scale = 0``, doubled occlusion slack, no mask filter), so it
     is a superset of every later iteration's observations up to pose drift;
  2. closed under the K-neighbour relation, so the descriptor residuals of
     every candidate can be evaluated inside the view;
  3. padded to a power-of-two bucket (the JAX package's shapes; the file
     and the views are the same in both packages).

Later visibility, cost and H,b passes run on a view's M points instead of
the level's N, and per-point results go back to the level through
``scatter_idx`` (padding rows carry N and are dropped).
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

CACHE_VERSION = 1


def _bucket(n: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class LevelView:
    """Compacted geometry of one point level as seen by one image.

    ``gather_idx`` (M,) indexes the full level (padding repeats index 0 with
    ``core=False``); ``scatter_idx`` pads with N. ``neighbors`` index into the
    view; every core point's K neighbours are in it."""

    gather_idx: torch.Tensor  # (M,) int64, padded with 0
    scatter_idx: torch.Tensor  # (M,) int64, padded with N
    core: torch.Tensor  # (M,) bool: True for candidate rows
    points: torch.Tensor  # (M,3)
    neighbors: torch.Tensor  # (M,K) int64 indices into the view
    fixed_descriptors: torch.Tensor  # (M,K)
    count: int  # real (non-padding) rows

    @property
    def size(self) -> int:
        return int(self.gather_idx.shape[0])


def build_level_view(level, candidate_mask: np.ndarray) -> LevelView:
    """Close ``candidate_mask`` under the neighbour relation and compact, on
    the level's device."""
    dev = level.points.device
    neighbors = level.neighbors.cpu().numpy()
    n = neighbors.shape[0]
    core = np.asarray(candidate_mask, bool)
    ext_mask = core.copy()
    ext_mask[neighbors[core].ravel()] = True
    ext = np.flatnonzero(ext_mask)
    m = len(ext)
    mp = _bucket(max(m, 1))
    inv = np.zeros(n, np.int64)
    inv[ext] = np.arange(m)
    # neighbours of non-core rows may fall outside the view: they map to the
    # row itself (only core rows contribute, and theirs are all inside)
    nb = neighbors[ext]
    outside = ~ext_mask[nb]
    nb = inv[nb]
    nb[outside] = np.repeat(np.arange(m)[:, None], nb.shape[1], 1)[outside]

    gather = np.zeros(mp, np.int64)
    gather[:m] = ext
    scatter = np.full(mp, n, np.int64)
    scatter[:m] = ext
    core_v = np.zeros(mp, bool)
    core_v[:m] = core[ext]
    nb_full = np.zeros((mp, neighbors.shape[1]), np.int64)
    nb_full[:m] = nb
    nb_full[m:] = np.arange(m, mp)[:, None]
    gather_t = torch.from_numpy(gather).to(dev)
    pts = level.points[gather_t]
    pts[m:] = torch.tensor([0.0, 0.0, -1.0], dtype=pts.dtype, device=dev)  # behind any camera
    desc = level.fixed_descriptors[gather_t]
    desc[m:] = 0.0
    return LevelView(gather_t, torch.from_numpy(scatter).to(dev), torch.from_numpy(core_v).to(dev),
                     pts, torch.from_numpy(nb_full).to(dev), desc, m)


class ObservationsCache:
    """Candidate store keyed by (group, image, level), built once after the
    first scale and used for the remaining iterations and scales."""

    def __init__(self):
        self._views: Dict[Tuple[int, int, int], LevelView] = {}
        self._masks: Dict[Tuple[int, int, int], np.ndarray] = {}

    def set_candidates(self, gi: int, b: int, l: int, level, candidate_mask: np.ndarray) -> None:
        self._masks[(gi, b, l)] = np.asarray(candidate_mask, bool)
        self._views[(gi, b, l)] = build_level_view(level, candidate_mask)

    def view(self, gi: int, b: int, l: int) -> Optional[LevelView]:
        return self._views.get((gi, b, l))

    def candidates(self, gi: int, b: int, l: int) -> Optional[np.ndarray]:
        """The candidate mask a view was built from (for the drift check)."""
        return self._masks.get((gi, b, l))

    def stats(self) -> Tuple[int, int]:
        """(candidate rows, padded rows) over all views."""
        return (sum(v.count for v in self._views.values()),
                sum(v.size for v in self._views.values()))

    def save(self, path: str, levels) -> None:
        arrays = {"__version__": np.asarray([CACHE_VERSION])}
        for (gi, b, l), mask in self._masks.items():
            arrays[f"m_{gi}_{b}_{l}"] = np.packbits(mask)
            arrays[f"n_{gi}_{b}_{l}"] = np.asarray([len(mask)])
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, levels) -> Optional["ObservationsCache"]:
        """The cache at ``path``, or None (rebuild) when it is missing, of
        another version, or built for other levels."""
        if not os.path.exists(path):
            return None
        try:
            data = np.load(path)
        except (OSError, ValueError, zipfile.BadZipFile):
            return None
        if "__version__" not in data or int(data["__version__"][0]) != CACHE_VERSION:
            return None
        cache = cls()
        for key in data.files:
            if not key.startswith("m_"):
                continue
            gi, b, l = (int(x) for x in key[2:].split("_"))
            if l >= len(levels):
                return None
            n = int(data["n_" + key[2:]][0])
            if n != int(levels[l].points.shape[0]):
                return None
            cache.set_candidates(gi, b, l, levels[l], np.unpackbits(data[key])[:n].astype(bool))
        return cache
