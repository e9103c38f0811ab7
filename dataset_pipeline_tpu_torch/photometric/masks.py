"""Observation mask files and mask pyramids.

Port of the loading half of ``dataset_pipeline_tpu/photometric/masks.py``:
mask images live in ``<dataset>/masks_for_images/<image_folder>/<image>.png``
(per image) and ``<dataset>/masks_for_cameras/<image_folder>.png`` (per
camera); pixel values are bitflags (1 masks observations, 2 also masks
evaluation: ``MASK_OBS``, ``MASK_EVAL_OBS``). Pyramids use bitwise-OR (max)
pooling. PIL is imported only when a mask file exists.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from dataset_pipeline_tpu_torch import default_device

MASK_NONE = 0
MASK_OBS = 1
MASK_EVAL_OBS = 2


def image_mask_path(image_base_path: str, image_name: str) -> str:
    folder = os.path.dirname(image_name)
    fname = os.path.splitext(os.path.basename(image_name))[0] + ".png"
    return os.path.join(image_base_path, "masks_for_images", folder, fname)


def camera_mask_path(image_base_path: str, image_name: str) -> str:
    folder = os.path.dirname(image_name)
    return os.path.join(image_base_path, "masks_for_cameras", folder + ".png")


def load_mask(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.uint8)


def combined_mask(image_base_path: str, image_name: str, shape) -> Optional[np.ndarray]:
    """Bitwise-OR of the image mask and its camera mask, or None."""
    m1 = load_mask(image_mask_path(image_base_path, image_name))
    m2 = load_mask(camera_mask_path(image_base_path, image_name))
    if m1 is None and m2 is None:
        return None
    out = np.zeros(shape, np.uint8)
    for m in (m1, m2):
        if m is not None:
            if m.ndim == 3:
                m = m.max(-1)
            if m.shape != tuple(shape):
                raise ValueError(f"mask shape {m.shape} != image shape {shape}")
            out |= m.astype(np.uint8)
    return out


def build_mask_pyramid(masks, scale_count: int, device=None) -> List[torch.Tensor]:
    """(B,H,W) uint8 -> per-scale (B,H_s,W_s) via OR (max) pooling."""
    m = torch.as_tensor(np.asarray(masks, np.uint8), device=default_device(device))
    pyr = [m]
    for _ in range(1, scale_count):
        b, h, w = pyr[-1].shape
        h2, w2 = h // 2, w // 2
        c = pyr[-1][:, : h2 * 2, : w2 * 2]
        pyr.append(c.reshape(b, h2, 2, w2, 2).amax((2, 4)))
    return pyr
