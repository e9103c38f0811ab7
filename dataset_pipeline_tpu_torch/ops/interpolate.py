"""Bilinear / two-level trilinear image sampling with analytic derivatives.

Port of ``dataset_pipeline_tpu/ops/interpolate.py``: (0,0) is the centre of
the top-left pixel; ``image0`` is the coarser image whose coordinates are
given and ``image1`` is twice its size, addressed at ``x1 = 2*(x0+0.5)-0.5``;
z = 0 picks image0, z = 1 image1, and d/dx picks up a factor 2 on the image1
term. Batched over any leading dims; out-of-bounds access gives valid=False
(values are still computed from clamped indices: mask them).
"""

from __future__ import annotations

import torch


def _taps(image, x, y):
    H, W = image.shape
    ix = torch.floor(x).to(torch.int64)
    iy = torch.floor(y).to(torch.int64)
    valid = (x >= 0) & (y >= 0) & (ix < W - 1) & (iy < H - 1)
    ixc = torch.clamp(ix, 0, W - 2)
    iyc = torch.clamp(iy, 0, H - 2)
    tl = image[iyc, ixc]
    tr = image[iyc, ixc + 1]
    bl = image[iyc + 1, ixc]
    br = image[iyc + 1, ixc + 1]
    fx = x - ixc
    fy = y - iyc
    top = (1 - fx) * tl + fx * tr
    bottom = (1 - fx) * bl + fx * br
    return tl, tr, bl, br, fy, top, bottom, valid


def bilinear(image, x, y):
    """Sample ``image (H,W)`` at (x,y) pixel-centre coords: (value, valid);
    x<0 | y<0 | ix>=W-1 | iy>=H-1 is invalid."""
    _, _, _, _, fy, top, bottom, valid = _taps(image, x, y)
    return (1 - fy) * top + fy * bottom, valid


def bilinear_with_derivatives(image, x, y):
    """(value, dv/dx, dv/dy, valid)."""
    tl, tr, bl, br, fy, top, bottom, valid = _taps(image, x, y)
    value = (1 - fy) * top + fy * bottom
    dx = fy * (br - bl) + (1 - fy) * (tr - tl)
    dy = bottom - top
    return value, dx, dy, valid


def trilinear(image0, image1, x0, y0, z):
    """Two-level interpolation: coords given on image0; image1 is 2x its size."""
    v0, ok0 = bilinear(image0, x0, y0)
    x1 = 2 * (x0 + 0.5) - 0.5
    y1 = 2 * (y0 + 0.5) - 0.5
    v1, ok1 = bilinear(image1, x1, y1)
    return (1 - z) * v0 + z * v1, ok0 & ok1


def trilinear_with_derivatives(image0, image1, x0, y0, z):
    """(value, dv/dx0, dv/dy0, dv/dz, valid)."""
    v0, dx0, dy0, ok0 = bilinear_with_derivatives(image0, x0, y0)
    x1 = 2 * (x0 + 0.5) - 0.5
    y1 = 2 * (y0 + 0.5) - 0.5
    v1, dx1, dy1, ok1 = bilinear_with_derivatives(image1, x1, y1)
    value = (1 - z) * v0 + z * v1
    dx = (1 - z) * dx0 + z * 2 * dx1
    dy = (1 - z) * dy0 + z * 2 * dy1
    dz = v1 - v0
    return value, dx, dy, dz, ok0 & ok1
