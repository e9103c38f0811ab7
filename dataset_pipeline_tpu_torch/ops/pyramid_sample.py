"""Trilinear pyramid sampling with derivatives (B3's counterpart).

Counterpart of the TPU brick sampler, ``dataset_pipeline_tpu/ops/brick.py``
(``brick_sample[_with_derivs]`` over ``_extract_pallas``), with the
coordinate convention, validity and clipping of the flat sampler
``_bilinear_flat`` / ``_sample_pyramid[_with_derivs]`` of
``dataset_pipeline_tpu/photometric/optimizer.py``.

An image's pyramid is one flat float32 row: level l is the row-major
(H_l, W_l) plane at ``offs[l]``. A batch of images is ``flat (nb, total)``
with a static :class:`PyramidLayout`, built once per image chunk.

The kernel reads its taps from a row-paired copy of the pyramid,
``pairs (nb, layout.pair_total)``, built once per image chunk beside ``flat``
by :func:`pair_rows`: level l holds ``H_l - 1`` pair rows of
``pair_stride(W_l)`` floats at ``layout.pair_offs[l]``, pair row y
interleaving rows y and y+1, ``pairs[.., 2x + r] = level[y + r, x]``, so a
bilinear footprint is 16 contiguous bytes (``csrc/pyramid_sample.cu``).

:func:`pyramid_sample` takes the plain PyTorch version (:func:`sample_plain`,
the oracle and the CPU path) for CPU tensors and launches the hand-written
CUDA kernel for CUDA tensors; any other device raises, and so does a CUDA
call whose kernel cannot be built. ``kernels.LAUNCHES`` counts the kernel
launches per mode (and ``pyramid_pairs`` those of the copy's kernel).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from dataset_pipeline_tpu_torch import kernels


class PyramidLayout(NamedTuple):
    hs: Tuple[int, ...]  # per level height
    ws: Tuple[int, ...]  # per level width
    offs: Tuple[int, ...]  # per level offset into the flat row
    total: int

    @property
    def levels(self) -> int:
        return len(self.hs)

    @property
    def pair_offs(self) -> Tuple[int, ...]:
        """Per level offset into a row of the row-paired copy."""
        offs, acc = [], 0
        for h, w in zip(self.hs, self.ws):
            offs.append(acc)
            acc += (h - 1) * pair_stride(w)
        return tuple(offs)

    @property
    def pair_total(self) -> int:
        return sum((h - 1) * pair_stride(w) for h, w in zip(self.hs, self.ws))


def pair_stride(w: int) -> int:
    """Floats of a pair row of a level of width ``w``: 2w rounded up to a
    multiple of 4 (16 bytes), so that every pair row starts aligned."""
    return (2 * w + 3) // 4 * 4


def pyramid_layout(shapes) -> PyramidLayout:
    """Layout of a pyramid from its per-level (H, W)."""
    offs, acc = [], 0
    for h, w in shapes:
        offs.append(acc)
        acc += int(h) * int(w)
    return PyramidLayout(tuple(int(h) for h, _ in shapes),
                         tuple(int(w) for _, w in shapes), tuple(offs), acc)


def flatten_pyramid(pyr: List[torch.Tensor]):
    """Per-level (nb, H_l, W_l) planes -> (flat (nb, total), layout)."""
    layout = pyramid_layout([p.shape[-2:] for p in pyr])
    nb = pyr[0].shape[0]
    flat = torch.cat([p.reshape(nb, -1) for p in pyr], 1).contiguous()
    return flat, layout


def pair_rows_plain(flat, layout: PyramidLayout):
    """Plain PyTorch version of the row-paired copy's kernel: ``(nb,
    layout.pair_total)`` in ``flat.dtype``, zeros in each pair row's padding."""
    nb = flat.shape[0]
    parts = []
    for h, w, off in zip(layout.hs, layout.ws, layout.offs):
        lvl = flat[:, off:off + h * w].reshape(nb, h, w)
        rows = torch.stack([lvl[:, :-1], lvl[:, 1:]], -1).reshape(nb, h - 1, 2 * w)
        parts.append(torch.nn.functional.pad(rows, (0, pair_stride(w) - 2 * w)).reshape(nb, -1))
    return torch.cat(parts, 1).contiguous()


def pair_rows(flat, layout: PyramidLayout):
    """The row-paired copy ``(nb, layout.pair_total)`` of ``flat`` that the
    sampling kernel reads: the plain version for a CPU tensor, the kernel
    (``dpt_pyramid_pairs``) for a CUDA one."""
    _check_flat(flat, layout)
    if flat.device.type == "cpu":
        return pair_rows_plain(flat, layout)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError(f"flat must be contiguous float32 on CUDA; got {flat.dtype}")
    nb, L = flat.shape[0], layout.levels
    pairs = torch.empty((nb, layout.pair_total), dtype=torch.float32, device=flat.device)
    err = kernels.library().dpt_pyramid_pairs(
        flat.data_ptr(), layout.total, pairs.data_ptr(), layout.pair_total, nb,
        (ctypes.c_int * L)(*layout.hs), (ctypes.c_int * L)(*layout.ws),
        (ctypes.c_longlong * L)(*layout.offs), (ctypes.c_longlong * L)(*layout.pair_offs), L,
        torch.cuda.current_stream(flat.device).cuda_stream)
    kernels.check(err, "dpt_pyramid_pairs")
    kernels.LAUNCHES["pyramid_pairs"] += 1
    return pairs


def _check_flat(flat, layout: PyramidLayout):
    if flat.dim() != 2 or flat.shape[1] != layout.total:
        raise ValueError(f"flat must be (nb, {layout.total}); got {tuple(flat.shape)}")


def _bilinear_plain(flat, layout: PyramidLayout, level, pix0, derivs: bool):
    """Bilinear sample of each observation's pyramid ``level`` (nb, N) at
    full-res coords: (value, dx, dy, valid), the 2^-level coordinate scale
    folded into the derivatives."""
    dev, dt = flat.device, flat.dtype
    H = torch.tensor(layout.hs, device=dev)[level]
    W = torch.tensor(layout.ws, device=dev)[level]
    off = torch.tensor(layout.offs, device=dev)[level]
    f = torch.tensor([2.0 ** -l for l in range(layout.levels)], dtype=dt, device=dev)[level]
    x = f * (pix0[..., 0] + 0.5) - 0.5
    y = f * (pix0[..., 1] + 0.5) - 0.5
    flx, fly = torch.floor(x), torch.floor(y)
    valid = (x >= 0) & (y >= 0) & (flx < (W - 1).to(dt)) & (fly < (H - 1).to(dt))
    ixf = torch.minimum(torch.clamp(torch.nan_to_num(flx, nan=0.0), min=0.0),
                        torch.clamp(W - 2, min=0).to(dt))
    iyf = torch.minimum(torch.clamp(torch.nan_to_num(fly, nan=0.0), min=0.0),
                        torch.clamp(H - 2, min=0).to(dt))
    base = off + iyf.long() * W + ixf.long()
    tl = torch.gather(flat, 1, base)
    tr = torch.gather(flat, 1, base + 1)
    bl = torch.gather(flat, 1, base + W)
    br = torch.gather(flat, 1, base + W + 1)
    fx = x - ixf
    fy = y - iyf
    top = (1 - fx) * tl + fx * tr
    bottom = (1 - fx) * bl + fx * br
    value = (1 - fy) * top + fy * bottom
    if not derivs:
        return value, None, None, valid
    dx = (fy * (br - bl) + (1 - fy) * (tr - tl)) * f
    dy = (bottom - top) * f
    return value, dx, dy, valid


def sample_plain(flat, layout: PyramidLayout, pix0, obs_scale, with_derivs: bool = True):
    """Plain PyTorch version of the kernel (any float dtype): (value, dpx,
    dpy, ds, ok) with derivatives, else (value, ok); all (nb, N)."""
    shape = pix0.shape[:-1]
    if layout.levels == 1:
        zero = torch.zeros(shape, dtype=torch.long, device=flat.device)
        v, dx, dy, ok = _bilinear_plain(flat, layout, zero, pix0, with_derivs)
        return (v, dx, dy, torch.zeros_like(v), ok) if with_derivs else (v, ok)
    fs = torch.floor(obs_scale)
    finite = torch.isfinite(obs_scale)
    si = torch.where(finite, torch.clamp(torch.nan_to_num(fs) + 1, 1, layout.levels - 1),
                     torch.ones_like(fs)).long()
    z = 1.0 - (obs_scale - fs)
    vc, dxc, dyc, okc = _bilinear_plain(flat, layout, si, pix0, with_derivs)
    vf, dxf, dyf, okf = _bilinear_plain(flat, layout, si - 1, pix0, with_derivs)
    value = (1.0 - z) * vc + z * vf
    ok = okc & okf
    if not with_derivs:
        return value, ok
    dpx = (1.0 - z) * dxc + z * dxf
    dpy = (1.0 - z) * dyc + z * dyf
    ds = -(vf - vc)  # dz/dscale = -1
    return value, dpx, dpy, ds, ok


def pyramid_sample(flat, layout: PyramidLayout, pix0, obs_scale, with_derivs: bool = True,
                   pairs=None):
    """Trilinear sample of ``flat (nb, total)`` at full-res ``pix0 (nb, N, 2)``
    and continuous scale ``obs_scale (nb, N)``: (value, dpx, dpy, ds, ok)
    with derivatives (the counterpart of ``brick_sample_with_derivs``), else
    (value, ok) (of ``brick_sample``). On CUDA the kernel reads ``pairs``,
    ``flat``'s row-paired copy (:func:`pair_rows`): a caller that samples one
    image chunk many times builds it once and passes it; without it the copy
    is built for this call. The plain version reads ``flat``."""
    nb = flat.shape[0]
    _check_flat(flat, layout)
    n = pix0.shape[1]
    if tuple(pix0.shape) != (nb, n, 2) or tuple(obs_scale.shape) != (nb, n):
        raise ValueError(f"pix0 must be ({nb}, N, 2) and obs_scale ({nb}, N); got "
                         f"{tuple(pix0.shape)}, {tuple(obs_scale.shape)}")
    for x in (pix0, obs_scale) + (() if pairs is None else (pairs,)):
        if x.device != flat.device:
            raise ValueError(f"all inputs must be on {flat.device}; got {x.device}")
    if flat.device.type == "cpu":
        return sample_plain(flat, layout, pix0, obs_scale, with_derivs)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if pairs is None:
        pairs = pair_rows(flat, layout)
    if tuple(pairs.shape) != (nb, layout.pair_total):
        raise ValueError(f"pairs must be the row-paired copy pair_rows(flat, layout), "
                         f"(nb, {layout.pair_total}); got {tuple(pairs.shape)}")
    for name, x in (("flat", flat), ("pairs", pairs), ("pix0", pix0), ("obs_scale", obs_scale)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on CUDA; got {x.dtype}")

    lib = kernels.library()
    L = layout.levels
    hs = (ctypes.c_int * L)(*layout.hs)
    ws = (ctypes.c_int * L)(*layout.ws)
    offs = (ctypes.c_longlong * L)(*layout.pair_offs)
    value = torch.empty((nb, n), dtype=torch.float32, device=flat.device)
    ok = torch.empty((nb, n), dtype=torch.bool, device=flat.device)
    if with_derivs:
        dpx, dpy, ds = (torch.empty_like(value) for _ in range(3))
        ptrs = (dpx.data_ptr(), dpy.data_ptr(), ds.data_ptr())
    else:
        ptrs = (None, None, None)
    err = lib.dpt_pyramid_sample(
        pairs.data_ptr(), layout.pair_total, nb, hs, ws, offs, L, pix0.data_ptr(),
        obs_scale.data_ptr(), n, int(with_derivs), value.data_ptr(), *ptrs, ok.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream)
    kernels.check(err, "dpt_pyramid_sample")
    if n:  # the entry point launches nothing for zero observations
        kernels.LAUNCHES["pyramid_sample_derivs" if with_derivs else "pyramid_sample_value"] += 1
    return (value, dpx, dpy, ds, ok) if with_derivs else (value, ok)
