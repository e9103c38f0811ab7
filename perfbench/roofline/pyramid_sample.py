"""The least work of one launch of kernel B3, the trilinear pyramid sampler.

Frozen copy of the byte model of ``chip_smoke.py`` (``tap_sectors``,
``check_b3``, ``bound``): the bytes are the distinct 32-byte sectors of the
flat pyramid that the taps touch (two rows x two columns in each of the two
levels that bracket an observation's scale), each read once, plus the
streamed inputs and outputs per observation (pixel 8 B, scale 4 B, the value
and with derivatives three more floats, the ok byte); the operations are 100
per observation. The bound is the larger of bytes over the H100 SXM's
3.35 TB/s and operations over its 67 TFLOP/s float32 (NVIDIA's data sheet,
at the 700 W limit). It depends on the inputs alone, not on how the kernel
reads them.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FLOPS_PER_OBS = 100


def distinct_sectors(layout, pix, scale) -> int:
    """Distinct 32-byte sectors of the flat pyramids (nb, layout.total) that
    the taps at ``pix`` (nb, n, 2) and ``scale`` (nb, n) touch."""
    nb = scale.shape[0]
    dev = pix.device
    L = len(layout.hs)
    si = torch.where(torch.isfinite(scale),
                     torch.clamp(torch.floor(torch.nan_to_num(scale)) + 1, 1, L - 1),
                     torch.ones_like(scale)).long()
    hs, ws = torch.tensor(layout.hs, device=dev), torch.tensor(layout.ws, device=dev)
    offs = torch.tensor(layout.offs, device=dev)
    img = torch.arange(nb, device=dev)[:, None] * layout.total
    ids = []
    for lvl in (si, si - 1):
        f = torch.pow(2.0, -lvl.float())
        W, H = ws[lvl], hs[lvl]
        x, y = (torch.nan_to_num(torch.floor(f * (pix[..., i] + 0.5) - 0.5), nan=0.0) for i in (0, 1))
        ix = torch.minimum(torch.clamp(x, min=0), W - 2)
        iy = torch.minimum(torch.clamp(y, min=0), H - 2)
        base = img + offs[lvl] + iy.long() * W + ix.long()
        for row in (base, base + W):
            ids += [row // 8, (row + 1) // 8]
    return int(torch.unique(torch.stack(ids, -1)).numel())


def launch_work(layout, pix, scale, with_derivs: bool):
    """(bytes, operations) that one launch's inputs need."""
    obs = scale.numel()
    streamed = obs * (8 + 4 + (16 if with_derivs else 4) + 1)
    return 32 * distinct_sectors(layout, pix, scale) + streamed, FLOPS_PER_OBS * obs


def bound_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
