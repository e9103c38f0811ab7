"""Device-memory read-and-sum (B5b): the measured read bandwidth of the card.

Counterpart of the kernel inside ``bench.py:bench_hbm_copy_roofline``, which
lives in the bench file there; here it is a module so that the bench tool,
the tests and ``chip_smoke.py`` share it. The wrapper takes the plain
version for a CPU tensor and launches ``csrc/hbm_read_sum.cu`` for a CUDA
tensor, counting the launch in ``kernels.LAUNCHES["hbm_read_sum"]``.
"""

from __future__ import annotations

import torch

HBM_ROWS = 8
_COLS_PER_BLOCK = 4096  # columns a block sweeps, over all 8 rows (128 KB)


def hbm_read_sum_plain(data2, repeats: int = 1):
    """Plain PyTorch version of the B5b kernel: ``(8,)`` in ``data2.dtype``,
    repeat ``r`` adding the row sums of copy ``r % 2``."""
    n0, n1 = (repeats + 1) // 2, repeats // 2
    return n0 * data2[0].sum(1) + n1 * data2[1].sum(1)


def hbm_read_sum(data2, repeats: int = 1):
    """``out[k] = sum_r sum_cols data2[r % 2, k, :]`` as ``(8,)`` float32 for
    ``data2 (2, 8, mp)`` float32, ``mp`` a multiple of 4. Every repeat reads
    one whole copy from device memory, so ``(T(R) - T(1)) / (R - 1)`` over
    ``8 * mp * 4`` bytes is the card's read bandwidth."""
    if data2.dim() != 3 or tuple(data2.shape[:2]) != (2, HBM_ROWS) or data2.shape[2] == 0:
        raise ValueError(f"data2 must be (2, {HBM_ROWS}, mp); got {tuple(data2.shape)}")
    if repeats < 1:
        raise ValueError(f"repeats={repeats} must be >= 1")
    if data2.device.type == "cpu":
        return hbm_read_sum_plain(data2, repeats)
    if data2.device.type != "cuda":
        raise ValueError(f"unsupported device {data2.device}")
    mp = data2.shape[2]
    if data2.dtype != torch.float32 or not data2.is_contiguous() or mp % 4 != 0:
        raise ValueError("data2 must be contiguous float32 with mp a multiple of 4 on CUDA; "
                         f"got {data2.dtype} {tuple(data2.shape)}")

    from dataset_pipeline_tpu_torch import kernels

    nblocks = -(-mp // _COLS_PER_BLOCK)
    partials = torch.empty((nblocks, HBM_ROWS), dtype=torch.float32, device=data2.device)
    out = torch.empty(HBM_ROWS, dtype=torch.float32, device=data2.device)
    err = kernels.library().dpt_hbm_read_sum(
        data2.data_ptr(), mp, _COLS_PER_BLOCK, repeats, partials.data_ptr(), nblocks,
        out.data_ptr(), torch.cuda.current_stream(data2.device).cuda_stream)
    kernels.check(err, "dpt_hbm_read_sum")
    kernels.LAUNCHES["hbm_read_sum"] += 1
    return out
