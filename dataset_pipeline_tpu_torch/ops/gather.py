"""The gather probes' seven kernels (E1-E7): wrappers and plain versions.

Counterparts of the Pallas kernels of the JAX package's
``experiments/gather_probe.py`` (four gathers from a tile in fast memory and
the tile-gather bilinear prototype) and ``experiments/gather_probe2.py`` (the
lane extraction of the row sampler and of the brick layout). Each wrapper
takes its plain PyTorch version (``*_plain``, the oracle of the tests) for
CPU tensors and launches its hand-written CUDA kernel (``csrc/gather_probes.cu``,
``tile_gather.cu``, ``row_extract.cu``, ``row_extract_packed.cu``) for CUDA
tensors, counting the launch in ``kernels.LAUNCHES``; any other device
raises, and so does a CUDA call whose kernel cannot be built.

The tile kernels carry a leading batch axis of independent tiles (the JAX
probes are ``B = 1``). Index ranges are checked here, not in the kernels;
``check_ranges=False`` skips that check (it reads the indices back, which
synchronizes) for a caller that made the indices itself or checked them once.
"""

from __future__ import annotations

import torch

MAX_TILE = 8192  # floats of a tile staged in shared memory (32 KB)
BRICK_BX = 32  # pixels per line of a brick row: taps at l, l+1, l+32, l+33


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def take_along_lanes_plain(rows, idx):
    """``out[b, s, j] = rows[b, s, idx[b, s, j]]``."""
    return torch.gather(rows, 2, idx.long())


def take_along_sublanes_plain(rows, idx):
    """``out[b, k, j] = rows[b, idx[b, k, j], j]``."""
    return torch.gather(rows, 1, idx.long())


def take_rows_plain(table, idx):
    """``out[b, i, :] = table[b, idx[b, i], :]``."""
    return torch.gather(table, 1, idx.long()[..., None].expand(-1, -1, table.shape[2]))


def advanced_2d_plain(tiles, iy, ix):
    """``out[b, k, j] = tiles[b, iy[b, k, j], ix[b, k, j]]``."""
    b = torch.arange(tiles.shape[0], device=tiles.device)[:, None, None]
    return tiles[b, iy.long(), ix.long()]


def _bilinear_tail(tl, tr, bl, br, fx, fy):
    """Value and unscaled derivatives from the taps of a 2x2 footprint."""
    top = (1.0 - fx) * tl + fx * tr
    bot = (1.0 - fx) * bl + fx * br
    val = (1.0 - fy) * top + fy * bot
    ddx = fy * (br - bl) + (1.0 - fy) * (tr - tl)
    ddy = bot - top
    return val, ddx, ddy


def tile_gather_plain(tiles, iy, ix, fy, fx):
    """Per tile and task the bilinear value at ``(iy + fy, ix + fx)`` with
    d/dx and d/dy: ``(n_tiles, 4, cap)`` = value, ddx, ddy, 0."""
    g = torch.arange(tiles.shape[0], device=tiles.device)[:, None]
    y, x = iy.long(), ix.long()
    val, ddx, ddy = _bilinear_tail(tiles[g, y, x], tiles[g, y, x + 1], tiles[g, y + 1, x],
                                   tiles[g, y + 1, x + 1], fx, fy)
    return torch.stack([val, ddx, ddy, torch.zeros_like(val)], 1)


def _pad8(cols):
    """``(n, 8)`` from up to eight ``(n, 1)`` columns, zeros after them."""
    zero = torch.zeros_like(cols[0])
    return torch.cat(list(cols) + [zero] * (8 - len(cols)), 1)


def row_extract_plain(r0, r1, lane, fx, fy):
    """Lanes ``lane`` and ``lane + 1`` of the rows ``y`` (``r0``) and
    ``y + 1`` (``r1``) blended by ``fy`` then ``fx``: ``(n, 8)`` = value,
    ddx, ddy, 0..."""
    ln = lane.long()
    a0, a1 = torch.gather(r0, 1, ln), torch.gather(r0, 1, ln + 1)
    b0, b1 = torch.gather(r1, 1, ln), torch.gather(r1, 1, ln + 1)
    l0 = a0 * (1.0 - fy) + b0 * fy
    l1 = a1 * (1.0 - fy) + b1 * fy
    d0, d1 = b0 - a0, b1 - a1
    value = (1.0 - fx) * l0 + fx * l1
    ddx = l1 - l0
    ddy = (1.0 - fx) * d0 + fx * d1
    return _pad8([value, ddx, ddy])


def row_extract_packed_plain(ra, rb, la, lb, fxa, fya, fxb, fyb, zf, bx: int = BRICK_BX):
    """Both levels' bilinear samples from brick rows (taps at lanes ``l``,
    ``l + 1``, ``l + bx``, ``l + bx + 1``) blended by ``zf`` on level A:
    ``(n, 8)`` = value, ddx, ddy, dds = vA - vB, 0..."""
    def bil(r, lane, fx, fy):
        ln = lane.long()
        return _bilinear_tail(torch.gather(r, 1, ln), torch.gather(r, 1, ln + 1),
                              torch.gather(r, 1, ln + bx), torch.gather(r, 1, ln + bx + 1),
                              fx, fy)

    va, dxa, dya = bil(ra, la, fxa, fya)
    vb, dxb, dyb = bil(rb, lb, fxb, fyb)
    value = zf * va + (1.0 - zf) * vb
    ddx = zf * dxa + (1.0 - zf) * dxb * 0.5  # level B's pixels are twice as large
    ddy = zf * dya + (1.0 - zf) * dyb * 0.5
    return _pad8([value, ddx, ddy, va - vb])


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------


def _check_args(name: str, floats, ints, shapes, vector=1) -> bool:
    """Shapes, integer types and one device for all; on CUDA also float32 /
    int32 and contiguous, and the first ``vector`` tensors (read or copied
    16 bytes at a time) 16-byte aligned. True when the kernel must run."""
    tensors = list(floats) + list(ints)
    dev = tensors[0].device
    for x, shape in zip(tensors, shapes):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}; got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}; got {x.device}")
    for x in floats:
        if not x.is_floating_point():
            raise ValueError(f"{name}: expected a float tensor; got {x.dtype}")
    for x in ints:
        if x.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: indices must be int32 or int64; got {x.dtype}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for x, dt in [(x, torch.float32) for x in floats] + [(x, torch.int32) for x in ints]:
        if x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: on CUDA inputs must be contiguous float32 values and "
                             f"int32 indices; got {x.dtype}")
    for x in tensors[:vector]:
        if x.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: the tile or row tensor must be 16-byte aligned")
    return True


def _check_range(name: str, what: str, idx, hi: int) -> None:
    """Raise unless every index lies in ``[0, hi]``."""
    if idx.numel() == 0:
        return
    lo_, hi_ = (int(v) for v in torch.aminmax(idx))
    if lo_ < 0 or hi_ > hi:
        raise ValueError(f"{name}: {what} must lie in [0, {hi}]; got [{lo_}, {hi_}]")


def _check_tile(name: str, B: int, S: int, W: int) -> None:
    if B < 1 or S < 1 or W < 1 or S * W > MAX_TILE or (S * W) % 4 != 0:
        raise ValueError(f"{name}: a tile must hold a multiple of 4 and at most {MAX_TILE} "
                         f"floats, in a batch of at least one; got ({B}, {S}, {W})")


def _launch(entry: str, counter: str, args, like):
    from dataset_pipeline_tpu_torch import kernels

    fn = getattr(kernels.library(), entry)
    err = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
    kernels.check(err, entry)
    kernels.LAUNCHES[counter] += 1


def _dims3(name: str, x):
    if x.dim() != 3:
        raise ValueError(f"{name}: expected a (B, S, W) tensor; got {tuple(x.shape)}")
    return tuple(x.shape)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def take_along_lanes(rows, idx, check_ranges: bool = True):
    """E1: ``out[b, s, j] = rows[b, s, idx[b, s, j]]`` for ``rows (B, S, W)``
    and ``idx (B, S, W)`` in ``[0, W)``."""
    B, S, W = _dims3("take_along_lanes", rows)
    _check_tile("take_along_lanes", B, S, W)
    on_card = _check_args("take_along_lanes", [rows], [idx], [(B, S, W)] * 2)
    if check_ranges:
        _check_range("take_along_lanes", "idx", idx, W - 1)
    if not on_card:
        return take_along_lanes_plain(rows, idx)
    out = torch.empty_like(rows)
    _launch("dpt_take_along_lanes", "take_along_lanes",
            (rows.data_ptr(), idx.data_ptr(), out.data_ptr(), B, S, W), rows)
    return out


def take_along_sublanes(rows, idx, check_ranges: bool = True):
    """E2: ``out[b, k, j] = rows[b, idx[b, k, j], j]`` for ``rows (B, S, W)``
    and ``idx (B, K, W)`` in ``[0, S)``."""
    B, S, W = _dims3("take_along_sublanes", rows)
    _check_tile("take_along_sublanes", B, S, W)
    K = idx.shape[1] if idx.dim() == 3 else 0
    if K < 1:
        raise ValueError(f"take_along_sublanes: idx must be (B, K, W); got {tuple(idx.shape)}")
    on_card = _check_args("take_along_sublanes", [rows], [idx], [(B, S, W), (B, K, W)])
    if check_ranges:
        _check_range("take_along_sublanes", "idx", idx, S - 1)
    if not on_card:
        return take_along_sublanes_plain(rows, idx)
    out = torch.empty((B, K, W), dtype=torch.float32, device=rows.device)
    _launch("dpt_take_along_sublanes", "take_along_sublanes",
            (rows.data_ptr(), idx.data_ptr(), out.data_ptr(), B, S, K, W), rows)
    return out


def take_rows(table, idx, check_ranges: bool = True):
    """E3: ``out[b, i, :] = table[b, idx[b, i], :]`` for ``table (B, T, W)``,
    ``W`` a multiple of 4, and ``idx (B, K)`` in ``[0, T)``."""
    B, T, W = _dims3("take_rows", table)
    K = idx.shape[1] if idx.dim() == 2 else 0
    if B < 1 or T < 1 or K < 1 or W % 4 != 0:
        raise ValueError("take_rows: table must be (B, T, W) with W a multiple of 4 and idx "
                         f"(B, K); got {tuple(table.shape)}, {tuple(idx.shape)}")
    on_card = _check_args("take_rows", [table], [idx], [(B, T, W), (B, K)])
    if check_ranges:
        _check_range("take_rows", "idx", idx, T - 1)
    if not on_card:
        return take_rows_plain(table, idx)
    out = torch.empty((B, K, W), dtype=torch.float32, device=table.device)
    _launch("dpt_take_rows", "take_rows",
            (table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, T, K, W), table)
    return out


def advanced_2d(tiles, iy, ix, check_ranges: bool = True):
    """E4: ``out[b, k, j] = tiles[b, iy[b, k, j], ix[b, k, j]]`` for ``tiles
    (B, S, W)``, ``iy`` in ``[0, S)`` and ``ix`` in ``[0, W)``, both ``(B, K, W)``."""
    B, S, W = _dims3("advanced_2d", tiles)
    _check_tile("advanced_2d", B, S, W)
    K = iy.shape[1] if iy.dim() == 3 else 0
    if K < 1:
        raise ValueError(f"advanced_2d: iy and ix must be (B, K, W); got {tuple(iy.shape)}")
    on_card = _check_args("advanced_2d", [tiles], [iy, ix], [(B, S, W), (B, K, W), (B, K, W)])
    if check_ranges:
        _check_range("advanced_2d", "iy", iy, S - 1)
        _check_range("advanced_2d", "ix", ix, W - 1)
    if not on_card:
        return advanced_2d_plain(tiles, iy, ix)
    out = torch.empty((B, K, W), dtype=torch.float32, device=tiles.device)
    _launch("dpt_advanced_2d", "advanced_2d",
            (tiles.data_ptr(), iy.data_ptr(), ix.data_ptr(), out.data_ptr(), B, S, K, W), tiles)
    return out


def tile_gather(tiles, iy, ix, fy, fx, check_ranges: bool = True):
    """E5: per tile of ``tiles (n_tiles, TH, TW)`` and each of its ``cap``
    tasks ``iy, ix, fy, fx (n_tiles, cap)`` (``iy <= TH - 2``, ``ix <= TW - 2``)
    the bilinear value with d/dx and d/dy: ``(n_tiles, 4, cap)``."""
    n_tiles, TH, TW = _dims3("tile_gather", tiles)
    _check_tile("tile_gather", n_tiles, TH, TW)
    cap = iy.shape[1] if iy.dim() == 2 else 0
    if cap < 1 or TH < 2 or TW < 2:
        raise ValueError("tile_gather: tiles must be at least 2x2 and the tasks (n_tiles, cap); "
                         f"got {tuple(tiles.shape)}, {tuple(iy.shape)}")
    on_card = _check_args("tile_gather", [tiles, fy, fx], [iy, ix],
                          [(n_tiles, TH, TW)] + [(n_tiles, cap)] * 4)
    if check_ranges:
        _check_range("tile_gather", "iy", iy, TH - 2)
        _check_range("tile_gather", "ix", ix, TW - 2)
    if not on_card:
        return tile_gather_plain(tiles, iy, ix, fy, fx)
    out = torch.empty((n_tiles, 4, cap), dtype=torch.float32, device=tiles.device)
    _launch("dpt_tile_gather", "tile_gather",
            (tiles.data_ptr(), iy.data_ptr(), ix.data_ptr(), fy.data_ptr(), fx.data_ptr(),
             out.data_ptr(), n_tiles, TH, TW, cap), tiles)
    return out


def _rows2(name: str, r):
    if r.dim() != 2 or r.shape[1] < 2:
        raise ValueError(f"{name}: rows must be (n, W); got {tuple(r.shape)}")
    return tuple(r.shape)


def row_extract(r0, r1, lane, fx, fy, check_ranges: bool = True):
    """E6: lanes ``lane`` and ``lane + 1`` (``lane <= W - 2``) of the
    pre-gathered rows ``r0, r1 (n, W)`` blended by ``fy`` and ``fx``, all
    ``(n, 1)``: ``(n, 8)`` = value, ddx, ddy, 0..."""
    n, W = _rows2("row_extract", r0)
    on_card = _check_args("row_extract", [r0, r1, fx, fy], [lane], [(n, W)] * 2 + [(n, 1)] * 3, vector=0)
    if check_ranges:
        _check_range("row_extract", "lane", lane, W - 2)
    if not on_card:
        return row_extract_plain(r0, r1, lane, fx, fy)
    out = torch.empty((n, 8), dtype=torch.float32, device=r0.device)
    if n:  # the entry point launches nothing for zero observations
        _launch("dpt_row_extract", "row_extract",
                (r0.data_ptr(), r1.data_ptr(), lane.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                 out.data_ptr(), n, W), r0)
    return out


def row_extract_packed(ra, rb, la, lb, fxa, fya, fxb, fyb, zf, bx: int = BRICK_BX,
                       check_ranges: bool = True):
    """E7: both levels' brick rows ``ra, rb (n, W)`` with the 2x2 footprint at
    lanes ``l, l + 1, l + bx, l + bx + 1`` (``l <= W - bx - 2``), sampled
    bilinearly and blended by ``zf`` on level A, all scalars ``(n, 1)``:
    ``(n, 8)`` = value, ddx, ddy, dds, 0..."""
    n, W = _rows2("row_extract_packed", ra)
    if bx < 1 or W < bx + 2:
        raise ValueError(f"row_extract_packed: bx={bx} does not fit rows of {W}")
    on_card = _check_args("row_extract_packed", [ra, rb, fxa, fya, fxb, fyb, zf], [la, lb],
                          [(n, W)] * 2 + [(n, 1)] * 7, vector=0)
    if check_ranges:
        _check_range("row_extract_packed", "la", la, W - bx - 2)
        _check_range("row_extract_packed", "lb", lb, W - bx - 2)
    if not on_card:
        return row_extract_packed_plain(ra, rb, la, lb, fxa, fya, fxb, fyb, zf, bx)
    out = torch.empty((n, 8), dtype=torch.float32, device=ra.device)
    if n:
        from dataset_pipeline_tpu_torch import kernels

        _launch("dpt_row_extract_packed", "row_extract_packed",
                (ra.data_ptr(), rb.data_ptr(), la.data_ptr(), lb.data_ptr(), fxa.data_ptr(),
                 fya.data_ptr(), fxb.data_ptr(), fyb.data_ptr(), zf.data_ptr(), out.data_ptr(),
                 n, W, bx, kernels.persistent_grid("dpt_row_extract_packed_grid", ra.device)), ra)
    return out
