"""Gather probes, part 2: the row-gather sampler against the flat pyramid.

Counterpart of the JAX package's ``experiments/gather_probe2.py``, section by
section, under its JSON keys:

  (a) cost per gather against row width (8, 32, 128 floats from a 32 MB
      table), and two independent 128-wide gathers;
  (b) ``take_along_dim`` lane extraction from (n, 128) rows;
  (c) the lane-extract kernel (E6) against a float64 reference, then its rate;
  (d) the row sampler prototypes end to end: four row gathers + two E6 +
      blend, and the brick layout's two row gathers + E7;
  (e) ``argsort``;
  (f) the section the JAX script could not have: the brick path
      (``ops/brick.py``: table build, two row gathers, E7) against the flat
      pyramid sampler of the registrator (``ops/pyramid_sample.py``) on the
      same images, coordinates and scales, with the gap between their results.

Run: ``python -m dataset_pipeline_tpu_torch.experiments.gather_probe2
[--device cpu] [--n N] [--n_obs N] [--table_mb MB] [--sort_ns a,b]
[--brick_size WxH] [--brick_scales L] [--brick_images B] [--brick_obs N]``.
The default device ``cuda`` raises when CUDA is absent; a run on the CPU goes
through the kernels' plain versions and its rates are the host's. One JSON
line per result; a probe whose values are wrong ends the run with a non-zero
return. Rates are repeat slopes over 9 distinct arrays, as in part 1.
"""

from __future__ import annotations

import argparse
import sys

import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.experiments import (
    REPEATS,
    ProbeFailure,
    Report,
    device_line,
    dram_bytes_min,
    generator,
    ints,
    repeat_slope_s,
)
from dataset_pipeline_tpu_torch.experiments.gather_probe import SORT_NS, bench_argsort
from dataset_pipeline_tpu_torch.ops import brick, gather
from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps
from dataset_pipeline_tpu_torch.utils.timing import median_ms, wall_s

N_GATHERS = 4_000_000
N_OBS = 2_000_000
TABLE_MB = 32
CH = 2048  # the TPU kernels' block: observation counts are rounded down to it
EXTRACT_ATOL = 1e-5  # E6 against the float64 reference, as the JAX script
# the brick path against the flat sampler: the registrator's images
BRICK_SIZE, BRICK_SCALES, BRICK_IMAGES, BRICK_OBS = (3072, 2048), 5, 8, 1_600_000
BRICK_VALUE_TOL, BRICK_DERIV_TOL = 1e-4, 1e-3  # abs where ok, intensities up to 255


def _rand(g, shape, device):
    return torch.rand(shape, generator=g, device=device)


def _randint(g, hi: int, shape, device, dtype=torch.int32):
    return torch.randint(0, hi, shape, generator=g, device=device, dtype=dtype)


def _items(out: Report, label: str, dt: float, items: int, item: str, dram: int) -> None:
    out(bench=label, per_rep_s=dt, ns_per_item=dt / items * 1e9, mitems_per_s=items / dt / 1e6,
        item=item, dram_bytes_min=dram)


# (a) row width scaling ---------------------------------------------------------


def bench_row_widths(out: Report, device, g, n: int, table_bytes: int) -> None:
    for w in (8, 32, 128):
        t_rows = table_bytes // (w * 4)
        table = torch.randn((t_rows, w), generator=g, device=device)
        idxs = _randint(g, t_rows, (REPEATS, n), device)
        dt = repeat_slope_s(lambda i: table[idxs[i]], REPEATS, device)
        _items(out, f"row_gather_w{w}_{table_bytes >> 20}MB", dt, n, "gathers",
               dram_bytes_min(n * 4 + n * w * 4, table_bytes, n * w * 4))
        del table, idxs
    # two independent gathers, launched back to back
    t_rows = table_bytes // 512
    ta, tb = (torch.randn((t_rows, 128), generator=g, device=device) for _ in range(2))
    idxs = _randint(g, t_rows, (REPEATS, n), device)

    def dual(i):
        return ta[idxs[i]], tb[idxs[i]]

    dt = repeat_slope_s(dual, REPEATS, device)
    _items(out, "dual_row_gather_w128", dt, 2 * n, "gathers",
           dram_bytes_min(n * 4 + 2 * n * 512, 2 * table_bytes, 2 * n * 512))


# (b) take_along_dim lane extraction --------------------------------------------


def bench_take_along_lanes(out: Report, device, g, n: int) -> None:
    rows = torch.randn((n, 128), generator=g, device=device)
    lanes = _randint(g, 128, (REPEATS, n, 1), device, torch.int64)
    dt = repeat_slope_s(lambda i: torch.take_along_dim(rows, lanes[i], 1), REPEATS, device)
    _items(out, "take_along_lanes", dt, n, "extracts", dram_bytes_min(n * (8 + 32 + 4)))


# (c) the lane-extract kernel (E6) ----------------------------------------------


def ref_extract(r0, r1, lane, fx, fy):
    """Float64 value, ddx, ddy of the lane extraction, rows blended whole."""
    blend = r0.double() * (1 - fy.double()) + r1.double() * fy.double()
    diff = r1.double() - r0.double()
    ln = lane.long()
    l0, l1 = torch.gather(blend, 1, ln), torch.gather(blend, 1, ln + 1)
    d0, d1 = torch.gather(diff, 1, ln), torch.gather(diff, 1, ln + 1)
    fxd = fx.double()
    return (1 - fxd) * l0 + fxd * l1, l1 - l0, (1 - fxd) * d0 + fxd * d1


def check_extract(out: Report, device, g) -> None:
    n = CH * 2
    r0, r1 = (torch.randn((n, 128), generator=g, device=device) for _ in range(2))
    lane = _randint(g, 127, (n, 1), device)
    fx, fy = _rand(g, (n, 1), device), _rand(g, (n, 1), device)
    got = gather.row_extract(r0, r1, lane, fx, fy).double()
    ref = ref_extract(r0, r1, lane, fx, fy)
    gap = max(float((got[:, k:k + 1] - ref[k]).abs().max()) for k in range(3))
    ok = gap <= EXTRACT_ATOL and not bool(got[:, 3:].any())
    out(probe="lane_extract_correct", ok=ok, max_gap=gap)
    if not ok:
        raise ProbeFailure(f"row_extract: {gap:.3e} from the float64 reference > {EXTRACT_ATOL}")


def bench_extract(out: Report, device, g, n: int) -> None:
    r0, r1 = (torch.randn((n, 128), generator=g, device=device) for _ in range(2))
    lane = _randint(g, 127, (n, 1), device)
    fx = _rand(g, (n, 1), device)
    fys = _rand(g, (REPEATS, n, 1), device)
    gather.row_extract(r0, r1, lane, fx, fys[0])  # the lanes' range, checked once
    dt = repeat_slope_s(lambda i: gather.row_extract(r0, r1, lane, fx, fys[i], check_ranges=False),
                        REPEATS, device)
    # a sector of each row (an eighth of the lane pairs straddle two) + scalars + output
    _items(out, "lane_extract", dt, n, "obs", dram_bytes_min(n * (64 + 12 + 32)))


# (d) the sampler prototypes ----------------------------------------------------


def bench_sampler_protos(out: Report, device, g, n: int, table_bytes: int) -> None:
    t_rows = table_bytes // 512
    tab = torch.randn((t_rows, 128), generator=g, device=device)
    fxs = _rand(g, (REPEATS, n, 1), device)
    z = _rand(g, (n, 1), device)
    fy0 = _rand(g, (n, 1), device)

    # four row gathers (rows y and y+1 of two levels) + two E6 + blend
    r_idx0, r_idx1 = (_randint(g, t_rows - 1, (n,), device) for _ in range(2))
    lane0, lane1 = (_randint(g, 127, (n, 1), device) for _ in range(2))

    def proto(i):
        oa = gather.row_extract(tab[r_idx0], tab[r_idx0 + 1], lane0, fxs[i], fy0, check_ranges=False)
        ob = gather.row_extract(tab[r_idx1], tab[r_idx1 + 1], lane1, fxs[i], fy0, check_ranges=False)
        return oa * z + ob * (1.0 - z)

    gather.row_extract(tab[r_idx0], tab[r_idx0 + 1], lane0, fxs[0], fy0)
    gather.row_extract(tab[r_idx1], tab[r_idx1 + 1], lane1, fxs[0], fy0)
    dt = repeat_slope_s(proto, REPEATS, device)
    # per observation: two row indices, 4 rows written (and a sector of each
    # read back), the scalars, two (n, 8) outputs and their blend
    _items(out, "sampler_proto_2level", dt, n, "obs",
           dram_bytes_min(n * (8 + 4 * 512 + 24 + 3 * 32), table_bytes, 4 * n * 512))
    del r_idx0, r_idx1, lane0, lane1

    # the brick layout: the whole footprint in one row per level, two gathers + E7
    ra_idx, rb_idx = (_randint(g, t_rows, (n,), device) for _ in range(2))
    la, lb = (_randint(g, 94, (n, 1), device) for _ in range(2))
    fya, fyb = _rand(g, (n, 1), device), _rand(g, (n, 1), device)

    def packed(i):
        return gather.row_extract_packed(tab[ra_idx], tab[rb_idx], la, lb, fxs[i], fya, fxs[i],
                                         fyb, z, check_ranges=False)

    gather.row_extract_packed(tab[ra_idx], tab[rb_idx], la, lb, fxs[0], fya, fxs[0], fyb, z)
    dt = repeat_slope_s(packed, REPEATS, device)
    _items(out, "sampler_proto_packed", dt, n, "obs",
           dram_bytes_min(n * (8 + 2 * 512 + 28 + 32), table_bytes, 2 * n * 512))


# (f) the brick path against the flat pyramid -----------------------------------


def bench_brick_vs_flat(out: Report, device, g, size, scales: int, images: int, n_obs: int) -> None:
    """Both samplers on the same random images (2x2 box pyramids, as
    ``build_image_pyramid`` makes them), coordinates a few pixels beyond the
    border and scales over the whole pyramid."""
    W, H = size
    pyr = [torch.round(255 * _rand(g, (images, H, W), device))]
    for _ in range(1, scales):
        b, h, w = pyr[-1].shape
        pyr.append(pyr[-1][:, : h // 2 * 2, : w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2)
                   .mean((2, 4)))
    flat, layout = tps.flatten_pyramid(pyr)
    u = _rand(g, (images, n_obs, 2), device)
    pix = torch.stack([u[..., 0] * (W + 8) - 4, u[..., 1] * (H + 8) - 4], -1).contiguous()
    scale = (_rand(g, (images, n_obs), device) * (scales - 1)).contiguous()
    del u
    compare_brick_with_flat(out, device, pyr, flat, layout, pix, scale)


def compare_brick_with_flat(out: Report, device, pyr, flat, layout, pix, scale) -> dict:
    """Build each image's brick table, sample it (E7) and the flat pyramid
    (B3's sampler) at ``pix (B, n, 2)``, ``scale (B, n)``; report the stages'
    seconds over all images and the largest gaps where ok. Fails when ``ok``
    differs or a gap exceeds the tolerances."""
    images, n_obs = scale.shape
    L = layout.levels
    brick.build_brick_pyramid([p[0] for p in pyr])  # warm-up
    build_s, table_bytes, stages = 0.0, 0, {}
    gaps = {"value": 0.0, "dpx": 0.0, "dpy": 0.0, "ds": 0.0}
    # B3 reads the row-paired copy, built once per image chunk as the registrator does
    pairs = tps.pair_rows(flat, layout) if flat.is_cuda else None
    ref = tps.pyramid_sample(flat, layout, pix, scale, True, pairs)
    for b in range(images):
        made = []
        build_s += wall_s(lambda: made.append(brick.build_brick_pyramid([p[b] for p in pyr])),
                          device)
        table_bytes += made[0].table.numel() * 4
        if b == 0:  # warm the allocator for the chunked row tensors
            brick.brick_sample_with_derivs(made[0], L, pix[b], scale[b])
        got = brick.brick_sample_with_derivs(made[0], L, pix[b], scale[b], timings=stages)
        if not torch.equal(got[4], ref[4][b]):
            raise ProbeFailure(f"brick path: ok differs from the flat sampler in "
                               f"{int((got[4] != ref[4][b]).sum())} observations of image {b}")
        ok = got[4]
        for k, name in enumerate(gaps):
            if bool(ok.any()):
                gaps[name] = max(gaps[name], float((got[k] - ref[k][b])[ok].abs().max()))
        del made, got
    flat_s = 1e-3 * median_ms(lambda: tps.pyramid_sample(flat, layout, pix, scale, True, pairs),
                              device)
    brick_s = sum(stages.values())
    res = out(bench="brick_vs_flat", images=images, levels=L, obs=images * n_obs,
              pyramid_bytes=flat.numel() * 4, brick_table_bytes=table_bytes,
              table_build_s=build_s, brick_address_s=stages["brick_address"],
              row_gather_s=stages["row_gather"], extract_s=stages["extract"], brick_s=brick_s,
              flat_s=flat_s, ratio=brick_s / flat_s, ns_per_obs_brick=brick_s / (images * n_obs) * 1e9,
              ns_per_obs_flat=flat_s / (images * n_obs) * 1e9, max_gap=gaps, ok_equal=True)
    if gaps["value"] > BRICK_VALUE_TOL or max(gaps["dpx"], gaps["dpy"], gaps["ds"]) > BRICK_DERIV_TOL:
        raise ProbeFailure(f"brick path: gaps {gaps} to the flat sampler exceed "
                           f"{BRICK_VALUE_TOL} / {BRICK_DERIV_TOL}")
    return res


# ---------------------------------------------------------------------------


def main(argv=None, results: list | None = None) -> int:
    """Run the probes and print one JSON line per result; ``results``, if
    given, receives the same dicts. Returns non-zero when a probe failed."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' raises when CUDA is absent")
    p.add_argument("--n", type=int, default=N_GATHERS, help="row gathers per repeat in (a)")
    p.add_argument("--n_obs", type=int, default=N_OBS,
                   help=f"observations of (b)-(d), rounded down to a multiple of {CH}")
    p.add_argument("--table_mb", type=int, default=TABLE_MB, help="gather table size of (a), (d)")
    p.add_argument("--sort_ns", default=",".join(map(str, SORT_NS)))
    p.add_argument("--brick_size", default="x".join(map(str, BRICK_SIZE)), help="WxH of (f)'s images")
    p.add_argument("--brick_scales", type=int, default=BRICK_SCALES)
    p.add_argument("--brick_images", type=int, default=BRICK_IMAGES)
    p.add_argument("--brick_obs", type=int, default=BRICK_OBS, help="observations per image")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    out = Report(results)
    out(**device_line(device))
    g = generator(device, a.seed)
    n_obs = max(a.n_obs // CH, 1) * CH
    table_bytes = a.table_mb << 20
    try:
        bench_row_widths(out, device, g, a.n, table_bytes)
        bench_take_along_lanes(out, device, g, n_obs)
        check_extract(out, device, g)
        bench_extract(out, device, g, n_obs)
        bench_sampler_protos(out, device, g, n_obs, table_bytes)
        bench_argsort(out, device, g, ints(a.sort_ns),
                      ns_per_item=lambda nk, dt: dt / nk * 1e9,
                      mitems_per_s=lambda nk, dt: nk / dt / 1e6, item=lambda nk, dt: "keys")
        bench_brick_vs_flat(out, device, g, tuple(int(v) for v in a.brick_size.split("x")),
                            a.brick_scales, a.brick_images, a.brick_obs)
    except ProbeFailure as e:
        out(probe="failed", ok=False, err=str(e)[:300])
        return 1
    out(done=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
