"""ICP measurement path: the moment pass, the LM step, the schedule, the
card's read bandwidth, the engine's moment-vs-direct A/B and the kernel
variants. Prints ONE JSON line.

Counterpart of the ICP section of the JAX package's ``bench.py``
(``bench_icp_moments``, ``bench_hbm_copy_roofline``, ``bench_icp_engine_ab``)
with its key names. The schedule metric is additive by construction: one
moment pass, measured alone by the repeat slope of the alternating-copy
harness ``(T(R=65) - T(1)) / 64`` (median of 5 estimates with min and max)
and, independently, by CUDA events on the moment kernel itself (the two must
agree: that is what the harness is for), plus ``iters`` O(1) LM steps
measured by length differencing (20 against 220 steps of a carry-dependent
state). ``hbm_copy_gbps`` is a pure read under the same harness: a slope
above the card's stated peak would mean the harness, not the card.

Run: ``python -m dataset_pipeline_tpu_torch.tools.icp_bench [--device cpu]
[--m N] [--engine_ms 1000000,8000000,28000000]``; the default device
``cuda`` raises when CUDA is absent. A run on the CPU goes through the
kernels' plain versions and its times are the host's: the line names the
device it ran on.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from dataset_pipeline_tpu_torch import resolve_device
from dataset_pipeline_tpu_torch.icp.moments import (
    group_moments_on_device,
    hb_cost_from_moments_torch,
    pack_group_data,
)
from dataset_pipeline_tpu_torch.icp.point_to_plane import PointToPlaneICP
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.ops import gn
from dataset_pipeline_tpu_torch.ops.hbm import HBM_ROWS, hbm_read_sum
from dataset_pipeline_tpu_torch.utils.timing import median_ms, slope_s, wall_s

ICP_M = 8_000_000
ICP_ITERS = 20
REPEATS = 65  # R of the repeat slope
ENGINE_MS = (1_000_000, 8_000_000, 28_000_000)
CHUNK = 49152  # the engine's chunk
CHUNK48 = 16384  # the 48x48 kernel's default chunk
# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s; 67 TFLOP/s in
# float32 outside the tensor cores
H100_HBM_GBPS = 3350.0
H100_FP32_TFLOPS = 67.0


def _icp_problem(m: int, seed: int = 0):
    """Two correspondence groups (pair 0->1 and 1->0), as real ICP emits."""
    rng = np.random.RandomState(seed)
    half = m // 2
    groups = []
    for _ in range(2):
        ps = rng.randn(half, 3).astype(np.float32)
        ns = rng.randn(half, 3).astype(np.float32)
        ns /= np.linalg.norm(ns, axis=1, keepdims=True)
        pt = ps + 0.01 * rng.randn(half, 3).astype(np.float32)
        groups.append({"ps": ps, "ns": ns, "pt": pt, "nt": ns.copy(),
                       "w": np.ones(half, np.float32)})
    return groups, [(0, 1), (1, 0)]


def _wavy_correspondences(m: int, device):
    """Well-conditioned wavy-surface correspondences (so that the moment
    gate engages), both directions of one cloud pair, as device tensors."""
    rng = np.random.RandomState(0)
    half = m // 2
    xy = rng.uniform(-2, 2, (half, 2)).astype(np.float32)
    z = 0.3 * np.sin(2 * xy[:, 0]) * np.cos(1.7 * xy[:, 1])
    ps_h = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    dzdx = 0.6 * np.cos(2 * xy[:, 0]) * np.cos(1.7 * xy[:, 1])
    dzdy = -0.51 * np.sin(2 * xy[:, 0]) * np.sin(1.7 * xy[:, 1])
    n_h = np.stack([-dzdx, -dzdy, np.ones(half, np.float32)], -1)
    n_h /= np.linalg.norm(n_h, axis=1, keepdims=True)
    pt_h = ps_h + 0.01 * rng.randn(half, 3).astype(np.float32)
    ps_d, n_d, pt_d = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                       for a in (ps_h, n_h, pt_h))
    groups = [{"ps": ps_d, "ns": n_d, "pt": pt_d, "nt": n_d},
              {"ps": pt_d, "ns": n_d, "pt": ps_d, "nt": n_d}]
    return groups, [(0, 1), (1, 0)]


def bench_hbm_read(mp: int, R: int, device) -> dict:
    """Measured read bandwidth in GB/s: the bytes of one ``(8, mp)`` copy over
    the repeat slope of the read-and-sum kernel, timed as the moment pass."""
    g = torch.Generator(device=device).manual_seed(0)
    data2 = torch.randn((2, HBM_ROWS, mp), generator=g, device=device)
    out = hbm_read_sum(data2, 1)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("hbm_read_sum returned a non-finite sum")
    nbytes = HBM_ROWS * mp * 4
    dt = slope_s(lambda r: hbm_read_sum(data2, r), R, device)
    return {"hbm_copy_gbps": nbytes / dt / 1e9}


def _lm_step(P, pairs, q, t, C: int, damp):
    """One O(1) LM step from the moments: H, b, cost, the damped solve of
    the gauge-fixed system at lambda = 0.1 and the pose update."""
    H, b, cost = hb_cost_from_moments_torch(P, pairs, q, t, C)
    x = torch.linalg.solve_ex(H[6:, 6:] + damp, b[6:, None])[0][:, 0]
    delta = torch.cat([torch.zeros(6, dtype=x.dtype, device=x.device), -x]).reshape(C, 6)
    upd = SE3.exp(delta.to(torch.float32)).compose(SE3(q, t))
    return upd.q, upd.t, cost


def bench_icp_moments(m: int, iters: int, device, n_est: int = 5, R: int = REPEATS) -> dict:
    """The ICP headline: moment pass (repeat slope and events), LM step,
    additive schedule, read bandwidth."""
    groups, pairs = _icp_problem(m)
    C = 2
    data, gid = pack_group_data(groups, CHUNK, rows=13, device=device)
    pairs_dev = torch.as_tensor(pairs, device=device)
    q0 = torch.tensor([[1.0, 0, 0, 0]] * C, dtype=torch.float32, device=device)
    t0 = torch.zeros((C, 3), dtype=torch.float32, device=device)
    damp = 0.1 * torch.eye(6 * (C - 1), dtype=torch.float32, device=device)

    def moments():
        parts, per_chunk = gn.moment_gram_partials(data, CHUNK)
        return group_moments_on_device(parts, per_chunk, gid, len(groups))

    def lm_only(P, q, t, length: int):
        costs = []
        for _ in range(length):
            q, t, cost = _lm_step(P, pairs_dev, q, t, C, damp)
            costs.append(cost)
        return q, t, torch.stack(costs)

    # the schedule as the engine would run it: one pass, then the LM steps
    costs = lm_only(moments(), q0, t0, iters)[2]
    if not bool(torch.isfinite(costs).all()):
        raise RuntimeError(f"the schedule's costs are not finite: {costs.tolist()}")
    dispatch_s = wall_s(lambda: lm_only(moments(), q0, t0, iters), device)

    # (a) the moment pass: n_est independent repeat-slope estimates, and
    # events on the kernel itself, ten passes per reading (one pass alone is
    # shorter than its wrapper's host time, which the slope does not see)
    data2 = torch.stack([data, data])
    passes = [slope_s(lambda r: gn.moment_gram_repeat(data2, CHUNK, r), R, device, reps=1)
              for _ in range(n_est)]
    del data2
    pass_med, pass_min, pass_max = (float(f(passes)) for f in (np.median, np.min, np.max))
    event_s = 1e-3 * median_ms(lambda: gn.moment_gram_partials(data, CHUNK), device, inner=10)

    # (b) the LM step: length differencing with a carry-dependent state
    P = moments()
    L1, L2 = iters, iters + 200

    def lm_t(length):
        lm_only(P, q0, t0, length)
        return min(wall_s(lambda: lm_only(P, q0, t0 + 1e-7, length), device) for _ in range(2))

    lm_step_s = max((lm_t(L2) - lm_t(L1)) / (L2 - L1), 1e-12)

    nbytes = data.numel() * 4
    schedule_s = pass_med + iters * lm_step_s
    out = {
        "icp_moment_pass_s": pass_med,
        "icp_moment_pass_s_min": pass_min,
        "icp_moment_pass_s_max": pass_max,
        "icp_moment_pass_event_s": event_s,
        "icp_moment_pass_bytes": nbytes,
        "icp_lm_step_s": lm_step_s,
        "icp_schedule_s": schedule_s,
        "icp_schedule_dispatch_s": dispatch_s,
        "icp_schedule_final_cost": float(costs[-1]),
        "icp_gn_corr_iters_per_s": m * iters / schedule_s,
        "icp_gn_corr_iters_per_s_min": m * iters / (pass_max + iters * lm_step_s),
        "icp_gn_corr_iters_per_s_max": m * iters / (pass_min + iters * lm_step_s),
        "icp_moment_accum_corr_per_s": m / pass_med,
        "icp_moment_pass_gbps": nbytes / pass_med / 1e9,
        "icp_moment_pass_gbps_min": nbytes / pass_max / 1e9,
        "icp_moment_pass_gbps_max": nbytes / pass_min / 1e9,
    }
    del data, P
    # the read check sweeps 8 rows of the next power of two of columns
    # (8,388,608 at 8M correspondences: 268 MB per copy)
    out.update(bench_hbm_read(1 << math.ceil(math.log2(max(m, 4))), R, device))
    return out


def bench_icp_engine_ab(ms, iters: int, device, device_lm_m: int) -> dict:
    """The engine's inner LM on fixed correspondences, end to end through
    ``_inner_lm`` (every host round trip included): the gated moment
    accelerator + exact finisher against the direct path alone and, at
    ``device_lm_m`` correspondences, the whole LM on the device; each warmed
    once and timed once, at the engine's own threshold 1e-7. The pose gaps
    to the direct path are reported beside and, on the card, the timed run's
    launches of B1's two modes (full pass, cost batch)."""
    out = {}
    for m in ms:
        groups, pairs = _wavy_correspondences(m, device)
        tag = f"{m // 1_000_000}m"
        poses = {}
        variants = [("moment", {"use_moments": True}), ("direct", {"use_moments": False})]
        if m == device_lm_m:
            variants.append(("device_lm", {"use_device_lm": True}))
        for key, kw in variants:
            icp = PointToPlaneICP(device=device, **kw)
            result = []

            def run():
                result[:] = icp._inner_lm(groups, pairs, 2, iters, 1e-7)

            run()  # warm-up
            before = dict(gn.LAUNCHES)
            out[f"icp_engine_{key}_s_{tag}"] = wall_s(run, device)
            if device.type == "cuda":
                for mode, counter in (("full", "gn_fused"), ("batch", "gn_fused_cost_batch")):
                    out[f"icp_engine_{key}_b1_{mode}_{tag}"] = gn.LAUNCHES[counter] - before[counter]
            q, t, cost = result
            if not (np.isfinite(q).all() and np.isfinite(t).all() and math.isfinite(cost)):
                raise RuntimeError(f"engine {key} at {m}: non-finite result")
            poses[key] = np.concatenate([q.ravel(), t.ravel()])
            out[f"icp_engine_{key}_cost_{tag}"] = cost
        out[f"icp_engine_speedup_{tag}"] = (out[f"icp_engine_direct_s_{tag}"]
                                            / out[f"icp_engine_moment_s_{tag}"])
        for key in set(poses) - {"direct"}:
            out[f"icp_engine_{key}_pose_gap_{tag}"] = float(
                np.abs(poses[key] - poses["direct"]).max())
        del groups
    return out


def bench_kernel_variants(m: int, device) -> dict:
    """Median milliseconds of the kernel generations on one problem: fused
    H,b,cost against the row kernel (its plain prep pass apart), and the
    moment Gram against its 48x48 and per-third forms."""
    groups, pairs = _icp_problem(m)
    C = 2
    data, gid = pack_group_data(groups, CHUNK, rows=13, device=device)
    data16, _ = pack_group_data(groups, CHUNK48, rows=16, device=device)
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid], device=device)
    q = torch.tensor([[1.0, 0, 0, 0]] * C, dtype=torch.float32, device=device)
    t = torch.zeros((C, 3), dtype=torch.float32, device=device)
    flat = [torch.from_numpy(np.concatenate([g[k] for g in groups])).to(device)
            for k in ("ps", "ns", "pt", "nt", "w")]
    ids = [torch.from_numpy(np.repeat(np.asarray(col, np.int32), [len(g["ps"]) for g in groups]))
           .to(device) for col in zip(*pairs)]
    del groups
    rows = gn.gn_rows_prep(q, t, *flat[:4], *ids)
    out = {
        "gn_fused": median_ms(lambda: gn.icp_hb_cost_fused(q, t, data, cp, C, CHUNK), device),
        "gn_rows": median_ms(lambda: gn.gn_rows(*rows, *ids, flat[4], C), device),
        "gn_rows_prep": median_ms(lambda: gn.gn_rows_prep(q, t, *flat[:4], *ids), device),
        "moment_gram": median_ms(lambda: gn.moment_gram_partials(data, CHUNK), device),
        "moment_gram48": median_ms(lambda: gn.moment_gram48(data16, CHUNK48), device),
        "moment_gram_thirds": median_ms(lambda: gn.moment_gram_thirds(data, CHUNK), device),
    }
    # the generations compute one quantity: their costs and Gram totals agree
    costs = [float(gn.icp_hb_cost_fused(q, t, data, cp, C, CHUNK)[2]),
             float(gn.gn_rows(*rows, *ids, flat[4], C)[2])]
    totals = [float(x.double().sum()) for x in (gn.moment_gram_partials(data, CHUNK)[0],
                                                gn.moment_gram48(data16, CHUNK48),
                                                gn.moment_gram_thirds(data, CHUNK))]
    for name, vals in (("cost", costs), ("Gram total", totals)):
        if not all(math.isfinite(v) and abs(v - vals[0]) <= 1e-4 * abs(vals[0]) for v in vals):
            raise RuntimeError(f"kernel variants disagree on the {name}: {vals}")
    return out


def measure(m: int, engine_ms, device) -> dict:
    """Every measurement of the ICP path on ``device``, under ``bench.py``'s
    keys, with the shares of the card's published peaks on the card."""
    on_card = device.type == "cuda"
    out = {"device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "m": m, "iters": ICP_ITERS}
    out.update(bench_icp_moments(m, ICP_ITERS, device))
    out.update(bench_icp_engine_ab(engine_ms, ICP_ITERS, device, device_lm_m=m))
    out["kernel_variants_ms"] = bench_kernel_variants(m, device)
    if on_card:  # shares of the card's published peaks, unclipped
        out["hbm_copy_util_pct"] = 100.0 * out["hbm_copy_gbps"] / H100_HBM_GBPS
        out["icp_moment_pass_hbm_util_pct"] = 100.0 * out["icp_moment_pass_gbps"] / H100_HBM_GBPS
        out["icp_moment_pass_fp32_util_pct"] = (
            100.0 * gn.MOMENT_FLOPS_PER_ROW * out["icp_moment_pass_bytes"] / (4 * gn.PACKED_ROWS)
            / out["icp_moment_pass_s"] / (H100_FP32_TFLOPS * 1e12))
    return out


def main(argv=None, results: dict | None = None) -> int:
    """Run the measurements and print the JSON line; ``results``, if given,
    receives the same keys."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    p.add_argument("--m", type=int, default=ICP_M, help="correspondences of the headline")
    p.add_argument("--engine_ms", default=",".join(str(v) for v in ENGINE_MS),
                   help="comma-separated correspondence counts of the engine A/B; the "
                        "device LM is timed at the one equal to --m")
    args = p.parse_args(argv)
    out = measure(args.m, [int(v) for v in args.engine_ms.split(",") if v],
                  resolve_device(args.device))
    if results is not None:
        results.update(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
