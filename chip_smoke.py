#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``dataset_pipeline_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``dataset_pipeline_tpu_torch/csrc``
(nvcc, sm_90a) and the native gridder, then runs three paths of the port:

- ICP scan alignment: B1/B2 held against their plain PyTorch versions
  (float32 and float64) at the engine's shapes (~8M correspondences, chunk
  49152) and timed with CUDA events; a small scene CUDA vs CPU; then
  ``tools.icp_scan_aligner.main(..., "--device", "cuda")`` on two synthetic
  height-field scans of ~4M points each.
- Photometric image registration: B3 (``pyramid_sample``) against its plain
  version at the registrator's shapes (8 images x 3072x2048 x 5 scales,
  1.6M observations per image, both modes); a 640x480 scene through
  ``tools.image_registrator.main(..., "--device", dev)`` on CUDA and on the
  CPU; then the DSLR configuration (16 images of 3072x2048, a coloured scan
  of ~5.6M points, ~2.2M multi-resolution points) through the CLI at full
  resolution for 3 iterations.

- The ICP measurement path: B4a (``gn_rows``, C = 2 and C = 5, per-row
  cloud ids), B4b (``moment_gram48``), B4c (``moment_gram_thirds``), B5a
  (``moment_gram_repeat``, two different copies) and B5b (``hbm_read_sum``)
  against their plain versions at 8M correspondences / 8,388,608 columns;
  then ``tools.icp_bench.main(["--device", "cuda"])`` at full width (8M
  correspondences x 20 iterations, the engine A/B at 1M / 8M / 28M), whose
  JSON line is printed; then ``entry()``'s step on the card.

It fails (non-zero exit, no result line) if CUDA is absent, a kernel does
not build, launch or agree, a path did not launch each of its kernels, the
alignment does not remove the initial offset, the registration does not
lower the cost and the pose error, the engines of the A/B end at different
poses, the repeat slope and the event time of the moment pass disagree, or
the read bandwidth comes out above the card's stated peak. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit from nvidia-smi, and the one before that the per-kernel JSON.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ICP_KERNELS = ("gn_fused", "moment_gram")
REG_KERNELS = ("pyramid_sample_derivs", "pyramid_sample_value")
BENCH_KERNELS = ("gn_fused", "moment_gram", "gn_rows", "moment_gram48", "moment_gram_thirds",
                 "moment_gram_repeat", "hbm_read_sum")
ENGINE_CHUNK = 49152
CORR_TOTAL = 8_000_000
SCAN_POINTS = 4_000_000  # per scan: two scans give ~8M correspondences
B1_TOL = 1e-5  # max |kernel - float64 plain| / max |float64 plain|, H, b and cost
B2_TOL = 2e-5  # as tests/test_icp_moments.py: atol 2e-5 * max |P|
SMALL_SCENE_TOL = 1e-4  # .mlp entries, CUDA run vs CPU (plain) run
# B3 at the registrator's shapes (bench.py bench_registrator_dslr)
B3_IMAGES, B3_W, B3_H, B3_SCALES, B3_OBS = 8, 3072, 2048, 5, 1_600_000
B3_VALUE_TOL, B3_DERIV_TOL = 1e-4, 1e-3  # abs, kernel vs plain where ok
# registrator scenes: the CPU parity test's tolerances (test_torch_image_registrator.py)
REG_Q_TOL, REG_T_TOL, REG_PARAM_TOL, REG_COST_RTOL = 5e-7, 5e-7, 1e-3, 1e-4
REG_MIN_MOTION = 20  # each scale run moves every pose by >= 20x REG_Q_TOL / REG_T_TOL
DSLR_MIN_POINTS, DSLR_MIN_OBS = 1_500_000, 20_000_000
L2_BYTES = 50 * 2**20  # H100 L2
# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside
# the tensor cores; a kernel's bound is the larger of its bytes (each input
# read once, each output written once) and its operations over these
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12
B1_FLOPS = 240  # per correspondence: posing 66, residuals 14, crosses 18, the 28 sums 142
B4A_FLOPS = 364  # per correspondence: 2 products x 91 FMAs (13 non-zeros per column)
B4B_CHUNK = 16384
HBM_MP = 8_388_608
ENGINE_POSE_TOL = 1e-5  # moment / device-LM engines vs the direct engine, q and t
PASS_AGREE = 0.15  # repeat slope vs CUDA events on the moment pass
HBM_CEILING = 1.05  # measured read bandwidth over the stated peak, at most


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, torch, warmup: int = 3, reps: int = 15) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def synthetic_groups(torch, pairs, total: int, seed: int):
    """Correspondence groups in the engine's layout: points in a 4 m box,
    unit normals, targets a few mm from their sources, w = 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    per = total // len(pairs)
    groups = []
    for _ in pairs:
        ps = 4.0 * torch.rand((per, 3), generator=g, device="cuda") - 2.0
        ns = torch.nn.functional.normalize(torch.randn((per, 3), generator=g, device="cuda"), dim=1)
        pt = ps + 0.003 * torch.randn((per, 3), generator=g, device="cuda")
        nt = torch.nn.functional.normalize(
            ns + 0.05 * torch.randn((per, 3), generator=g, device="cuda"), dim=1)
        groups.append({"ps": ps, "ns": ns, "pt": pt, "nt": nt})
    return groups


def bound(nbytes: float, flops: float) -> dict:
    """The least milliseconds the card could take, and which limit gives it."""
    by, op = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bound_ms": 1e3 * max(by, op), "bound_by": "bytes" if by >= op else "operations"}


def check_b1(torch, gn, pack_group_data, se3_exp_np, C: int, seed: int):
    pairs = [(s, t) for s in range(C) for t in range(C) if s != t]
    groups = synthetic_groups(torch, pairs, CORR_TOTAL, seed)
    data, gid = pack_group_data(groups, ENGINE_CHUNK, rows=13, device="cuda")
    del groups
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid], device="cuda")
    rng = np.random.RandomState(seed)
    poses = [se3_exp_np(0.02 * rng.randn(6)) for _ in range(C)]
    q = torch.tensor(np.stack([p[0] for p in poses]), dtype=torch.float32, device="cuda")
    t = torch.tensor(np.stack([p[1] for p in poses]), dtype=torch.float32, device="cuda")

    def kernel():
        return gn.icp_hb_cost_fused(q, t, data, cp, C, ENGINE_CHUNK)

    def plain():
        return gn.gn_fused_plain(q, t, data, cp, C, ENGINE_CHUNK)

    k = [x.cpu().numpy() for x in kernel()]
    k2 = [x.cpu().numpy() for x in kernel()]
    if any(not np.array_equal(a, b) for a, b in zip(k, k2)):
        fail(f"B1 C={C}: two identical launches disagree (not deterministic)")
    p32 = [x.cpu().numpy() for x in plain()]
    p64 = [x.cpu().numpy() for x in gn.gn_fused_plain(
        q.double(), t.double(), data.double(), cp, C, ENGINE_CHUNK)]
    rel = {name: float(np.max(np.abs(k[i] - p64[i])) / max(np.max(np.abs(p64[i])), 1e-30))
           for i, name in enumerate(("H", "b", "cost"))}
    rel32 = float(np.max(np.abs(p32[0] - p64[0])) / np.max(np.abs(p64[0])))
    max_abs = float(max(np.max(np.abs(k[i] - p32[i])) for i in range(3)))
    if not all(np.isfinite(x).all() for x in k) or max(rel.values()) > B1_TOL:
        fail(f"B1 C={C}: kernel vs float64 plain {rel} > {B1_TOL}")
    ms = cuda_ms(kernel, torch)
    plain_ms = cuda_ms(plain, torch, warmup=1, reps=5)
    print(f"B1 gn_fused C={C} M={data.shape[1]} (chunk {ENGINE_CHUNK}): kernel vs f64 plain "
          f"rel H {rel['H']:.3e} b {rel['b']:.3e} cost {rel['cost']:.3e}; f32 plain vs f64 "
          f"rel H {rel32:.3e}; max|kernel - f32 plain| {max_abs:.3e}; max|H| "
          f"{np.max(np.abs(p64[0])):.3e}; kernel {ms:.4f} ms, f32 plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(data.numel() * 4, B1_FLOPS * data.shape[1]), "library_ms": None}


def check_b2(torch, gn, pack_group_data, compute_group_moments_from_packed, seed: int):
    pairs = [(0, 1), (1, 0)]
    groups = synthetic_groups(torch, pairs, CORR_TOTAL, seed)
    data, gid = pack_group_data(groups, ENGINE_CHUNK, rows=13, device="cuda")
    del groups
    P = compute_group_moments_from_packed(data, gid, len(pairs), ENGINE_CHUNK)
    P_again = compute_group_moments_from_packed(data, gid, len(pairs), ENGINE_CHUNK)
    if any(not np.array_equal(a, b) for a, b in zip(P, P_again)):
        fail("B2: two identical launches disagree (not deterministic)")
    p32 = gn.moment_gram_plain(data, ENGINE_CHUNK).double().cpu().numpy()
    p64 = gn.moment_gram_plain(data.double(), ENGINE_CHUNK).cpu().numpy()
    worst_max, worst_fro, worst32, max_abs = 0.0, 0.0, 0.0, 0.0
    for gi in range(len(pairs)):
        ref = p64[gid == gi].sum(0)
        ref32 = p32[gid == gi].sum(0)
        err = np.abs(P[gi] - ref)
        worst_max = max(worst_max, float(err.max() / np.abs(ref).max()))
        worst_fro = max(worst_fro, float(err.max() / np.linalg.norm(ref)))
        worst32 = max(worst32, float(np.abs(ref32 - ref).max() / np.linalg.norm(ref)))
        max_abs = max(max_abs, float(np.abs(P[gi] - ref32).max()))
        if not np.isfinite(P[gi]).all() or err.max() > B2_TOL * np.abs(ref).max():
            fail(f"B2 group {gi}: max err {err.max():.3e} > {B2_TOL} * max|P|")

    def kernel():
        return gn.moment_gram_partials(data, ENGINE_CHUNK)

    def plain():
        return gn.moment_gram_plain(data, ENGINE_CHUNK)

    ms = cuda_ms(kernel, torch)
    plain_ms = cuda_ms(plain, torch, warmup=1, reps=5)
    print(f"B2 moment_gram M={data.shape[1]} (chunk {ENGINE_CHUNK}): kernel vs f64 plain max err "
          f"{worst_max:.3e} of max|P|, {worst_fro:.3e} of ||P||_F (engine assumes noise "
          f"1e-7 ||P||_F); f32 plain vs f64 {worst32:.3e} of ||P||_F; max|kernel - f32 plain| "
          f"{max_abs:.3e}; kernel {ms:.4f} ms, f32 plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(data.numel() * 4 + kernel()[0].numel() * 4, gn.MOMENT_FLOPS_PER_ROW * data.shape[1]),
            "library_ms": None}


# ---------------------------------------------------------------------------
# The ICP measurement path: B4a, B4b, B4c, B5a, B5b and tools/icp_bench.py
# ---------------------------------------------------------------------------


def check_b4a(torch, gn, C: int, seed: int):
    """B4a against its plain version (float32 and float64) at 8M rows with
    random per-row cloud ids and weights in {0, 1} mixed with random ones."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    M = CORR_TOTAL
    j1, j2 = (torch.randn((6, M), generator=g, device="cuda") for _ in range(2))
    r1, r2 = (0.01 * torch.randn(M, generator=g, device="cuda") for _ in range(2))
    sid = torch.randint(0, C, (M,), generator=g, device="cuda", dtype=torch.int32)
    tid = ((sid + torch.randint(0, C, (M,), generator=g, device="cuda", dtype=torch.int32)) % C
           ).to(torch.int32)
    u = torch.rand((3, M), generator=g, device="cuda")
    w = torch.where(u[0] < 0.5, (u[1] > 0.2).float(), u[2])
    del u
    args = (j1, j2, r1, r2, sid, tid, w)
    k = [x.cpu().numpy() for x in gn.gn_rows(*args, C)]
    k2 = [x.cpu().numpy() for x in gn.gn_rows(*args, C)]
    if any(not np.array_equal(a, b) for a, b in zip(k, k2)):
        fail(f"B4a C={C}: two identical launches disagree (not deterministic)")
    p32 = [x.cpu().numpy() for x in gn.gn_rows_plain(*args, C)]
    p64 = [x.cpu().numpy() for x in gn.gn_rows_plain(
        *[a.double() if a.is_floating_point() else a for a in args], C)]
    rel = {name: float(np.max(np.abs(k[i] - p64[i])) / max(np.max(np.abs(p64[i])), 1e-30))
           for i, name in enumerate(("H", "b", "cost"))}
    max_abs = float(max(np.max(np.abs(k[i] - p32[i])) for i in range(3)))
    if not all(np.isfinite(x).all() for x in k) or max(rel.values()) > B1_TOL:
        fail(f"B4a C={C}: kernel vs float64 plain {rel} > {B1_TOL}")
    ms = cuda_ms(lambda: gn.gn_rows(*args, C), torch)
    plain_ms = cuda_ms(lambda: gn.gn_rows_plain(*args, C), torch, warmup=1, reps=5)
    S = 6 * C + 1
    # a column of A1 / A2 has 13 non-zeros (two 6-row blocks and the residual)
    # whatever C is: 2 x 91 FMAs per row fill the upper triangle of both products
    b = bound(68 * M + 8 * S * S, B4A_FLOPS * M)
    print(f"B4a gn_rows C={C} M={M} (per-row ids): kernel vs f64 plain rel H {rel['H']:.3e} "
          f"b {rel['b']:.3e} cost {rel['cost']:.3e}; max|kernel - f32 plain| {max_abs:.3e}; "
          f"kernel {ms:.4f} ms, f32 plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}


def gram_check(name, got, ref64, ref32):
    """Max error of a stack of Grams against the float64 plain version, as
    a share of max|P| (must stay under B2_TOL), and against the float32 one."""
    got = got.double()
    scale = float(ref64.abs().max())
    err = float((got - ref64).abs().max())
    if not bool(got.isfinite().all()) or err > B2_TOL * scale:
        fail(f"{name}: max err {err:.3e} > {B2_TOL} * max|P| = {B2_TOL * scale:.3e}")
    return err / scale, float((got - ref32.double()).abs().max())


def check_moment_variants(torch, gn, pack_group_data, seed: int):
    """B4b (one zero-padded (48,48) part per chunk of 16384, 16-row input),
    B4c (per-third Grams, chunk 49152) and B5a (two different copies, R = 5)
    against their plain versions at ~8M correspondences."""
    pairs = [(0, 1), (1, 0)]
    groups = synthetic_groups(torch, pairs, CORR_TOTAL, seed)
    out = {}

    # B4b
    data16, _ = pack_group_data(groups, B4B_CHUNK, rows=16, device="cuda")
    k = gn.moment_gram48(data16, B4B_CHUNK)
    if not torch.equal(k, gn.moment_gram48(data16, B4B_CHUNK)):
        fail("B4b: two identical launches disagree (not deterministic)")
    if bool(k[:, 42:, :].any()) or bool(k[:, :, 42:].any()):
        fail("B4b: rows or columns 42..47 are not exactly zero")
    p32 = gn.moment_gram48_plain(data16, B4B_CHUNK)
    rel, max_abs = gram_check("B4b", k, gn.moment_gram48_plain(data16.double(), B4B_CHUNK), p32)
    ms = cuda_ms(lambda: gn.moment_gram48(data16, B4B_CHUNK), torch)
    plain_ms = cuda_ms(lambda: gn.moment_gram48_plain(data16, B4B_CHUNK), torch, warmup=1, reps=5)
    Mp = data16.shape[1]
    out["moment_gram48"] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                            **bound(52 * Mp + k.numel() * 4, gn.MOMENT_FLOPS_PER_ROW * Mp), "library_ms": None}
    print(f"B4b moment_gram48 M={Mp} (chunk {B4B_CHUNK}, 16 rows): kernel vs f64 plain max err "
          f"{rel:.3e} of max|P|; pad rows zero; max|kernel - f32 plain| {max_abs:.3e}; kernel "
          f"{ms:.4f} ms, f32 plain {plain_ms:.4f} ms")
    del data16, k, p32

    # B4c
    data, _ = pack_group_data(groups, ENGINE_CHUNK, rows=13, device="cuda")
    k = gn.moment_gram_thirds(data, ENGINE_CHUNK)
    if not torch.equal(k, gn.moment_gram_thirds(data, ENGINE_CHUNK)):
        fail("B4c: two identical launches disagree (not deterministic)")
    p32 = gn.moment_gram_thirds_plain(data, ENGINE_CHUNK)
    rel, max_abs = gram_check("B4c", k, gn.moment_gram_thirds_plain(data.double(), ENGINE_CHUNK), p32)
    ms = cuda_ms(lambda: gn.moment_gram_thirds(data, ENGINE_CHUNK), torch)
    plain_ms = cuda_ms(lambda: gn.moment_gram_thirds_plain(data, ENGINE_CHUNK), torch,
                       warmup=1, reps=5)
    Mp = data.shape[1]
    out["moment_gram_thirds"] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                                 **bound(52 * Mp + k.numel() * 4, gn.MOMENT_FLOPS_PER_ROW * Mp),
                                 "library_ms": None}
    print(f"B4c moment_gram_thirds M={Mp} (chunk {ENGINE_CHUNK}, per third): kernel vs f64 plain "
          f"max err {rel:.3e} of max|P|; max|kernel - f32 plain| {max_abs:.3e}; kernel {ms:.4f} ms, "
          f"f32 plain {plain_ms:.4f} ms")
    del k, p32

    # B5a: a second, different copy
    other, _ = pack_group_data(synthetic_groups(torch, pairs, CORR_TOTAL, seed + 100),
                               ENGINE_CHUNK, rows=13, device="cuda")
    data2 = torch.stack([data, other])
    del groups, data, other
    k, per_chunk = gn.moment_gram_repeat(data2, ENGINE_CHUNK, 5)
    if not torch.equal(k, gn.moment_gram_repeat(data2, ENGINE_CHUNK, 5)[0]):
        fail("B5a: two identical launches disagree (not deterministic)")
    k = k.reshape(-1, per_chunk, 42, 42)
    ref64 = (3 * gn.moment_gram_plain(data2[0].double(), ENGINE_CHUNK)
             + 2 * gn.moment_gram_plain(data2[1].double(), ENGINE_CHUNK))
    p32 = gn.moment_gram_repeat_plain(data2, ENGINE_CHUNK, 5)
    rel, max_abs = gram_check("B5a", k.double().sum(1), ref64, p32)
    one, _ = gn.moment_gram_repeat(data2, ENGINE_CHUNK, 1)
    if not torch.equal(one, gn.moment_gram_partials(data2[0], ENGINE_CHUNK)[0]):
        fail("B5a: one repeat differs from the B2 kernel on the same copy")
    ms = cuda_ms(lambda: gn.moment_gram_repeat(data2, ENGINE_CHUNK, 1), torch)
    ms5 = cuda_ms(lambda: gn.moment_gram_repeat(data2, ENGINE_CHUNK, 5), torch)
    plain_ms = cuda_ms(lambda: gn.moment_gram_repeat_plain(data2, ENGINE_CHUNK, 1), torch,
                       warmup=1, reps=5)
    Mp = data2.shape[2]
    out["moment_gram_repeat"] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                                 **bound(52 * Mp + one.numel() * 4, gn.MOMENT_FLOPS_PER_ROW * Mp),
                                 "library_ms": None}
    print(f"B5a moment_gram_repeat M={Mp} (two different copies): R=5 vs 3 Gram(copy0) + "
          f"2 Gram(copy1) in f64 max err {rel:.3e} of max; max|kernel - f32 plain| {max_abs:.3e}; "
          f"R=1 bitwise the B2 kernel; R=1 {ms:.4f} ms, R=5 {ms5:.4f} ms "
          f"({(ms5 - ms) / 4:.4f} ms per further repeat), f32 plain (R=1) {plain_ms:.4f} ms")
    return out


def check_b5b(torch, hbm, seed: int):
    """B5b against the float64 sum at R = 1 and R = 3; the one PyTorch call
    with the same function, ``data2[0].sum(1)``, is timed beside it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    data2 = torch.randn((2, 8, HBM_MP), generator=g, device="cuda")
    rel = 0.0
    for R in (1, 3):
        k = hbm.hbm_read_sum(data2, R)
        if not torch.equal(k, hbm.hbm_read_sum(data2, R)):
            fail(f"B5b R={R}: two identical launches disagree (not deterministic)")
        ref = hbm.hbm_read_sum_plain(data2.double(), R)
        rel = max(rel, float((k.double() - ref).abs().max() / ref.abs().max()))
        if not bool(k.isfinite().all()) or rel > 1e-5:
            fail(f"B5b R={R}: kernel vs float64 sum {rel:.3e} > 1e-5 of max|sum|")
    one = hbm.hbm_read_sum(data2, 1)
    max_abs = float((one - hbm.hbm_read_sum_plain(data2, 1)).abs().max())
    ms = cuda_ms(lambda: hbm.hbm_read_sum(data2, 1), torch)
    many = 17  # enough further repeats to hide the first launch's latency
    ms_many = cuda_ms(lambda: hbm.hbm_read_sum(data2, many), torch)
    per_repeat = (ms_many - ms) / (many - 1)
    plain_ms = cuda_ms(lambda: hbm.hbm_read_sum_plain(data2, 1), torch, warmup=1, reps=5)
    library_ms = cuda_ms(lambda: data2[0].sum(1), torch)
    nbytes = 8 * HBM_MP * 4
    b = bound(nbytes + 32, 8 * HBM_MP)
    if nbytes / (1e-3 * per_repeat) > HBM_CEILING * HBM_BYTES_PER_S:
        fail(f"B5b: {nbytes / per_repeat / 1e6:.1f} GB/s per further repeat reads above "
             f"{HBM_CEILING} x the card's stated peak: the repeats are served from L2")
    print(f"B5b hbm_read_sum mp={HBM_MP} ({nbytes / 1e6:.0f} MB per pass): kernel vs f64 sum "
          f"{rel:.3e} of max|sum|; R=1 {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s with the final "
          f"sum), R={many} {ms_many:.4f} ms ({per_repeat:.4f} ms per further repeat = "
          f"{nbytes / per_repeat / 1e6:.1f} GB/s); plain {plain_ms:.4f} ms; data2[0].sum(1) "
          f"{library_ms:.4f} ms ({nbytes / library_ms / 1e6:.1f} GB/s); bound {b['bound_ms']:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}


def run_icp_bench(torch, kernels, icp_bench, entry):
    """The ICP measurement path at full width through the tool's ``main``,
    then ``entry()``'s step; returns the tool's results and the launches."""
    res = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = icp_bench.main(["--device", "cuda"], results=res)  # prints its JSON line
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in BENCH_KERNELS}
    if rc != 0:
        fail(f"icp_bench returned {rc}")
    print(f"icp_bench: {wall:.1f} s; launches {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"the ICP measurement path never launched kernel {k}")
    flat = {**{k: v for k, v in res.items() if not isinstance(v, (dict, str))},
            **res["kernel_variants_ms"]}
    bad = [k for k, v in flat.items() if not np.isfinite(v)]
    if bad:
        fail(f"icp_bench: non-finite values for {bad}")
    for key, tag in (("moment", "1m"), ("moment", "8m"), ("moment", "28m"), ("device_lm", "8m")):
        gap = res[f"icp_engine_{key}_pose_gap_{tag}"]
        if not gap <= ENGINE_POSE_TOL:
            fail(f"icp_bench: the {key} engine ends {gap:.3e} from the direct engine at "
                 f"{tag} > {ENGINE_POSE_TOL}")
    slope, event = res["icp_moment_pass_s"], res["icp_moment_pass_event_s"]
    if abs(slope - event) > PASS_AGREE * event:
        fail(f"icp_bench: the moment pass by repeat slope {slope * 1e3:.4f} ms and by CUDA "
             f"events {event * 1e3:.4f} ms differ by more than {PASS_AGREE:.0%}")
    if not res["hbm_copy_gbps"] <= HBM_CEILING * HBM_BYTES_PER_S / 1e9:
        fail(f"icp_bench: hbm_copy_gbps {res['hbm_copy_gbps']:.1f} reads above {HBM_CEILING} x "
             "the card's stated peak: the harness is served from L2")
    print(f"icp_bench: moment pass {slope * 1e3:.4f} ms by repeat slope, {event * 1e3:.4f} ms by "
          f"events; read bandwidth {res['hbm_copy_gbps']:.1f} GB/s by the repeat slope "
          f"({res['hbm_copy_gbps'] / (HBM_BYTES_PER_S / 1e9):.1%} of the stated peak); engine "
          + "; ".join(f"{tag}: moment {res[f'icp_engine_moment_s_{tag}']:.4f} s, direct "
                      f"{res[f'icp_engine_direct_s_{tag}']:.4f} s" for tag in ("1m", "8m", "28m"))
          + f"; device LM at 8m {res['icp_engine_device_lm_s_8m']:.4f} s")

    fn, args = entry.entry()
    if any(a.device.type != "cuda" for a in args):
        fail("entry(): the example arguments are not on the card")
    H, b, cost = fn(*args)
    torch.cuda.synchronize()
    if not (H.shape == (12, 12) and b.shape == (12,) and bool(H.isfinite().all())
            and bool(b.isfinite().all()) and bool(cost.isfinite()) and float(cost) > 0):
        fail("entry(): the step's H, b, cost are not finite of the expected shape")
    print(f"entry(): H (12,12), b (12,), cost {float(cost):.6f} on {H.device}")
    return res, launches


def height(x, y):
    return 0.15 * np.sin(1.3 * x) * np.cos(1.1 * y) + 0.04 * np.sin(4.1 * x + 2.3 * y)


def write_scene(root: str, n: int, seed: int, offset, write_ply, PointCloud,
                MeshInfo, write_meshlab_project):
    """Two independent samplings of one 4 m x 4 m height field; scan 1's
    .mlp pose carries ``offset`` (its true pose is the identity)."""
    rng = np.random.RandomState(seed)
    for i in range(2):
        xy = (4.0 * rng.rand(n, 2)).astype(np.float32)
        z = height(xy[:, 0].astype(np.float64), xy[:, 1].astype(np.float64))
        pts = np.concatenate([xy, z[:, None].astype(np.float32)], 1)
        write_ply(os.path.join(root, f"scan{i}.ply"), PointCloud(pts))
    M1 = np.eye(4)
    M1[:3, 3] = offset
    write_meshlab_project(os.path.join(root, "in.mlp"),
                          [MeshInfo("scan0", "scan0.ply", np.eye(4)),
                           MeshInfo("scan1", "scan1.ply", M1)])


# ---------------------------------------------------------------------------
# Photometric registration: B3 and the registrator CLI
# ---------------------------------------------------------------------------


def check_b3(torch, tps, seed: int):
    """B3 against its plain version (float32 and float64) at the
    registrator's shapes, both modes; CUDA-event times of kernel and plain."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb, H, W, n = B3_IMAGES, B3_H, B3_W, B3_OBS
    pyr = [torch.round(255 * torch.rand((nb, H, W), generator=g, device="cuda"))]
    for _ in range(1, B3_SCALES):  # as build_image_pyramid: 2x2 box means
        b, h, w = pyr[-1].shape
        pyr.append(pyr[-1][:, : h // 2 * 2, : w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2)
                   .mean((2, 4)))
    flat, layout = tps.flatten_pyramid(pyr)
    del pyr
    u = torch.rand((nb, n, 2), generator=g, device="cuda")
    pix = torch.stack([u[..., 0] * (W + 8) - 4, u[..., 1] * (H + 8) - 4], -1).contiguous()
    scale = (torch.rand((nb, n), generator=g, device="cuda") * (B3_SCALES - 1)).contiguous()
    sectors = tap_sectors(torch, layout, pix, scale)
    out = {}
    for derivs in (True, False):
        mode = "derivs" if derivs else "value"
        k = tps.pyramid_sample(flat, layout, pix, scale, derivs)
        k2 = tps.pyramid_sample(flat, layout, pix, scale, derivs)
        if any(not torch.equal(a, b) for a, b in zip(k, k2)):
            fail(f"B3 {mode}: two identical launches disagree (not deterministic)")
        p32 = tps.sample_plain(flat, layout, pix, scale, derivs)
        p64 = tps.sample_plain(flat.double(), layout, pix.double(), scale.double(), derivs)
        for ref, tag in ((p32, "f32"), (p64, "f64")):
            if not torch.equal(k[-1], ref[-1]):
                fail(f"B3 {mode}: ok differs from the {tag} plain version in "
                     f"{int((k[-1] != ref[-1]).sum())} observations")
        ok = k[-1]
        errs = {}
        for i, name in enumerate(("value", "dpx", "dpy", "ds")[:len(k) - 1]):
            tol = B3_VALUE_TOL if name == "value" else B3_DERIV_TOL
            e32 = float((k[i] - p32[i])[ok].abs().max())
            e64 = float((k[i].double() - p64[i])[ok].abs().max())
            errs[name] = (e32, e64)
            if not (e32 <= tol and e64 <= tol):
                fail(f"B3 {mode} {name}: |kernel - plain| f32 {e32:.3e} f64 {e64:.3e} > {tol}")
        ms = cuda_ms(lambda: tps.pyramid_sample(flat, layout, pix, scale, derivs), torch)
        plain_ms = cuda_ms(lambda: tps.sample_plain(flat, layout, pix, scale, derivs), torch,
                           warmup=1, reps=5)
        obs = nb * n
        streamed = obs * (8 + 4 + (16 if derivs else 4) + 1)  # pix, scale, outputs, ok
        lo = max(sectors["distinct"] * 32 - L2_BYTES, 0) + streamed
        hi = sectors["requests"] * 32 + streamed
        print(f"B3 pyramid_sample {mode}: {nb} images x {W}x{H} x {B3_SCALES} scales "
              f"({flat.numel() * 4 / 1e6:.0f} MB), {obs} observations, ok {float(ok.float().mean()):.3f}; "
              + ", ".join(f"{k_} |k-f32| {a:.3e} |k-f64| {b:.3e}" for k_, (a, b) in errs.items())
              + f"; kernel {ms:.4f} ms, f32 plain {plain_ms:.4f} ms; taps touch "
              f"{sectors['requests'] / obs:.3f} sectors/obs, {sectors['distinct']} distinct "
              f"sectors; bytes from the inputs: >= {lo / 1e9:.3f} GB from DRAM (distinct "
              f"sectors - L2 + streamed) -> >= {lo / ms / 1e6:.1f} GB/s; <= {hi / 1e9:.3f} GB "
              f"if every sector request missed L2 -> {hi / ms / 1e6:.1f} GB/s")
        # the bound counts what these inputs need: every distinct sector once
        out[mode] = {"max_abs_err": max(a for a, _ in errs.values()), "ms": ms,
                     "plain_ms": plain_ms,
                     **bound(sectors["distinct"] * 32 + streamed, 100 * obs), "library_ms": None}
    return out


def tap_sectors(torch, layout, pix, scale):
    """The 32-byte sectors the kernel's taps read (its addressing: 2 rows x
    2 columns in each of the 2 bracketing levels): the sum over
    observations of each one's distinct sectors (``requests``), and the
    distinct sectors over the launch (``distinct``), each of which DRAM
    must deliver at least once, less what L2 holds from before."""
    nb, n = scale.shape
    dev = pix.device
    L = layout.levels
    si = torch.clamp(torch.floor(scale) + 1, 1, L - 1).long()
    hs, ws, offs = (torch.tensor(v, device=dev) for v in (layout.hs, layout.ws, layout.offs))
    img = torch.arange(nb, device=dev)[:, None] * layout.total
    ids = []
    for lvl in (si, si - 1):
        f = torch.pow(2.0, -lvl.float())
        W, H = ws[lvl], hs[lvl]
        ix = torch.minimum(torch.clamp(torch.floor(f * (pix[..., 0] + 0.5) - 0.5), min=0), W - 2)
        iy = torch.minimum(torch.clamp(torch.floor(f * (pix[..., 1] + 0.5) - 0.5), min=0), H - 2)
        base = img + offs[lvl] + iy.long() * W + ix.long()
        for row in (base, base + W):
            ids += [row // 8, (row + 1) // 8]  # 8 floats per sector
    S = torch.stack(ids, -1).sort(-1).values
    requests = int(S.shape[-1] * S[..., 0].numel() - (S[..., 1:] == S[..., :-1]).sum())
    distinct = int(torch.unique(S).numel())
    return {"requests": requests, "distinct": distinct}


def pose_errors(state_dir: str, truth_q, truth_t, cio, quat_to_matrix_np):
    """Per image: displacement (m) of the point 5 m ahead of the camera,
    between the state's pose and the true one."""
    model = cio.read_model(state_dir)
    p = np.asarray([0.0, 0.0, 5.0])
    errs = []
    for iid in sorted(model.images):
        im = model.images[iid]
        R, Rt = quat_to_matrix_np(im.qvec), quat_to_matrix_np(truth_q[iid - 1])
        errs.append(np.linalg.norm(R.T @ (p - im.tvec) - Rt.T @ (p - truth_t[iid - 1])))
    return np.asarray(errs)


def registrator_args(root: str, out: str, dev: str, extra=()):
    return ["--scan_alignment_path", os.path.join(root, "scene.mlp"),
            "--image_base_path", os.path.join(root, "images"),
            "--state_path", os.path.join(root, "state"), "--output_folder_path", out,
            "--max_iterations", "3", "--device", dev, *extra]


def compare_registrator_states(a_dir: str, b_dir: str, init_dir: str, cio):
    """Max gaps (qvec, tvec, camera params, relative optimum cost) of two
    runs' ``scale_*_state`` dirs, and the least per-scale pose motion (qvec,
    tvec) of run a's images from the state before that scale."""
    gaps = [0.0, 0.0, 0.0, 0.0]
    motion = [float("inf"), float("inf")]
    prev = cio.read_model(init_dir)
    scales = sorted(d for d in os.listdir(a_dir) if d.startswith("scale_"))
    for d in scales:
        a, b = cio.read_model(os.path.join(a_dir, d)), cio.read_model(os.path.join(b_dir, d))
        for i in a.images:
            motion[0] = min(motion[0], float(np.abs(a.images[i].qvec - prev.images[i].qvec).max()))
            motion[1] = min(motion[1], float(np.abs(a.images[i].tvec - prev.images[i].tvec).max()))
        prev = a
        gaps[0] = max([gaps[0]] + [float(np.abs(a.images[i].qvec - b.images[i].qvec).max())
                                   for i in a.images])
        gaps[1] = max([gaps[1]] + [float(np.abs(a.images[i].tvec - b.images[i].tvec).max())
                                   for i in a.images])
        gaps[2] = max([gaps[2]] + [float(np.abs(a.cameras[c].params - b.cameras[c].params).max())
                                   for c in a.cameras])
        ca, cb = (float(dict(ln.split(" ", 1) for ln in open(os.path.join(x, d, "metadata.txt"))
                             .read().splitlines())["optimum_cost"]) for x in (a_dir, b_dir))
        gaps[3] = max(gaps[3], abs(ca - cb) / abs(ca))
    return scales, gaps, motion


def check_registrator_small(torch, image_registrator, write_scene, cio, root: str):
    """The 640x480 two-image scene of the CPU parity test through the CLI on
    CUDA and on the CPU (plain versions): the same tolerances."""
    write_scene(root, 640, 480, 2800.0 * 640 / 3072, 2, 40_000, seed=3, device="cuda")
    for dev in ("cuda", "cpu"):
        if image_registrator.main(registrator_args(root, os.path.join(root, dev), dev)) != 0:
            fail(f"small registrator scene on {dev} failed")
    scales, (dq, dt, dp, dc), (mq, mt) = compare_registrator_states(
        os.path.join(root, "cuda"), os.path.join(root, "cpu"), os.path.join(root, "state"), cio)
    print(f"small registrator scene (2 x 640x480, {scales}): CUDA vs CPU qvec {dq:.3e} "
          f"tvec {dt:.3e} params {dp:.3e} px, optimum cost rel {dc:.3e}; least per-scale pose "
          f"motion qvec {mq:.3e} tvec {mt:.3e}")
    if not (dq <= REG_Q_TOL and dt <= REG_T_TOL and dp <= REG_PARAM_TOL and dc <= REG_COST_RTOL):
        fail("small registrator scene: CUDA and CPU runs differ beyond the tolerances")
    if not (mq > REG_MIN_MOTION * REG_Q_TOL and mt > REG_MIN_MOTION * REG_T_TOL):
        fail("small registrator scene: a scale run left a pose (nearly) unchanged")


def run_registrator_dslr(torch, kernels, image_registrator, synthetic, cio, quat_to_matrix_np,
                         root: str):
    """The DSLR configuration through the CLI at full resolution."""
    t0 = time.perf_counter()
    c = synthetic.DSLR
    n_scan, tq, tt = synthetic.write_scene_at_density(
        root, c["width"], c["height"], c["f"], c["n_images"], c["baseline"], c["scan_density"],
        seed=5, device="cuda")
    print(f"DSLR scene: {c['n_images']} images {c['width']}x{c['height']}, scan {n_scan} points, "
          f"written in {time.perf_counter() - t0:.1f} s")
    before = pose_errors(os.path.join(root, "state"), tq, tt, cio, quat_to_matrix_np)
    out = os.path.join(root, "out")
    timings, stats = {}, {}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = image_registrator.main(registrator_args(
        root, out, "cuda", ["--initial_scaling_factor", "1", "--target_scaling_factor", "1",
                            "--merge_distance_factor", str(c["merge_distance_factor"])]),
        timings=timings, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in REG_KERNELS}
    if rc != 0:
        fail(f"image_registrator returned {rc}")
    after = pose_errors(os.path.join(out, "scale_1_state"), tq, tt, cio, quat_to_matrix_np)
    sc = stats["scales"][-1]
    tj = json.load(open(os.path.join(out, "timing.json")))
    opt_s = tj["optimize_scale_0"]["total_s"]
    obs = sc["observations"]
    print("DSLR stages (s): " + ", ".join(f"{k} {v['total_s']:.3f}" for k, v in tj.items())
          + "; optimizer: " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
          + f"; wall {wall:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"DSLR: levels {stats['levels']} ({sum(stats['levels'])} points); observations per "
          f"iteration {obs}; {opt_s / sc['iterations']:.3f} s/iteration, "
          f"{sum(obs) / opt_s:.4g} observations/s; costs {sc['iteration_costs']} -> optimum "
          f"{sc['optimum_cost']:.6f}; pose error (mm at 5 m) mean {1e3 * before.mean():.3f} -> "
          f"{1e3 * after.mean():.3f}; launches {launches}")
    if sum(stats["levels"]) < DSLR_MIN_POINTS:
        fail(f"DSLR: {sum(stats['levels'])} points survive < {DSLR_MIN_POINTS}")
    if min(obs) < DSLR_MIN_OBS:
        fail(f"DSLR: {min(obs)} observations in an iteration < {DSLR_MIN_OBS}")
    if not sc["optimum_cost"] < sc["iteration_costs"][0]:
        fail("DSLR: the optimum cost is not below the first iteration's")
    if not after.mean() < before.mean():
        fail("DSLR: the mean pose error did not drop")
    for k, v in launches.items():
        if v <= 0:
            fail(f"the registrator's main path never launched kernel {k}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs the GPU")
    try:
        from dataset_pipeline_tpu_torch import entry, kernels
        from dataset_pipeline_tpu_torch.icp.moments import (
            compute_group_moments_from_packed,
            pack_group_data,
            se3_exp_np,
        )
        from dataset_pipeline_tpu_torch.io.meshlab import (
            MeshInfo,
            read_meshlab_project,
            write_meshlab_project,
        )
        from dataset_pipeline_tpu_torch import native
        from dataset_pipeline_tpu_torch.models.lie import quat_to_matrix_np
        from dataset_pipeline_tpu_torch.io import colmap as cio
        from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
        from dataset_pipeline_tpu_torch.ops import gn, hbm
        from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps
        from dataset_pipeline_tpu_torch.tools import icp_bench, icp_scan_aligner, image_registrator
        from dataset_pipeline_tpu_torch.utils import synthetic
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    if any(m in ("jax", "dataset_pipeline_tpu") or m.startswith(("jax.", "dataset_pipeline_tpu."))
           for m in sys.modules):
        fail("the port imported jax or the JAX package")

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    t0 = time.perf_counter()
    native_build = {}
    th = threading.Thread(target=lambda: native_build.update(path=native.build()))
    th.start()  # g++ of the native gridder while nvcc builds the kernels
    kernels.library()
    th.join()
    if "path" not in native_build:
        fail("the native gridder did not build")
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_info['seconds']:.2f} s, "
          f"cached={kernels.build_info['cached']}; native gridder {native_build['path']})")
    for line in kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    t0 = time.perf_counter()
    b1 = check_b1(torch, gn, pack_group_data, se3_exp_np, C=2, seed=1)
    check_b1(torch, gn, pack_group_data, se3_exp_np, C=5, seed=2)
    b2 = check_b2(torch, gn, pack_group_data, compute_group_moments_from_packed, seed=3)
    torch.cuda.empty_cache()
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    offset = np.asarray([0.004, -0.003, 0.002])
    with tempfile.TemporaryDirectory() as root:
        # a small scene through CUDA and through the CPU (plain versions)
        write_scene(root, 5000, 7, offset, write_ply, PointCloud, MeshInfo, write_meshlab_project)
        outs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(root, f"small_{dev}.mlp")
            if icp_scan_aligner.main(["-i", os.path.join(root, "in.mlp"), "-o", out, "-d", "0.05",
                                      "--max_iterations", "20", "--device", dev]) != 0:
                fail(f"small scene on {dev} failed")
            outs[dev] = read_meshlab_project(out)[1].global_T_mesh
        gap = float(np.abs(outs["cuda"] - outs["cpu"]).max())
        print(f"small scene (2 x 5000 points): |T_cuda - T_cpu| max {gap:.3e}")
        if not gap <= SMALL_SCENE_TOL:
            fail(f"small scene: CUDA and CPU runs differ by {gap:.3e} > {SMALL_SCENE_TOL}")

        # the main path at full size
        t0 = time.perf_counter()
        write_scene(root, SCAN_POINTS, 11, offset, write_ply, PointCloud, MeshInfo,
                    write_meshlab_project)
        print(f"scene: 2 scans x {SCAN_POINTS} points written in {time.perf_counter() - t0:.1f} s")
        timings = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = icp_scan_aligner.main(
            ["-i", os.path.join(root, "in.mlp"), "-o", os.path.join(root, "aligned.mlp"),
             "-d", "0.01", "--max_iterations", "10", "--device", "cuda"], timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: kernels.LAUNCHES[k] for k in ICP_KERNELS}
        if rc != 0:
            fail(f"icp_scan_aligner returned {rc}")
        T1 = read_meshlab_project(os.path.join(root, "aligned.mlp"))[1].global_T_mesh
    print("main path stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
          + f"; wall {wall:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    residual = float(np.linalg.norm(T1[:3, 3]))
    rot_err = float(np.abs(T1[:3, :3] - np.eye(3)).max())
    print(f"main path: initial offset {np.linalg.norm(offset) * 1e3:.3f} mm, residual "
          f"{residual * 1e3:.4f} mm, rotation error {rot_err:.3e}; launches {launches}")
    if not (np.isfinite(T1).all() and residual < 1e-3 and rot_err < 1e-3):
        fail("main path did not remove the offset")
    for k, v in launches.items():
        if v <= 0:
            fail(f"main path never launched kernel {k}")

    # photometric registration
    t0 = time.perf_counter()
    b3 = check_b3(torch, tps, seed=4)
    torch.cuda.empty_cache()
    print(f"B3 checks: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        check_registrator_small(torch, image_registrator, synthetic.write_scene, cio,
                                os.path.join(root, "small"))
        print(f"small registrator scene: {time.perf_counter() - t0:.1f} s")
        reg = run_registrator_dslr(torch, kernels, image_registrator, synthetic, cio,
                                   quat_to_matrix_np, os.path.join(root, "dslr"))

    # the ICP measurement path
    t0 = time.perf_counter()
    b4a = check_b4a(torch, gn, C=2, seed=5)
    check_b4a(torch, gn, C=5, seed=6)
    torch.cuda.empty_cache()
    variants = check_moment_variants(torch, gn, pack_group_data, seed=7)
    torch.cuda.empty_cache()
    b5b = check_b5b(torch, hbm, seed=8)
    torch.cuda.empty_cache()
    print(f"B4a, B4b, B4c, B5a, B5b checks: {time.perf_counter() - t0:.1f} s")
    _, bench = run_icp_bench(torch, kernels, icp_bench, entry)

    # per kernel: the launches of each main path that runs it, and this run's numbers
    by_path = {"icp_scan_aligner": launches, "image_registrator": {"pyramid_sample": sum(reg.values())},
               "icp_bench": bench}
    measured = {"gn_fused": b1, "moment_gram": b2, "pyramid_sample": b3["derivs"], "gn_rows": b4a,
                "hbm_read_sum": b5b, **variants}
    report = []
    for kname, k in kernels.KERNELS.items():
        paths = {p: c[kname] for p, c in by_path.items() if kname in c}
        report.append({"name": kname, "route": "cuda",
                       "source": f"dataset_pipeline_tpu_torch/csrc/{k.source}",
                       "replaces": k.replaces, "launches": sum(paths.values()),
                       "launches_by_path": paths, **measured[kname]})
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
