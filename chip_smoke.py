#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``dataset_pipeline_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``dataset_pipeline_tpu_torch/csrc``
(nvcc, sm_90a) and the native gridder, then runs five paths of the port:

- ICP scan alignment: B1/B2 held against their plain PyTorch versions
  (float32 and float64) at the engine's shapes (~8M correspondences, chunk
  49152) and timed with CUDA events; B1's cost batch (K = 10 candidates in
  one pass) bit for bit against the full pass's cost and beside K full
  passes; a small scene CUDA vs CPU; then
  ``tools.icp_scan_aligner.main(..., "--device", "cuda")`` on two synthetic
  height-field scans of ~4M points each.
- Photometric image registration: B3 (``pyramid_sample``) and the
  row-paired copy of the pyramid it reads against their plain versions at
  the registrator's shapes (8 images x 3072x2048 x 5 scales, 1.6M
  observations per image, both modes); a 640x480 scene through
  ``tools.image_registrator.main(..., "--device", dev)`` on CUDA and on the
  CPU; then the DSLR configuration (16 images of 3072x2048, a coloured scan
  of ~5.6M points, ~2.2M multi-resolution points) through the CLI at full
  resolution for 3 iterations, keeping the inputs of its first
  derivatives-mode B3 launch, at which B3 is timed again afterwards. With
  ``--compare_b3_source FILE`` (a one-off) an earlier B3 that reads the
  flat pyramid is built from FILE and held bit for bit against this one at
  both input sets, the two timed in turns.

- The ICP measurement path: B5b (``hbm_read_sum``), B4a (``gn_rows``, C = 2
  and C = 5, random per-row cloud ids and ids sorted by cloud pair, the
  floor at B5b's read rate), B4b
  (``moment_gram48``), B4c (``moment_gram_thirds``) and B5a
  (``moment_gram_repeat``, two different copies) against their plain
  versions at 8M correspondences / 8,388,608 columns; with
  ``--compare_b4a_source FILE`` (a one-off) an earlier B4a built from FILE
  against the float64 plain version and in turns with this one;
  then ``tools.icp_bench.main(["--device", "cuda"])`` at full width (8M
  correspondences x 20 iterations, the engine A/B at 1M / 8M / 28M), whose
  JSON line is printed; then ``entry()``'s step on the card.

- The gather-wall path: E1-E4 (four gathers from a tile in shared memory, a
  batch of 4096 tiles), E5 (``tile_gather``, 24576 tiles of 512 tasks), E6
  and E7 (``row_extract``, ``row_extract_packed``, 1,998,848 observations)
  against their plain versions in float32 and float64, each beside the one
  PyTorch call that computes the same function where there is one; the
  calibration of scattered sector reads (E6 and E7 timed at four lane
  classes, which tell whether the card serves a 32-byte sector as itself or
  as a 64-byte atom, and the floor that gives at B5b's read rate), E6 / E7 on
  rows of odd width 4 bytes off a 16-byte boundary, and the SASS of their
  loads; then ``experiments.gather_probe.main`` and ``gather_probe2.main`` at
  the JAX scripts' sizes, whose JSON lines are printed; then the brick
  sampler (``ops/brick.py``: table build, two row gathers, E7) against B3 on
  B3's own inputs. With ``--compare_row_extract_sources E6_CU E7_CU`` (a
  one-off) an earlier E6 and E7 are built from those files and held bit for
  bit against the shipped ones, calibrated, and timed in turns with them.

- Ground truth and its inputs (no hand-written kernel on this path): on the
  DSLR scene with its true poses, ``tools.ground_truth_creator`` with splat
  occlusion and with a 1 cm surface mesh (every valid ground-truth pixel
  within 1 mm of the ray-cast surface, the valid share above the bound from
  the points per pixel, the mesh occlusion depth within 1e-4 m, every kept
  point seen in >= 2 images by the tool's own ``_visible_mask``);
  ``tools.normal_estimator`` and ``tools.splat_creator`` with a mesh that
  leaves out a rectangle (>= 95 % of the splats in it), then the ground
  truth with mesh + splats; the four device tools on small inputs on the
  card and on the CPU (depth maps bit-equal); ``tools.cube_map_renderer`` on
  ``bench.py``'s 10 M-point cloud at 2048^2 (the raw z-buffer and winner
  colours at 100,000 pixels against a sort of (pixel, z, index), no pixel
  left uncoloured) and ``tools.sfm_scale_estimator`` on its faces (scale 2
  within 1e-4). Stage seconds, and under ``torch.profiler`` the shares of
  ``scatter_reduce_`` and of the raster tiers in one image's and one face's
  device time.

- Slice 4, the cleaner and the rest of the registrator (B3 the only kernel):
  (a) ``tools.point_cloud_cleaner`` on the central 2 M points of the DSLR
  scan with 1 % planted points hovering over it, the ETH3D recipe ``--filter 270,1.15 --filter 20,1.15``
  (the first filter keeps > 97 % of the surface and < 50 % of the planted
  points), then ``ops.outlier._outliers_from_adaptive_knn`` on the card for
  the first filter (its mask agrees with the host kNN's at >= 99.9 % of the
  points; its grid stays under 2^31 cells); (b) the DSLR configuration twice
  with the cloud cache that the main DSLR run wrote and
  ``--cache_observations`` (scale 0.5 then 1): neither run rebuilds the cloud
  or the neighbours, the second loads the first's observations cache, the two
  end within the pose limit, and the cache's hit rate is measured after the
  third iteration; the depth residuals through the optimizer's API (depth
  maps ray cast at the true poses); (d) ``--occlusion_mesh_path`` with the
  ground-truth phase's 1 cm mesh; (c) the 16 images as 8 sets of a two-camera
  rig (``rigs.json``) from perturbed poses. Each lowers the cost (and the
  pose error), launches B3, and B3 is held against its plain version at the
  inputs of the first launch on the views, in the depth core and in the rig
  core.

- Slice 5, joint multi-scene BA (B3 the only kernel, in both modes):
  ``tools.joint_ba`` on two DSLR scenes of 8 images (3072x2048, f = 2800)
  that share the camera, each scanned twice at 100,000 points/m^2 with scan
  1's ``.mlp`` pose off by ``synthetic.SCAN1_ERROR``: the cost and the mean
  image pose error fall, each scene's scan-1 error is recorded;
  B3 is held against its plain version at the inputs of the run's first
  launch of each mode; stage and per-call seconds and the peak memory. Then
  a small plain two-scene run and a 640x480 rig run (``rigs.json``) on CUDA
  and on the CPU, within the registrator's limits; and the small plain
  scenes with scan 1 shifted 4 mm along the surface normal
  (``--icp_weight 1e6``) on the card, where each scene's scan-1 error must
  fall below half its start.

- Slice 6, the multi-device layer (B4a, B2 and B3 inside each rank; one
  card, so no scaling number): ``sharded_icp_hb`` and ``sharded_moment_gram``
  at 8M correspondences at world 1 over NCCL and at world 2 over Gloo (two
  ranks sharing the card; NCCL takes one rank per card), every rank held
  against the one-process B4a / B2 results at the JAX tests' bounds, and the
  LM cost derived from each B2 Gram within 1e-4 of B4a's direct cost; the
  DSLR registrator through the CLI at ``--devices 2`` from the cloud cache
  the DSLR phase wrote, against the one-rank run of the same arguments
  (qvec 5e-6, tvec 5e-5, optimum cost 1e-5 relative), each rank's B3
  launches, seconds per iteration and per collective; the small plain and
  rig joint-BA scenes of slice 5 at ``--devices 2`` against their one-rank
  runs (the registrator's limits); ``entry.dryrun_multichip(1)`` (NCCL) and
  ``(2)`` (Gloo). The ranks' kernel launches are counted in the parent.

- Slice 7, the long tail (B3 and B2 on the new paths): ``tools.dataset_inspector``
  through its CLI on the DSLR scene (16 x 3072x2048, the 5,647,680-point
  scan, ``--merge_distance_factor 3``): a first call with the depth,
  overlay, occlusion and scan renderings and a nudge of (5 mm, 2 mrad) of
  image 2 from its true pose, a second with every mode, image 2 localized
  from 200 scan points projected with its true pose and a mask drawn on
  image 0 transferred to image 1 (every file for all 16 images, the pose
  within 1e-4 of the truth and closer than the nudged start, > 1000
  transferred MASK_OBS pixels, points drawn, B3 launched; the two calls'
  walls, peak memory and B3 launches and seconds per call); the inspector on
  the 640x480 scene on the card and on the CPU (depth, overlay, occlusion,
  scan PNGs and the mask byte-equal, points and cost PNGs >= 99.9 % of
  pixels within 2 levels, localized poses within 5e-7); ``align_pair`` on a
  generated 640x480 RGB-D pair 2.1 cm / 1.0 degree apart (the JAX test's
  bounds, closer than the start, CUDA = CPU within 5e-7 at 2 iterations a
  scale); ``utils.scaling_bench`` at world 1 (NCCL) and world 2 (Gloo, one
  card: not a scaling number), payloads as JAX's, B2 launched in every rank.
  B3 is held against its plain version at the inspector's first value-mode
  and the pair's first derivs-mode launch.

- Slice 8, the rest of ``bench.py`` (B3 on five new paths): ``tools.bench.main``
  at ``bench.py``'s sizes, every section but ``scaling`` (slice 7 runs the
  scaling bench), the ICP section's results taken from the ICP measurement
  path's run: the batched photometric H,b, the gather cost model, cube maps,
  GT depth, the two registrator runs, the joint-BA system and dense step, and
  the four C++ reference baselines. Every value finite, every ``ref_cpp_*``
  key present, the DSLR iterations lower the cost, joint BA's descent lowers
  its cost, no GT frame empty, no cube pixel uncoloured, no read rate above
  the card's stated peak, B3 launched by each of the five sections that sample
  images and held against its plain version at the DSLR section's first
  derivs-mode launch.

It fails (non-zero exit, no result line) if CUDA is absent, a kernel does
not build, launch or agree, a path did not launch each of its kernels, the
LM ladders launch B1 more than twice per iteration, the
alignment does not remove the initial offset, the registration does not
lower the cost and the pose error, the engines of the A/B end at different
poses, the repeat slope and the event time of the moment pass disagree, the
read bandwidth or a probe's rate comes out above the card's stated peak, the
brick path and B3 disagree, or a check of the ground-truth, slice-4, joint-BA,
multi-device, slice-7 or slice-8 phase misses (a rank that fails fails the run). The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit from nvidia-smi, and the one before that the per-kernel JSON.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ICP_KERNELS = ("gn_fused", "gn_fused_cost_batch", "moment_gram")
REG_KERNELS = ("pyramid_sample_derivs", "pyramid_sample_value", "pyramid_pairs", "hb_geometry_project",
               "hb_geometry_jacobian", "hb_gram")
BENCH_KERNELS = ("gn_fused", "gn_fused_cost_batch", "moment_gram", "gn_rows", "moment_gram48", "moment_gram_thirds",
                 "moment_gram_repeat", "hbm_read_sum")
PROBE_KERNELS = ("take_along_lanes", "take_along_sublanes", "take_rows", "advanced_2d",
                 "tile_gather", "row_extract", "row_extract_packed")
ENGINE_CHUNK = 49152
CORR_TOTAL = 8_000_000
SCAN_POINTS = 4_000_000  # per scan: two scans give ~8M correspondences
B1_TOL = 1e-5  # max |kernel - float64 plain| / max |float64 plain|, H, b and cost
B2_TOL = 2e-5  # as tests/test_icp_moments.py: atol 2e-5 * max |P|
SMALL_SCENE_TOL = 1e-4  # .mlp entries, CUDA run vs CPU (plain) run
# B3 at the registrator's shapes (bench.py bench_registrator_dslr)
B3_IMAGES, B3_W, B3_H, B3_SCALES, B3_OBS = 8, 3072, 2048, 5, 1_600_000
B3_VALUE_TOL, B3_DERIV_TOL = 1e-4, 1e-3  # abs, kernel vs plain where ok
# the H,b geometry kernel vs its plain version on valid rows (tests/test_torch_cuda.py): pix within
# HB_PIX_ULPS float32 ulps of the projection's rounding, J within HB_J_RTOL of the entry plus a
# thousandth of its column's largest
HB_PIX_ULPS, HB_J_RTOL = 8, 1e-3
# the H,b Gram kernel vs the plain _gram_assemble with J in float64 (tests/test_torch_cuda.py): H
# within HB_GRAM_RTOL of sqrt(H_ii H_jj), b of its largest entry on that scale, the cost within
# HB_GRAM_COST_RTOL
HB_GRAM_RTOL, HB_GRAM_COST_RTOL = 1e-4, 1e-5
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
B1_COST_FLOPS = 85  # per correspondence and candidate: posing 66, residuals 14, the cost 5
B1_CANDIDATES = 10  # the LM ladder's tries
# kernels already redesigned for this card: the order below does not take them again
REDESIGNED = ("hbm_read_sum", "gn_fused", "pyramid_sample", "moment_gram", "moment_gram48",
              "moment_gram_thirds", "moment_gram_repeat", "row_extract", "row_extract_packed", "gn_rows")
# the operation count of a moment Gram row over the 42x42 upper triangle: 903
# FMAs and 43 for the monomials (gn.MOMENT_FLOPS_PER_ROW, the least work, is
# the Kronecker-factored count); printed beside it so earlier shares compare
B2_FLOPS_TRIANGLE = 2 * 903 + 43
# B4a per correspondence: the least work, the 28 sums (w j1, w j2: 12; P: 21 x 2
# FMAs; q: 6 x 2; the cost 5: 125 flops), beside the dense form's count on its
# 13 non-zeros per column (2 products x 91 FMAs), which earlier shares used
B4A_FLOPS, B4A_FLOPS_NONZERO = 125, 364
B4B_CHUNK = 16384
HBM_MP = 8_388_608
ENGINE_POSE_TOL = 1e-5  # moment / device-LM engines vs the direct engine, q and t
PASS_AGREE = 0.15  # repeat slope vs CUDA events on the moment pass
HBM_CEILING = 1.05  # measured read bandwidth over the stated peak, at most
# the gather probes' kernels, at sizes whose inputs exceed the L2
PROBE_TILES, PROBE_S, PROBE_W, PROBE_K, PROBE_T = 4096, 64, 128, 8, 256
E5_TILES, E5_CAP = 24576, 512  # 12.6M tasks: B3's observation count
E67_OBS = 1_998_848  # the JAX script's 2,000,000 rounded down to its block of 2048
BLEND_TOL = 5e-6  # abs, E5-E7 vs the float64 plain version on N(0,1) values: a few float32 ulps


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


def cuda_ms(fn, torch, warmup: int = 3, reps: int = 15, inner: int = 1) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after a warm-up. With
    ``inner`` > 1 each event pair brackets that many back-to-back calls, so
    that the host's time in a wrapper hides behind the call before it; one
    more call goes ahead of the first event and keeps the card busy while the
    host queues the timed ones, so that the first of them hides its wrapper's
    host time as well (it is longer for a ctypes wrapper than for a PyTorch
    call, which would tilt a comparison of the two)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if inner > 1:
            fn()
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def kernel_ms(fn, torch) -> dict:
    """A kernel row's times: ``ms`` over ten back-to-back launches per event
    pair (every kernel here reads more than the L2 holds, so each launch goes
    to device memory) and ``ms_one_launch`` with one launch between its events,
    which adds the wrapper's host time to a kernel shorter than it."""
    return {"ms": cuda_ms(fn, torch, inner=10), "ms_one_launch": cuda_ms(fn, torch)}


def in_turns(a, b, torch, kw_a, kw_b):
    """Median milliseconds of ``a`` and ``b`` timed in the order a, b, b, a:
    the two readings of each."""
    a1, b1 = cuda_ms(a, torch, **kw_a), cuda_ms(b, torch, **kw_b)
    b2, a2 = cuda_ms(b, torch, **kw_b), cuda_ms(a, torch, **kw_a)
    return (a1, a2), (b1, b2)


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
    bad = cp.clone()
    bad[len(bad) // 2, 0] = C  # no such cloud
    if not all(bool(x.isnan().all()) for x in gn.icp_hb_cost_fused(q, t, data, bad, C, ENGINE_CHUNK)):
        fail(f"B1 C={C}: an invalid cloud id does not poison H, b and cost with NaN")
    times = kernel_ms(kernel, torch)
    plain_ms = cuda_ms(plain, torch, warmup=1, reps=5)
    b = bound(data.numel() * 4, B1_FLOPS * data.shape[1])
    print(f"B1 gn_fused C={C} M={data.shape[1]} (chunk {ENGINE_CHUNK}): kernel vs f64 plain "
          f"rel H {rel['H']:.3e} b {rel['b']:.3e} cost {rel['cost']:.3e}; f32 plain vs f64 "
          f"rel H {rel32:.3e}; max|kernel - f32 plain| {max_abs:.3e}; max|H| "
          f"{np.max(np.abs(p64[0])):.3e}; invalid id -> NaN; kernel {times['ms']:.4f} ms "
          f"({times['ms_one_launch']:.4f} ms for one launch between its events), f32 plain "
          f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    batch = check_b1_cost_batch(torch, gn, se3_exp_np, data, cp, bad, C, seed, times["ms"])
    return {"max_abs_err": max_abs, **times, "plain_ms": plain_ms, **b, "library_ms": None,
            "cost_batch": batch}


def check_b1_cost_batch(torch, gn, se3_exp_np, data, cp, bad_cp, C: int, seed: int, full_ms: float):
    """B1's second launch mode on the same packed tensor: the cost under K =
    10 candidate pose sets in one pass. Every element must have the bits of
    the full pass's cost at that candidate; the time stands beside K full
    passes, taken in turns."""
    K = B1_CANDIDATES
    rng = np.random.RandomState(1000 + seed)
    poses = [[se3_exp_np(0.02 * rng.randn(6)) for _ in range(C)] for _ in range(K)]
    qs = torch.tensor(np.asarray([[p[0] for p in c] for c in poses]), dtype=torch.float32, device="cuda")
    ts = torch.tensor(np.asarray([[p[1] for p in c] for c in poses]), dtype=torch.float32, device="cuda")

    def kernel():
        return gn.icp_cost_batch_fused(qs, ts, data, cp, C, ENGINE_CHUNK)

    def full_passes():
        return [gn.icp_hb_cost_fused(qs[k], ts[k], data, cp, C, ENGINE_CHUNK)[2] for k in range(K)]

    k = kernel()
    if not torch.equal(k, kernel()):
        fail(f"B1 cost batch C={C}: two identical launches disagree (not deterministic)")
    full = torch.stack(full_passes())
    if not torch.equal(k, full):
        fail(f"B1 cost batch C={C}: elements {torch.nonzero(k != full)[:, 0].tolist()} do not have "
             f"the bits of the full pass's cost (max gap {float((k - full).abs().max()):.3e})")
    p32 = gn.gn_cost_batch_plain(qs, ts, data, cp, C, ENGINE_CHUNK)
    p64 = gn.gn_cost_batch_plain(qs.double(), ts.double(), data.double(), cp, C, ENGINE_CHUNK)
    rel = float((k - p64).abs().max() / p64.abs().max())
    max_abs = float((k - p32).abs().max())
    if not bool(k.isfinite().all()) or rel > B1_TOL:
        fail(f"B1 cost batch C={C}: kernel vs float64 plain {rel:.3e} > {B1_TOL}")
    if not bool(gn.icp_cost_batch_fused(qs, ts, data, bad_cp, C, ENGINE_CHUNK).isnan().all()):
        fail(f"B1 cost batch C={C}: an invalid cloud id does not poison the costs with NaN")
    times = kernel_ms(kernel, torch)
    (f1, f2), (b1, b2) = in_turns(full_passes, kernel, torch, {"reps": 7}, {"inner": 10})
    plain_ms = cuda_ms(lambda: gn.gn_cost_batch_plain(qs, ts, data, cp, C, ENGINE_CHUNK), torch,
                       warmup=1, reps=3)
    b = bound(data.numel() * 4, K * B1_COST_FLOPS * data.shape[1])
    print(f"B1 gn_fused cost batch C={C} K={K} M={data.shape[1]}: every element bit-equal to the "
          f"full pass's cost; kernel vs f64 plain rel {rel:.3e}; max|kernel - f32 plain| "
          f"{max_abs:.3e}; invalid id -> NaN; kernel {times['ms']:.4f} ms "
          f"({times['ms_one_launch']:.4f} ms for one launch between its events), in turns with "
          f"{K} full passes: full {f1:.4f} / {f2:.4f} ms, batch {b1:.4f} / {b2:.4f} ms "
          f"({(f1 + f2) / (b1 + b2):.2f}x; one full pass {full_ms:.4f} ms); f32 plain "
          f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"K": K, "max_abs_err": max_abs, **times, "k_full_passes_ms": (f1 + f2) / 2,
            "plain_ms": plain_ms, **b, "library_ms": None}


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

    parts = kernel()[0]
    if not torch.equal(parts, parts.transpose(1, 2)):
        fail("B2: a part is not exactly symmetric")
    if worst_fro >= 1e-7:
        fail(f"B2: max err {worst_fro:.3e} of ||P||_F is not under the engine's 1e-7")
    times = kernel_ms(kernel, torch)
    plain_ms = cuda_ms(plain, torch, warmup=1, reps=5)
    b = gram_bound(gn, data.numel() * 4 + parts.numel() * 4, data.shape[1])
    print(f"B2 moment_gram M={data.shape[1]} (chunk {ENGINE_CHUNK}): kernel vs f64 plain max err "
          f"{worst_max:.3e} of max|P|, {worst_fro:.3e} of ||P||_F (engine assumes noise "
          f"1e-7 ||P||_F); parts symmetric; f32 plain vs f64 {worst32:.3e} of ||P||_F; max|kernel - "
          f"f32 plain| {max_abs:.3e}; kernel {times['ms']:.4f} ms ({times['ms_one_launch']:.4f} ms for "
          f"one launch between its events), f32 plain {plain_ms:.4f} ms; {gram_shares(gn, b, times['ms'])}")
    return {"max_abs_err": max_abs, **times, "plain_ms": plain_ms, **b, "library_ms": None}


# ---------------------------------------------------------------------------
# The ICP measurement path: B4a, B4b, B4c, B5a, B5b and tools/icp_bench.py
# ---------------------------------------------------------------------------


def b4a_inputs(torch, C: int, seed: int):
    """B4a's rows at 8M and two id layouts: "random" per-row ids (equal 1 time
    in C) and "sorted", the engine's groups of one ordered cloud pair each (at
    C = 2 the ICP bench's (0, 1), (1, 0)); weights in {0, 1} mixed with random ones."""
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
    pairs = torch.tensor([(s, t) for s in range(C) for t in range(C) if s != t], dtype=torch.int32,
                         device="cuda")
    group = torch.arange(M, device="cuda") * len(pairs) // M
    layouts = {"random": (sid, tid),
               "sorted": (pairs[group, 0].contiguous(), pairs[group, 1].contiguous())}
    return (j1, j2, r1, r2, w), layouts


def b4a_errors(got, p64, label: str):
    """Relative error of B4a's (H, b, cost) against the float64 plain version;
    fails above B1_TOL or on an H that is not exactly symmetric."""
    rel = {name: float(np.max(np.abs(got[i] - p64[i])) / max(np.max(np.abs(p64[i])), 1e-30))
           for i, name in enumerate(("H", "b", "cost"))}
    if not all(np.isfinite(x).all() for x in got) or max(rel.values()) > B1_TOL:
        fail(f"B4a {label}: kernel vs float64 plain {rel} > {B1_TOL}")
    if not np.array_equal(got[0], got[0].T):
        fail(f"B4a {label}: H is not exactly symmetric")
    return rel


def check_b4a(torch, gn, C: int, seed: int, read_bps: float):
    """B4a against its plain version (float64 and float32) at 8M rows on both
    id layouts: bit-equal over two launches, an exactly symmetric H, within
    B1_TOL of the float64 plain version; timed on each layout (ten launches
    per event pair). The bound is the bytes' (68 B a row); the floor, the
    bytes at this run's B5b read rate."""
    rows, layouts = b4a_inputs(torch, C, seed)
    M = CORR_TOTAL
    S = 6 * C + 1
    b = bound(68 * M + 8 * S * S, B4A_FLOPS * M)
    ops_ms = {n: 1e3 * f * M / FP32_FLOPS for n, f in (("least", B4A_FLOPS), ("dense", B4A_FLOPS_NONZERO))}
    floor_ms = 1e3 * (68 * M + 8 * S * S) / read_bps
    out = {**b, "floor_ms": floor_ms, "library_ms": None}
    for name, (sid, tid) in layouts.items():
        args = (*rows[:4], sid, tid, rows[4])
        k = [x.cpu().numpy() for x in gn.gn_rows(*args, C)]
        k2 = [x.cpu().numpy() for x in gn.gn_rows(*args, C)]
        if any(not np.array_equal(a, c) for a, c in zip(k, k2)):
            fail(f"B4a C={C} {name} ids: two identical launches disagree (not deterministic)")
        p64 = [x.cpu().numpy() for x in gn.gn_rows_plain(
            *[a.double() if a.is_floating_point() else a for a in args], C)]
        rel = b4a_errors(k, p64, f"C={C} {name} ids")
        times = kernel_ms(lambda: gn.gn_rows(*args, C), torch)
        if name == "random":
            p32 = [x.cpu().numpy() for x in gn.gn_rows_plain(*args, C)]
            out["max_abs_err"] = float(max(np.max(np.abs(k[i] - p32[i])) for i in range(3)))
            out["plain_ms"] = cuda_ms(lambda: gn.gn_rows_plain(*args, C), torch, warmup=1, reps=5)
            out.update(times)
        out[name] = {**times, "rel": rel}
        print(f"B4a gn_rows C={C} M={M} ({name} ids): kernel vs f64 plain rel H {rel['H']:.3e} b "
              f"{rel['b']:.3e} cost {rel['cost']:.3e}, bit-equal over two launches, H exactly symmetric; "
              f"kernel {times['ms']:.4f} ms ({times['ms_one_launch']:.4f} ms for one launch between its "
              f"events); bound {b['bound_ms']:.4f} ms ({b['bound_by']}, 68 B/row; operations "
              f"{ops_ms['least']:.4f} ms on {B4A_FLOPS} flop/row, {ops_ms['dense']:.4f} on the dense "
              f"form's {B4A_FLOPS_NONZERO}): {b['bound_ms'] / times['ms']:.1%} on either count; floor at "
              f"this run's B5b read rate {floor_ms:.4f} ms: {floor_ms / times['ms']:.1%}"
              + (f"; f32 plain {out['plain_ms']:.4f} ms" if name == "random" else ""))
    return out


def compare_b4a(torch, gn, kernels, source: str):
    """An earlier B4a (``source``, the entry point of dense operands in
    4096-column blocks) against the shipped one at C = 2 and C = 5 on both id
    layouts: each within B1_TOL of the float64 plain version, the two timed in
    turns (earlier, shipped, shipped, earlier), ten launches per event pair."""
    import ctypes

    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn, _ = load_oneoff(kernels, source, "dpt_gn_rows", [P] * 7 + [L, I, I, I, P, I, P, P])

    def earlier(j1, j2, r1, r2, sid, tid, w, C):
        M, S = j1.shape[1], 6 * C + 1
        nt = (S + 3) // 4
        tile_cols = min(256, (12032 // (8 * nt) - 1) // 32 * 32)  # its staging: 12032 floats
        nblocks = -(-M // 4096)
        partials = torch.empty((nblocks, nt * (nt + 1) // 2 * 16), dtype=torch.float32, device="cuda")
        G = torch.empty((S, S), dtype=torch.float64, device="cuda")
        err = fn(*(x.data_ptr() for x in (j1, j2, r1, r2, sid, tid, w)), M, C, 4096, tile_cols,
                 partials.data_ptr(), nblocks, G.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"the earlier B4a: launch error {err}")
        n = 6 * C
        return G[:n, :n], G[:n, n], G[n, n]

    res = {}
    for C, seed in ((2, 5), (5, 6)):
        rows, layouts = b4a_inputs(torch, C, seed)
        for name, (sid, tid) in layouts.items():
            args = (*rows[:4], sid, tid, rows[4])
            p64 = [x.cpu().numpy() for x in gn.gn_rows_plain(
                *[a.double() if a.is_floating_point() else a for a in args], C)]
            rel = b4a_errors([x.cpu().numpy() for x in earlier(*args, C)], p64,
                             f"(the earlier kernel) C={C} {name} ids")
            b4a_errors([x.cpu().numpy() for x in gn.gn_rows(*args, C)], p64, f"C={C} {name} ids")
            (o1, o2), (n1, n2) = in_turns(lambda: earlier(*args, C), lambda: gn.gn_rows(*args, C), torch,
                                          {"inner": 10}, {"inner": 10})
            print(f"B4a against the earlier kernel, C={C} {name} ids: both within {B1_TOL} of the f64 "
                  f"plain (earlier {max(rel.values()):.3e}); in turns, ten launches per event pair: "
                  f"earlier {o1:.4f} / {o2:.4f} ms, shipped {n1:.4f} / {n2:.4f} ms "
                  f"({(o1 + o2) / (n1 + n2):.3f}x)")
            res[f"C{C}_{name}"] = {"earlier_ms": [o1, o2], "ms": [n1, n2]}
        del rows, layouts
        torch.cuda.empty_cache()
    return res


def gram_bound(gn, nbytes: float, rows: int) -> dict:
    """A moment Gram kernel's bound on the least work (gn.MOMENT_FLOPS_PER_ROW,
    the Kronecker-factored count), beside the bound on the triangle's count."""
    return {**bound(nbytes, gn.MOMENT_FLOPS_PER_ROW * rows),
            "bound_ms_triangle_count": bound(nbytes, B2_FLOPS_TRIANGLE * rows)["bound_ms"]}


def gram_shares(gn, b: dict, ms: float) -> str:
    return (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {gn.MOMENT_FLOPS_PER_ROW} flop/row): "
            f"{b['bound_ms'] / ms:.1%}; on the 42x42 triangle's {B2_FLOPS_TRIANGLE} flop/row "
            f"{b['bound_ms_triangle_count']:.4f} ms: {b['bound_ms_triangle_count'] / ms:.1%}")


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
    if not torch.equal(k, k.transpose(1, 2)):
        fail("B4b: a part is not exactly symmetric")
    p32 = gn.moment_gram48_plain(data16, B4B_CHUNK)
    rel, max_abs = gram_check("B4b", k, gn.moment_gram48_plain(data16.double(), B4B_CHUNK), p32)
    times = kernel_ms(lambda: gn.moment_gram48(data16, B4B_CHUNK), torch)
    plain_ms = cuda_ms(lambda: gn.moment_gram48_plain(data16, B4B_CHUNK), torch, warmup=1, reps=5)
    Mp = data16.shape[1]
    b = gram_bound(gn, 52 * Mp + k.numel() * 4, Mp)
    out["moment_gram48"] = {"max_abs_err": max_abs, **times, "plain_ms": plain_ms, **b,
                            "library_ms": None}
    print(f"B4b moment_gram48 M={Mp} (chunk {B4B_CHUNK}, 16 rows): kernel vs f64 plain max err "
          f"{rel:.3e} of max|P|; pad rows zero; max|kernel - f32 plain| {max_abs:.3e}; kernel "
          f"{times['ms']:.4f} ms ({times['ms_one_launch']:.4f} ms for one launch between its "
          f"events), f32 plain {plain_ms:.4f} ms; {gram_shares(gn, b, times['ms'])}")
    del data16, k, p32

    # B4c
    data, _ = pack_group_data(groups, ENGINE_CHUNK, rows=13, device="cuda")
    k = gn.moment_gram_thirds(data, ENGINE_CHUNK)
    if not torch.equal(k, gn.moment_gram_thirds(data, ENGINE_CHUNK)):
        fail("B4c: two identical launches disagree (not deterministic)")
    if not torch.equal(k, k.transpose(2, 3)):
        fail("B4c: a part is not exactly symmetric")
    p32 = gn.moment_gram_thirds_plain(data, ENGINE_CHUNK)
    rel, max_abs = gram_check("B4c", k, gn.moment_gram_thirds_plain(data.double(), ENGINE_CHUNK), p32)
    times = kernel_ms(lambda: gn.moment_gram_thirds(data, ENGINE_CHUNK), torch)
    plain_ms = cuda_ms(lambda: gn.moment_gram_thirds_plain(data, ENGINE_CHUNK), torch,
                       warmup=1, reps=5)
    Mp = data.shape[1]
    b = gram_bound(gn, 52 * Mp + k.numel() * 4, Mp)
    out["moment_gram_thirds"] = {"max_abs_err": max_abs, **times, "plain_ms": plain_ms, **b,
                                 "library_ms": None}
    print(f"B4c moment_gram_thirds M={Mp} (chunk {ENGINE_CHUNK}, per third): kernel vs f64 plain "
          f"max err {rel:.3e} of max|P|; max|kernel - f32 plain| {max_abs:.3e}; kernel "
          f"{times['ms']:.4f} ms ({times['ms_one_launch']:.4f} ms for one launch between its "
          f"events), f32 plain {plain_ms:.4f} ms; {gram_shares(gn, b, times['ms'])}")
    del k, p32

    # B5a: a second, different copy
    other, _ = pack_group_data(synthetic_groups(torch, pairs, CORR_TOTAL, seed + 100),
                               ENGINE_CHUNK, rows=13, device="cuda")
    data2 = torch.stack([data, other])
    del groups, data, other
    k, per_chunk = gn.moment_gram_repeat(data2, ENGINE_CHUNK, 5)
    if not torch.equal(k, gn.moment_gram_repeat(data2, ENGINE_CHUNK, 5)[0]):
        fail("B5a: two identical launches disagree (not deterministic)")
    if not torch.equal(k, k.transpose(1, 2)):
        fail("B5a: a part is not exactly symmetric")
    k = k.reshape(-1, per_chunk, 42, 42)
    ref64 = (3 * gn.moment_gram_plain(data2[0].double(), ENGINE_CHUNK)
             + 2 * gn.moment_gram_plain(data2[1].double(), ENGINE_CHUNK))
    p32 = gn.moment_gram_repeat_plain(data2, ENGINE_CHUNK, 5)
    rel, max_abs = gram_check("B5a", k.double().sum(1), ref64, p32)
    one, _ = gn.moment_gram_repeat(data2, ENGINE_CHUNK, 1)
    if not torch.equal(one, gn.moment_gram_partials(data2[0], ENGINE_CHUNK)[0]):
        fail("B5a: one repeat differs from the B2 kernel on the same copy")
    times = kernel_ms(lambda: gn.moment_gram_repeat(data2, ENGINE_CHUNK, 1), torch)
    ms = times["ms"]
    ms5 = cuda_ms(lambda: gn.moment_gram_repeat(data2, ENGINE_CHUNK, 5), torch, inner=10)
    plain_ms = cuda_ms(lambda: gn.moment_gram_repeat_plain(data2, ENGINE_CHUNK, 1), torch,
                       warmup=1, reps=5)
    Mp = data2.shape[2]
    b = gram_bound(gn, 52 * Mp + one.numel() * 4, Mp)
    out["moment_gram_repeat"] = {"max_abs_err": max_abs, **times, "plain_ms": plain_ms, **b,
                                 "library_ms": None}
    print(f"B5a moment_gram_repeat M={Mp} (two different copies): R=5 vs 3 Gram(copy0) + "
          f"2 Gram(copy1) in f64 max err {rel:.3e} of max; max|kernel - f32 plain| {max_abs:.3e}; "
          f"R=1 bitwise the B2 kernel; R=1 {ms:.4f} ms ({times['ms_one_launch']:.4f} ms for one "
          f"launch between its events), R=5 {ms5:.4f} ms "
          f"({(ms5 - ms) / 4:.4f} ms per further repeat), f32 plain (R=1) {plain_ms:.4f} ms; "
          f"{gram_shares(gn, b, ms)}")
    return out


def check_b5b(torch, hbm, seed: int):
    """B5b against the float64 sum at R = 1, 3 and 17, one kernel per repeat
    (one in all at R = 1); the one PyTorch call with the same function,
    ``data2[0].sum(1)``, is timed in turns with it (library, kernel, kernel,
    library), ten calls per event pair each."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    data2 = torch.randn((2, 8, HBM_MP), generator=g, device="cuda")
    many = 17  # enough further repeats to hide the first launch's latency
    rel = 0.0
    for R in (1, 3, many):
        k = hbm.hbm_read_sum(data2, R)
        if hbm.last_call_kernel_launches != R:
            fail(f"B5b R={R}: {hbm.last_call_kernel_launches} kernels launched, not one per repeat")
        if not torch.equal(k, hbm.hbm_read_sum(data2, R)):
            fail(f"B5b R={R}: two identical launches disagree (not deterministic)")
        ref = hbm.hbm_read_sum_plain(data2.double(), R)
        rel = max(rel, float((k.double() - ref).abs().max() / ref.abs().max()))
        if not bool(k.isfinite().all()) or rel > 1e-5:
            fail(f"B5b R={R}: kernel vs float64 sum {rel:.3e} > 1e-5 of max|sum|")
    one = hbm.hbm_read_sum(data2, 1)
    max_abs = float((one - hbm.hbm_read_sum_plain(data2, 1)).abs().max())
    (l1, l2), (k1, k2) = in_turns(lambda: data2[0].sum(1), lambda: hbm.hbm_read_sum(data2, 1), torch,
                                  {"inner": 10}, {"inner": 10})
    ms, library_ms = (k1 + k2) / 2, (l1 + l2) / 2
    ms_one_launch = cuda_ms(lambda: hbm.hbm_read_sum(data2, 1), torch)
    library_one_call = cuda_ms(lambda: data2[0].sum(1), torch)
    ms_many = cuda_ms(lambda: hbm.hbm_read_sum(data2, many), torch, inner=10)
    per_repeat = (ms_many - ms) / (many - 1)
    plain_ms = cuda_ms(lambda: hbm.hbm_read_sum_plain(data2, 1), torch, warmup=1, reps=5)
    nbytes = 8 * HBM_MP * 4
    b = bound(nbytes + 32, 8 * HBM_MP)
    if nbytes / (1e-3 * per_repeat) > HBM_CEILING * HBM_BYTES_PER_S:
        fail(f"B5b: {nbytes / per_repeat / 1e6:.1f} GB/s per further repeat reads above "
             f"{HBM_CEILING} x the card's stated peak: the repeats are served from L2")
    print(f"B5b hbm_read_sum mp={HBM_MP} ({nbytes / 1e6:.0f} MB per pass): kernel vs f64 sum "
          f"{rel:.3e} of max|sum|; one kernel per repeat; in turns, ten calls per event pair: "
          f"data2[0].sum(1) {l1:.4f} / {l2:.4f} ms ({nbytes / library_ms / 1e6:.1f} GB/s), R=1 "
          f"{k1:.4f} / {k2:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s with the final sum; "
          f"{'at or below' if ms <= library_ms else 'ABOVE'} the library call); one call between "
          f"its events: kernel {ms_one_launch:.4f} ms, library {library_one_call:.4f} ms; R={many} "
          f"{ms_many:.4f} ms ({per_repeat:.4f} ms per further repeat = "
          f"{nbytes / per_repeat / 1e6:.1f} GB/s); plain {plain_ms:.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "ms_one_launch": ms_one_launch,
            "ms_per_further_repeat": per_repeat, "plain_ms": plain_ms, **b,
            "library_ms": library_ms, "library_ms_one_call": library_one_call}


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
    # the ladders: one full B1 pass and one cost batch per LM iteration; beyond
    # them one full pass for the final cost and one for the moment gate
    ladder = []
    for key, tag, extra in (("direct", "1m", 1), ("direct", "8m", 1), ("direct", "28m", 1),
                            ("moment", "1m", 2), ("moment", "8m", 2), ("moment", "28m", 2),
                            ("device_lm", "8m", 1)):
        full, batch = (res[f"icp_engine_{key}_b1_{mode}_{tag}"] for mode in ("full", "batch"))
        ladder.append(f"{key} {tag}: {full} full + {batch} batch")
        if not (batch >= 1 and full == batch + extra):
            fail(f"icp_bench: the {key} engine at {tag} launched B1 {full} times in full and "
                 f"{batch} times as a cost batch; expected one of each per LM iteration and "
                 f"{extra} full beyond")
    print("icp_bench: B1 launches per inner LM (one full pass + one cost batch per iteration; "
          "before the cost batch eleven full passes on the host ladder, twenty-one in the device "
          "LM): " + "; ".join(ladder))
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


# ---------------------------------------------------------------------------
# The gather-wall path: E1-E7, the two probe tools, the brick sampler
# ---------------------------------------------------------------------------


def distinct_sectors(torch, *float_offsets) -> int:
    """The distinct 32-byte sectors (8 floats) that taps at these flat float
    offsets of one array touch: what device memory must deliver of it."""
    return int(torch.unique(torch.cat([o.reshape(-1) // 8 for o in float_offsets])).numel())


def check_probe_kernel(torch, label, wrapper, plain, args, exact, nbytes, flops, library=None):
    """One of E1-E7 against its plain version in float32 and float64 on the
    same inputs, two launches bit-equal; CUDA-event times of the kernel, the
    plain version and, where there is one, the PyTorch call with the same
    function (every input is above the L2's size, so back-to-back launches
    find it cold). The first launch checks the index ranges; the timed ones
    do not (the check reads the indices back)."""
    k, k2 = wrapper(*args), wrapper(*args, check_ranges=False)
    if not torch.equal(k, k2):
        fail(f"{label}: two identical launches disagree (not deterministic)")
    p32 = plain(*args)
    p64 = plain(*[a.double() if a.is_floating_point() else a for a in args])
    e32, e64 = float((k - p32).abs().max()), float((k.double() - p64).abs().max())
    tol = 0.0 if exact else BLEND_TOL
    if k.shape != p32.shape or not bool(k.isfinite().all()) or not (e32 <= tol and e64 <= tol):
        fail(f"{label}: |kernel - plain| f32 {e32:.3e} f64 {e64:.3e} > {tol}")
    del k2, p32, p64
    # ten launches per event pair: one launch alone is shorter than a wrapper's host time
    ms = cuda_ms(lambda: wrapper(*args, check_ranges=False), torch, inner=10)
    ms_single = cuda_ms(lambda: wrapper(*args, check_ranges=False), torch)
    plain_ms = cuda_ms(lambda: plain(*args), torch, warmup=1, reps=5)
    library_ms = cuda_ms(library, torch, inner=10) if library is not None else None
    b = bound(nbytes, flops)
    print(f"{label}: kernel vs plain max |diff| f32 {e32:.3e} f64 {e64:.3e} (limit {tol}); kernel "
          f"{ms:.4f} ms ({ms_single:.4f} ms for one launch between its events), plain "
          f"{plain_ms:.4f} ms"
          + (f", library call {library_ms:.4f} ms" if library is not None else "")
          + f"; {nbytes / 1e6:.1f} MB needed -> bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
          f"{nbytes / ms / 1e6:.1f} GB/s")
    return {"max_abs_err": e32, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}


def check_tile_probes(torch, gather, seed: int):
    """E1-E4 on a batch of 4096 tiles (each array above the L2): pure moves,
    exactly the plain versions. The bytes needed are the distinct sectors of
    the tiles that the indices name, the indices and the output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, S, W, K, T = PROBE_TILES, PROBE_S, PROBE_W, PROBE_K, PROBE_T

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device="cuda", dtype=torch.int32)

    rows = torch.randn((B, S, W), generator=g, device="cuda")
    tile0 = torch.arange(B, device="cuda")[:, None, None] * (S * W)  # float offset of each tile
    lane = torch.arange(W, device="cuda")[None, None, :]
    row0 = torch.arange(S, device="cuda")[None, :, None] * W
    out = {}

    idx = ints(W, (B, S, W))
    idx64 = idx.long()
    nbytes = 32 * distinct_sectors(torch, tile0 + row0 + idx64) + 2 * idx.numel() * 4
    out["take_along_lanes"] = check_probe_kernel(
        torch, f"E1 take_along_lanes ({B}, {S}, {W})", gather.take_along_lanes,
        gather.take_along_lanes_plain, (rows, idx), True, nbytes, 0,
        lambda: torch.gather(rows, 2, idx64))
    del idx, idx64

    idx = ints(S, (B, K, W))
    idx64 = idx.long()
    nbytes = 32 * distinct_sectors(torch, tile0 + idx64 * W + lane) + 2 * idx.numel() * 4
    out["take_along_sublanes"] = check_probe_kernel(
        torch, f"E2 take_along_sublanes ({B}, {S}, {W}) by ({B}, {K}, {W})",
        gather.take_along_sublanes, gather.take_along_sublanes_plain, (rows, idx), True, nbytes, 0,
        lambda: torch.gather(rows, 1, idx64))

    iy, ix = idx, ints(W, (B, K, W))
    iy64, ix64, b64 = idx64, ix.long(), torch.arange(B, device="cuda")[:, None, None]
    nbytes = 32 * distinct_sectors(torch, tile0 + iy64 * W + ix64) + 3 * iy.numel() * 4
    out["advanced_2d"] = check_probe_kernel(
        torch, f"E4 advanced_2d ({B}, {S}, {W}) by 2 x ({B}, {K}, {W})", gather.advanced_2d,
        gather.advanced_2d_plain, (rows, iy, ix), True, nbytes, 0,
        lambda: rows[b64, iy64, ix64])
    del rows, idx, idx64, iy, ix, iy64, ix64

    table = torch.randn((B, T, W), generator=g, device="cuda")
    idx = ints(T, (B, S))
    flat_rows = (torch.arange(B, device="cuda")[:, None] * T + idx.long()).reshape(-1)
    table2 = table.reshape(B * T, W)
    nbytes = int(torch.unique(flat_rows).numel()) * W * 4 + idx.numel() * 4 + B * S * W * 4
    out["take_rows"] = check_probe_kernel(
        torch, f"E3 take_rows ({B}, {T}, {W}) by ({B}, {S})", gather.take_rows,
        gather.take_rows_plain, (table, idx), True, nbytes, 0,
        lambda: table2.index_select(0, flat_rows))
    return out


def check_tile_gather(torch, gather, seed: int):
    """E5 at 24576 tiles of 512 tasks (B3's observation count)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, cap, TH, TW = E5_TILES, E5_CAP, 8, 128
    tiles = torch.randn((n, TH, TW), generator=g, device="cuda")
    iy = torch.randint(0, TH - 1, (n, cap), generator=g, device="cuda", dtype=torch.int32)
    ix = torch.randint(0, TW - 1, (n, cap), generator=g, device="cuda", dtype=torch.int32)
    fy, fx = (torch.rand((n, cap), generator=g, device="cuda") for _ in range(2))
    base = (torch.arange(n, device="cuda")[:, None] * TH + iy.long()) * TW + ix.long()
    sectors = distinct_sectors(torch, base, base + 1, base + TW, base + TW + 1)
    del base
    torch.cuda.empty_cache()
    nbytes = 32 * sectors + n * cap * (16 + 16)  # tasks (iy, ix, fy, fx) in, four planes out
    return check_probe_kernel(
        torch, f"E5 tile_gather {n} tiles ({TH}, {TW}) x {cap} tasks", gather.tile_gather,
        gather.tile_gather_plain, (tiles, iy, ix, fy, fx), False, nbytes, 20 * n * cap)


def pair_units(lanes, floats: int) -> int:
    """The aligned units of ``floats`` floats (8: a 32-byte sector, 16: a
    64-byte chunk) that the lane pairs (l, l + 1) of rows starting on such a
    unit touch, summed over the pairs: one each, two where the pair straddles."""
    return sum(int(ln.numel()) + int((ln % floats == floats - 1).sum()) for ln in lanes)


def e6_pairs(lane):
    return [lane, lane]  # lanes l, l + 1 of r0 and of r1


def e7_pairs(la, lb, bx: int):
    return [la, la + bx, lb, lb + bx]  # each level's rows y and y + 1 of the footprint


def lane_classes(torch, g, n: int, hi: int, uniform):
    """The calibration's four lane sets for lanes in [0, hi]: (a) ``uniform``;
    (b) l = 0 mod 8, one sector per pair; (c) l = 7 mod 16, two sectors in one
    64-byte chunk; (d) l = 15 mod 16, two sectors across a 64-byte boundary."""
    def every(step, first):
        k = torch.randint(0, (hi - first) // step + 1, (n, 1), generator=g, device="cuda",
                          dtype=torch.int32)
        return k * step + first

    return {"a uniform": uniform, "b l%8=0": every(8, 0), "c l%16=7": every(16, 7),
            "d l%16=15": every(16, 15)}


def calibrate_row_extracts(torch, e6, e7, ra, rb, fr, lanes6, lanes7, read_bps: float, label: str):
    """How the card serves scattered sector reads: E6 and E7 (``e6``, ``e7``:
    callables with the wrappers' signatures) timed on the same rows with the
    four lane classes of ``lane_classes`` and nothing else changed, each held
    bit for bit against its float32 plain version. Prints ms and sector
    requests per observation per class, the model the times fit, and beside
    the bound (32-byte sectors) the floor that the winning model's bytes give
    at ``read_bps``, the read rate B5b measured in this run."""
    from dataset_pipeline_tpu_torch.ops import gather

    n = ra.shape[0]
    cases = {"E6": (lambda ln: (ra, rb, ln, fr[0], fr[1]), e6, gather.row_extract_plain,
                    e6_pairs, lanes6, 44),
             "E7": (lambda ln: (ra, rb, ln, ln.flip(0), *fr), e7, gather.row_extract_packed_plain,
                    lambda ln: e7_pairs(ln, ln.flip(0), gather.BRICK_BX), lanes7, 60)}
    out = {}
    for kname, (args_of, fn, plain, pairs_of, classes, streamed) in cases.items():
        rows = {}
        for cname, ln in classes.items():
            args = args_of(ln)
            if not torch.equal(fn(*args), plain(*args)):
                fail(f"calibration, {label} {kname} at lane class {cname}: not bit-equal to the "
                     "float32 plain version")
            pairs = pairs_of(ln)
            sectors, chunks = pair_units(pairs, 8), pair_units(pairs, 16)
            rows[cname] = {"ms": cuda_ms(lambda: fn(*args, check_ranges=False), torch, inner=10),
                           "sectors_per_obs": sectors / n, "chunks64_per_obs": chunks / n,
                           "sector_bytes": 32 * sectors + n * streamed,
                           "chunk64_bytes": 64 * chunks + n * streamed}
        t = {c[0]: r["ms"] for c, r in rows.items()}
        same = 1.10  # two classes within 10 % take the same time
        flat_cb, flat_dc = t["c"] / t["b"] < same, t["d"] / t["c"] < same
        model = {(True, True): "requests", (True, False): "64-byte atoms",
                 (False, True): "sector-granular", (False, False): "mixed"}[(flat_cb, flat_dc)]
        a = rows["a uniform"]
        by_model = a["chunk64_bytes"] if model == "64-byte atoms" else a["sector_bytes"]
        floor_ms = 1e3 * by_model / read_bps
        bound_ms = 1e3 * a["sector_bytes"] / HBM_BYTES_PER_S
        print(f"calibration, {label} {kname} n={n}: "
              + "; ".join(f"({c}) {r['ms']:.4f} ms, {r['sectors_per_obs']:.3f} sector / "
                          f"{r['chunks64_per_obs']:.3f} 64-byte requests per obs" for c, r in rows.items())
              + f"; c/b {t['c'] / t['b']:.3f} (sector-granular predicts "
              f"{rows['c l%16=7']['sector_bytes'] / rows['b l%8=0']['sector_bytes']:.3f}), d/c "
              f"{t['d'] / t['c']:.3f} (64-byte atoms predict "
              f"{rows['d l%16=15']['chunk64_bytes'] / rows['c l%16=7']['chunk64_bytes']:.3f}), a/b "
              f"{t['a'] / t['b']:.3f}: the times fit {model}; at (a) bound {bound_ms:.4f} ms (32-byte "
              f"sectors at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), floor {floor_ms:.4f} ms ("
              f"{'64-byte chunks' if model == '64-byte atoms' else '32-byte sectors'}, "
              f"{by_model / 1e6:.1f} MB at B5b's {read_bps / 1e12:.3f} TB/s); (a) moves "
              f"{a['sector_bytes'] / a['ms'] / 1e9:.3f} TB/s of sectors")
        out[kname] = {"classes": rows, "model": model, "floor_ms": floor_ms, "bound_ms": bound_ms,
                      "read_tbps": read_bps / 1e12}
    return out


def row_extract_inputs(torch, seed: int):
    """The smoke's E6 / E7 inputs: two (1,998,848, 128) N(0,1) row tensors (1 GB
    each: every launch reads from device memory), five fraction columns, and
    the lane classes of the calibration for E6 (lanes <= 126) and E7 (<= 94)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, W = E67_OBS, 128
    ra, rb = (torch.randn((n, W), generator=g, device="cuda") for _ in range(2))
    fr = [torch.rand((n, 1), generator=g, device="cuda") for _ in range(5)]

    def lanes(hi):
        return torch.randint(0, hi, (n, 1), generator=g, device="cuda", dtype=torch.int32)

    lane = lanes(W - 1)
    la, lb = lanes(W - 33), lanes(W - 33)
    return (ra, rb, fr, lane, la, lb, lane_classes(torch, g, n, W - 2, lane),
            lane_classes(torch, g, n, W - 34, la))


def check_row_extracts(torch, gather, seed: int, read_bps: float):
    """E6 and E7 at 1,998,848 observations on N(0,1) rows. An observation's
    taps touch one sector of a row per lane pair, two when the pair straddles
    (the first lane is the last float of a sector). Then the calibration at the
    four lane classes, and rows of odd width 4 bytes off a 16-byte boundary."""
    ra, rb, fr, lane, la, lb, lanes6, lanes7 = row_extract_inputs(torch, seed)
    n = ra.shape[0]
    nbytes = 32 * pair_units(e6_pairs(lane), 8) + n * (12 + 32)
    out = {"row_extract": check_probe_kernel(
        torch, f"E6 row_extract n={n}", gather.row_extract, gather.row_extract_plain,
        (ra, rb, lane, fr[0], fr[1]), False, nbytes, 15 * n)}
    nbytes = 32 * pair_units(e7_pairs(la, lb, gather.BRICK_BX), 8) + n * (28 + 32)
    out["row_extract_packed"] = check_probe_kernel(
        torch, f"E7 row_extract_packed n={n}", gather.row_extract_packed,
        gather.row_extract_packed_plain, (ra, rb, la, lb, *fr), False, nbytes, 45 * n)
    cal = calibrate_row_extracts(torch, gather.row_extract, gather.row_extract_packed, ra, rb, fr,
                                 lanes6, lanes7, read_bps, "shipped")
    out["row_extract"]["calibration"] = cal["E6"]
    out["row_extract_packed"]["calibration"] = cal["E7"]
    check_odd_rows(torch, gather.row_extract, gather.row_extract_packed, ra, rb, fr, lane, "shipped")
    return out


def check_odd_rows(torch, e6, e7, ra, rb, fr, lane, label: str):
    """E6 and E7 on rows of width 127 that start 4 bytes past a 16-byte
    boundary (E7 with bx = 9 and with bx = 32), bit for bit against the float32
    plain versions: a vector load whose address test is wrong faults here."""
    from dataset_pipeline_tpu_torch.ops import gather

    W, n = 127, ra.shape[0]
    r0, r1 = (r.view(-1)[1:1 + n * W].view(n, W) for r in (ra, rb))  # no row but the first starts aligned
    if r0.data_ptr() % 16 != 4 or not r0.is_contiguous():
        fail("the odd rows are not a contiguous view 4 bytes off a 16-byte boundary")
    lane = lane % (W - 1)
    if not torch.equal(e6(r0, r1, lane, fr[0], fr[1]), gather.row_extract_plain(r0, r1, lane, fr[0], fr[1])):
        fail(f"{label} E6 at W={W}, 4-byte offset: not bit-equal to the float32 plain version")
    for bx in (9, 32):
        la = lane % (W - bx - 1)
        args = (r0, r1, la, la.flip(0), *fr)
        if not torch.equal(e7(*args, bx=bx), gather.row_extract_packed_plain(*args, bx=bx)):
            fail(f"{label} E7 at W={W}, bx={bx}, 4-byte offset: not bit-equal to the float32 plain version")
    print(f"{label} E6 / E7 at W={W}, rows 4 bytes off a 16-byte boundary, n={n} "
          "(E7 at bx = 9 and 32): bit-equal to the float32 plain versions")


def print_tap_loads(kernels, lib: str, label: str):
    """The global loads and stores of the row extraction kernels in the SASS
    of ``lib`` (``cuobjdump`` beside nvcc, where the toolkit has it), and
    whether they carry an L2 prefetch-size hint (LTC64B / LTC128B)."""
    import re

    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        print(f"SASS of {label}: no cuobjdump beside nvcc")
        return
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300)
    for body in re.split(r"\n\s*Function : ", r.stdout)[1:]:
        name = body.split("\n", 1)[0].strip()
        if "row_extract" not in name:
            continue
        ops = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", ln).split(";")[0].strip()
               for ln in body.splitlines() if re.search(r"\b(LDG|STG)\b", ln)]
        hints = sorted({h for o in ops for h in re.findall(r"LTC\d+B", o)})
        print(f"SASS of {label} {name}: {len(ops)} global loads / stores, L2 prefetch-size hints: "
              f"{', '.join(hints) or 'none'}")
        for o in ops:
            print(f"    {o}")


def oneoff_row_extracts(torch, kernels, sources):
    """Earlier E6 and E7 sources (entry points without the grid argument),
    built one-off, as callables with the wrappers' signatures."""
    import ctypes

    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    f6, lib6 = load_oneoff(kernels, sources[0], "dpt_row_extract", [P] * 6 + [L, I, P])
    f7, lib7 = load_oneoff(kernels, sources[1], "dpt_row_extract_packed", [P] * 10 + [L, I, I, P])

    def launch(fn, rows, *args):
        n, W = rows[0].shape
        out = torch.empty((n, 8), dtype=torch.float32, device=rows[0].device)
        err = fn(*(x.data_ptr() for x in rows), out.data_ptr(), n, W, *args,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"a one-off row extraction kernel: launch error {err}")
        return out

    def e6(r0, r1, lane, fx, fy, check_ranges=True):
        return launch(f6, (r0, r1, lane, fx, fy))

    def e7(ra, rb, la, lb, fxa, fya, fxb, fyb, zf, bx=32, check_ranges=True):
        return launch(f7, (ra, rb, la, lb, fxa, fya, fxb, fyb, zf), bx)

    return e6, e7, (lib6, lib7)


def compare_row_extracts(torch, kernels, gather, sources, seed: int, read_bps: float):
    """Earlier E6 / E7 kernels (``sources``) against the shipped ones: bit for
    bit at the smoke's inputs, at the four lane classes and on odd rows 4 bytes
    off a 16-byte boundary; the earlier kernels' calibration; then both pairs
    timed in turns (earlier, shipped, shipped, earlier) at the smoke's inputs."""
    old6, old7, libs = oneoff_row_extracts(torch, kernels, sources)
    for lib in libs:
        print_tap_loads(kernels, lib, "the one-off build")
    ra, rb, fr, lane, la, lb, lanes6, lanes7 = row_extract_inputs(torch, seed)
    for kname, old, new, args_of, classes in (
            ("E6", old6, gather.row_extract, lambda ln: (ra, rb, ln, fr[0], fr[1]), lanes6),
            ("E7", old7, gather.row_extract_packed, lambda ln: (ra, rb, ln, ln.flip(0), *fr), lanes7)):
        for cname, ln in classes.items():
            if not torch.equal(old(*args_of(ln)), new(*args_of(ln))):
                fail(f"{kname} at lane class {cname}: the earlier kernel's outputs differ from the shipped one's")
    args7 = (ra, rb, la, lb, *fr)
    if not torch.equal(old7(*args7), gather.row_extract_packed(*args7)):
        fail("E7 at the smoke's inputs: the earlier kernel's outputs differ from the shipped one's")
    check_odd_rows(torch, old6, old7, ra, rb, fr, lane, "earlier")
    cal = calibrate_row_extracts(torch, old6, old7, ra, rb, fr, lanes6, lanes7, read_bps, "earlier")
    res = {}
    for kname, old, new, args in (("E6", old6, gather.row_extract, (ra, rb, lane, fr[0], fr[1])),
                                  ("E7", old7, gather.row_extract_packed, args7)):
        (o1, o2), (n1, n2) = in_turns(lambda: old(*args), lambda: new(*args, check_ranges=False), torch,
                                      {"inner": 10}, {"inner": 10})
        print(f"{kname} against the earlier kernel at the smoke's inputs: bit-equal there, at the four "
              f"lane classes and on the odd rows; in turns, ten launches per event pair: earlier "
              f"{o1:.4f} / {o2:.4f} ms, shipped {n1:.4f} / {n2:.4f} ms ({(o1 + o2) / (n1 + n2):.3f}x)")
        res[kname] = {"earlier_ms": [o1, o2], "ms": [n1, n2], "earlier_calibration": cal[kname]}
    return res


def run_gather_probes(torch, kernels, gather_probe, gather_probe2):
    """Both probe tools at the JAX scripts' sizes through their ``main``;
    returns their results and the launches of E1-E7."""
    res1, res2 = [], []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc1 = gather_probe.main(["--device", "cuda"], results=res1)  # prints its JSON lines
    rc2 = gather_probe2.main(["--device", "cuda"], results=res2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in PROBE_KERNELS}
    if rc1 != 0 or rc2 != 0:
        fail(f"gather_probe returned {rc1}, gather_probe2 returned {rc2}")
    print(f"gather probes: {wall:.1f} s; launches {launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"the gather-wall path never launched kernel {k}")
    results = res1 + res2
    if sum(1 for r in results if r.get("done")) != 2 or any(r.get("ok") is False for r in results):
        fail("gather probes: a tool did not reach its end or a probe is not ok")
    for r in results:
        if "bench" not in r:
            continue
        bad = [k for k, v in r.items() if isinstance(v, float) and not (np.isfinite(v) and v > 0)]
        if bad:
            fail(f"gather probes: {r['bench']}: {bad} not finite and positive")
        if r.get("dram_bytes_min"):  # 0: the L2 can hold the repeat's footprint
            rate = r["dram_bytes_min"] / r["per_rep_s"]
            if rate > HBM_CEILING * HBM_BYTES_PER_S:
                fail(f"gather probes: {r['bench']} moves {rate / 1e9:.1f} GB/s of the bytes device "
                     f"memory must deliver, above {HBM_CEILING} x the card's stated peak: the "
                     "repeats are served from L2")
    return results, launches


def check_brick_on_b3_inputs(torch, tps, gather_probe2, seed: int):
    """The brick sampler (table build, two row gathers per observation, E7)
    against B3 on B3's own inputs: ``ok`` equal, values and derivatives
    within B3's tolerances where ok; the stages' times separately."""
    pyr, flat, layout, pix, scale = b3_inputs(torch, tps, seed)
    if (gather_probe2.BRICK_VALUE_TOL, gather_probe2.BRICK_DERIV_TOL) != (B3_VALUE_TOL, B3_DERIV_TOL):
        fail("the brick comparison's tolerances are not B3's")
    lines = []
    try:
        r = gather_probe2.compare_brick_with_flat(gather_probe2.Report(lines), pix.device, pyr,
                                                  flat, layout, pix, scale)
    except gather_probe2.ProbeFailure as e:
        fail(f"brick path on B3's inputs: {e}")
    print(f"brick path on B3's inputs ({r['images']} images, {r['obs']} observations, brick tables "
          f"{r['brick_table_bytes'] / 1e6:.0f} MB vs pyramid {r['pyramid_bytes'] / 1e6:.0f} MB): "
          f"table build {1e3 * r['table_build_s']:.3f} ms, addressing "
          f"{1e3 * r['brick_address_s']:.3f} ms, row gathers {1e3 * r['row_gather_s']:.3f} ms, E7 "
          f"{1e3 * r['extract_s']:.3f} ms; B3 {1e3 * r['flat_s']:.4f} ms; (row gathers + E7) / B3 = "
          f"{(r['row_gather_s'] + r['extract_s']) / r['flat_s']:.2f}; ok equal; max gaps where ok "
          f"{r['max_gap']}")
    return r


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


def b3_inputs(torch, tps, seed: int):
    """The registrator's shapes: (pyramid levels, flat pyramid, layout, pix,
    scale) of 8 random images with 1.6M observations each, from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb, H, W, n = B3_IMAGES, B3_H, B3_W, B3_OBS
    pyr = [torch.round(255 * torch.rand((nb, H, W), generator=g, device="cuda"))]
    for _ in range(1, B3_SCALES):  # as build_image_pyramid: 2x2 box means
        b, h, w = pyr[-1].shape
        pyr.append(pyr[-1][:, : h // 2 * 2, : w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2)
                   .mean((2, 4)))
    flat, layout = tps.flatten_pyramid(pyr)
    u = torch.rand((nb, n, 2), generator=g, device="cuda")
    pix = torch.stack([u[..., 0] * (W + 8) - 4, u[..., 1] * (H + 8) - 4], -1).contiguous()
    scale = (torch.rand((nb, n), generator=g, device="cuda") * (B3_SCALES - 1)).contiguous()
    return pyr, flat, layout, pix, scale


def check_pair_build(torch, tps, flat, layout):
    """B3's second launch mode: the row-paired copy of a chunk's pyramids,
    built once per image chunk, bit for bit its plain version."""
    pairs = tps.pair_rows(flat, layout)
    if not torch.equal(pairs, tps.pair_rows_plain(flat, layout)):
        fail("B3 row-paired copy: the kernel differs from its plain version")
    if not torch.equal(pairs, tps.pair_rows(flat, layout)):
        fail("B3 row-paired copy: two identical launches disagree")
    times = kernel_ms(lambda: tps.pair_rows(flat, layout), torch)
    plain_ms = cuda_ms(lambda: tps.pair_rows_plain(flat, layout), torch, warmup=1, reps=5)
    b = bound(flat.numel() * 4 + pairs.numel() * 4, 0)
    print(f"B3 row-paired copy: {flat.numel() * 4 / 1e6:.0f} MB of pyramids -> "
          f"{pairs.numel() * 4 / 1e6:.0f} MB, bit-equal to its plain version; kernel {times['ms']:.4f} ms "
          f"({times['ms_one_launch']:.4f} ms for one launch between its events), plain "
          f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return pairs, {"max_abs_err": 0.0, **times, "plain_ms": plain_ms, **b, "library_ms": None}


def check_b3(torch, tps, seed: int, flat_sampler=None):
    """B3 against its plain version (float32 and float64) at the
    registrator's shapes, both modes; CUDA-event times of kernel and plain;
    the row-paired copy it reads; with ``flat_sampler`` (a one-off build of
    an earlier B3 that reads the flat pyramid), that kernel against this one."""
    nb, H, W, n = B3_IMAGES, B3_H, B3_W, B3_OBS
    _, flat, layout, pix, scale = b3_inputs(torch, tps, seed)
    pairs, pair_build = check_pair_build(torch, tps, flat, layout)
    sectors = tap_sectors(torch, layout, pix, scale)
    paired = tap_sectors(torch, layout, pix, scale, paired=True)
    out = {"pair_build": pair_build}
    for derivs in (True, False):
        mode = "derivs" if derivs else "value"
        k = tps.pyramid_sample(flat, layout, pix, scale, derivs, pairs)
        k2 = tps.pyramid_sample(flat, layout, pix, scale, derivs, pairs)
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
        del p32, p64
        times = kernel_ms(lambda: tps.pyramid_sample(flat, layout, pix, scale, derivs, pairs), torch)
        ms = times["ms"]
        plain_ms = cuda_ms(lambda: tps.sample_plain(flat, layout, pix, scale, derivs), torch,
                           warmup=1, reps=5)
        obs = nb * n
        streamed = obs * (8 + 4 + (16 if derivs else 4) + 1)  # pix, scale, outputs, ok
        lo = max(sectors["distinct"] * 32 - L2_BYTES, 0) + streamed
        hi = paired["requests"] * 32 + streamed
        print(f"B3 pyramid_sample {mode}: {nb} images x {W}x{H} x {B3_SCALES} scales "
              f"({flat.numel() * 4 / 1e6:.0f} MB), {obs} observations, ok {float(ok.float().mean()):.3f}; "
              + ", ".join(f"{k_} |k-f32| {a:.3e} |k-f64| {b:.3e}" for k_, (a, b) in errs.items())
              + f"; kernel {ms:.4f} ms ({times['ms_one_launch']:.4f} ms for one launch between its "
              f"events), f32 plain {plain_ms:.4f} ms; taps in the flat pyramid touch "
              f"{sectors['requests'] / obs:.3f} sectors/obs, {sectors['distinct']} distinct; in the "
              f"row-paired copy {paired['requests'] / obs:.3f} sectors/obs, {paired['distinct']} "
              f"distinct; bytes from the inputs: >= {lo / 1e9:.3f} GB from DRAM (distinct flat "
              f"sectors - L2 + streamed) -> >= {lo / ms / 1e6:.1f} GB/s; <= {hi / 1e9:.3f} GB if "
              f"every paired sector request missed L2 -> {hi / ms / 1e6:.1f} GB/s")
        # the bound counts what these inputs need: every distinct sector of the
        # flat pyramid once, whatever layout the kernel reads
        out[mode] = {"max_abs_err": max(a for a, _ in errs.values()), **times,
                     "plain_ms": plain_ms, "sectors_per_obs": paired["requests"] / obs,
                     "flat_sectors_per_obs": sectors["requests"] / obs,
                     **bound(sectors["distinct"] * 32 + streamed, 100 * obs), "library_ms": None}
    if flat_sampler is not None:
        out["flat_sampler"] = compare_b3_with_flat_sampler(torch, tps, flat_sampler, flat, layout, pix,
                                                           scale, pairs, "the smoke")
    return out


def load_oneoff(kernels, source: str, entry: str, argtypes):
    """An earlier kernel built from ``source`` into a library of its own
    beside the kernels' build (the card's copy of the repository has no git
    history: put the file under the git-ignored ``build/`` first; a header it
    includes is found beside it, then in ``csrc/``): its entry point ``entry``
    typed with ``argtypes``, and the library's path."""
    import ctypes
    import hashlib

    out_dir = os.path.join(os.path.dirname(kernels.BUILD_ROOT), "oneoff")
    os.makedirs(out_dir, exist_ok=True)
    with open(source, "rb") as f:  # by content: two sources of one name never share a library
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    lib = os.path.join(out_dir, f"lib{os.path.splitext(os.path.basename(source))[0]}-{tag}.so")
    r = subprocess.run([kernels.find_nvcc(), *kernels.COMPILE_FLAGS, f"-I{kernels.CSRC}", "-shared", "-o",
                        lib, os.path.abspath(source)], capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"the one-off build of {source} failed:\n{r.stdout}{r.stderr}")
    fn = getattr(ctypes.CDLL(lib), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    print(f"one-off build of {source}: {lib}")
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    return fn, lib


def flat_b3(torch, fn, flat, layout, pix, scale, derivs: bool):
    """The earlier B3 on the flat pyramid, called as its wrapper called it."""
    import ctypes

    nb, n = scale.shape
    L = layout.levels
    value = torch.empty((nb, n), dtype=torch.float32, device=flat.device)
    ok = torch.empty((nb, n), dtype=torch.bool, device=flat.device)
    d = [torch.empty_like(value) for _ in range(3)] if derivs else []
    err = fn(flat.data_ptr(), layout.total, nb, (ctypes.c_int * L)(*layout.hs),
             (ctypes.c_int * L)(*layout.ws), (ctypes.c_longlong * L)(*layout.offs), L,
             pix.data_ptr(), scale.data_ptr(), n, int(derivs), value.data_ptr(),
             *([x.data_ptr() for x in d] or [None] * 3), ok.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"the flat-pyramid B3: launch error {err}")
    return (value, *d, ok)


def compare_b3_with_flat_sampler(torch, tps, fn, flat, layout, pix, scale, pairs, label: str):
    """The flat-pyramid B3 and this one on the same inputs: every output
    bit-equal in both modes; derivs-mode times in turns (flat, this, this,
    flat)."""
    for derivs in (True, False):
        old = flat_b3(torch, fn, flat, layout, pix, scale, derivs)
        new = tps.pyramid_sample(flat, layout, pix, scale, derivs, pairs)
        if any(not torch.equal(a, b) for a, b in zip(old, new)):
            fail(f"B3 at {label}'s inputs ({'derivs' if derivs else 'value'}): the outputs differ "
                 "from the flat-pyramid kernel's")
    (o1, o2), (n1, n2) = in_turns(lambda: flat_b3(torch, fn, flat, layout, pix, scale, True),
                                  lambda: tps.pyramid_sample(flat, layout, pix, scale, True, pairs),
                                  torch, {"inner": 10}, {"inner": 10})
    print(f"B3 against the flat-pyramid kernel at {label}'s inputs: every output bit-equal in both "
          f"modes; derivs mode in turns, ten launches per event pair: flat {o1:.4f} / {o2:.4f} ms, "
          f"row-paired {n1:.4f} / "
          f"{n2:.4f} ms ({(o1 + o2) / (n1 + n2):.3f}x)")
    return {"flat_ms": [o1, o2], "ms": [n1, n2]}


def tap_sectors(torch, layout, pix, scale, paired: bool = False):
    """The 32-byte sectors the taps read (2 rows x 2 columns in each of the 2
    bracketing levels) in the flat pyramid, or with ``paired`` in the
    row-paired copy the kernel reads (16 contiguous bytes a level): the sum
    over observations of each one's distinct sectors (``requests``), and the
    distinct sectors over the launch (``distinct``), each of which DRAM must
    deliver at least once, less what L2 holds from before."""
    nb, n = scale.shape
    dev = pix.device
    L = layout.levels
    # as the kernel: a non-finite scale takes levels (0, 1), a NaN coordinate clips to 0
    si = torch.where(torch.isfinite(scale), torch.clamp(torch.floor(torch.nan_to_num(scale)) + 1, 1, L - 1),
                     torch.ones_like(scale)).long()
    hs, ws = torch.tensor(layout.hs, device=dev), torch.tensor(layout.ws, device=dev)
    offs = torch.tensor(layout.pair_offs if paired else layout.offs, device=dev)
    img = torch.arange(nb, device=dev)[:, None] * (layout.pair_total if paired else layout.total)
    ids = []
    for lvl in (si, si - 1):
        f = torch.pow(2.0, -lvl.float())
        W, H = ws[lvl], hs[lvl]
        x, y = (torch.nan_to_num(torch.floor(f * (pix[..., i] + 0.5) - 0.5), nan=0.0) for i in (0, 1))
        ix = torch.minimum(torch.clamp(x, min=0), W - 2)
        iy = torch.minimum(torch.clamp(y, min=0), H - 2)
        if paired:
            base = img + offs[lvl] + iy.long() * ((2 * W + 3) // 4 * 4) + 2 * ix.long()
            ids += [base // 8, (base + 3) // 8]  # 8 floats per sector
            continue
        base = img + offs[lvl] + iy.long() * W + ix.long()
        for row in (base, base + W):
            ids += [row // 8, (row + 1) // 8]
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


def b3_input_stats(torch, layout, pix, scale) -> str:
    """Where a launch's observations fall: the share inside the image, and
    the share per bracketing level pair (si - 1, si)."""
    L = layout.levels
    inside = ((pix[..., 0] >= 0) & (pix[..., 0] <= layout.ws[0] - 1)
              & (pix[..., 1] >= 0) & (pix[..., 1] <= layout.hs[0] - 1))
    si = torch.clamp(torch.floor(torch.nan_to_num(scale, nan=0.0)) + 1, 1, max(L - 1, 1)).long()
    share = torch.bincount(si.reshape(-1), minlength=L).double() / si.numel()
    return (f"{float(inside.double().mean()):.3f} inside the image; levels (si-1, si) share "
            + ", ".join(f"({s - 1},{s}) {float(share[s]):.3f}" for s in range(1, L)))


def check_b3_at_captured(torch, tps, cap: dict, label: str, flat_sampler=None):
    """B3 in derivs mode at a launch's own inputs against its float32 plain
    version (the value within B3_VALUE_TOL, the derivatives within
    B3_DERIV_TOL), its time and tap sectors there, and with ``flat_sampler`` the
    flat-pyramid kernel against it there."""
    flat, layout = cap["flat"].cuda(), cap["layout"]
    pix, scale = cap["pix"].cuda(), cap["scale"].cuda()
    nb, n = scale.shape
    pairs = tps.pair_rows(flat, layout)
    sectors = tap_sectors(torch, layout, pix, scale)
    paired = tap_sectors(torch, layout, pix, scale, paired=True)
    k = tps.pyramid_sample(flat, layout, pix, scale, True, pairs)
    ok = k[-1]
    p32 = tps.sample_plain(flat, layout, pix, scale, True)
    if not torch.equal(ok, p32[-1]):
        fail(f"B3 at {label}'s inputs: ok differs from the f32 plain version")
    errs = [float((a - b)[ok].abs().max()) if bool(ok.any()) else 0.0 for a, b in zip(k[:-1], p32[:-1])]
    err_value, err = errs[0], max(errs)
    if not err_value <= B3_VALUE_TOL:
        fail(f"B3 derivs mode at {label}'s inputs: value max|k - plain| {err_value:.3e} > {B3_VALUE_TOL}")
    if not err <= B3_DERIV_TOL:
        fail(f"B3 derivs mode at {label}'s inputs: max|k - plain| {err:.3e} > {B3_DERIV_TOL}")
    times = kernel_ms(lambda: tps.pyramid_sample(flat, layout, pix, scale, True, pairs), torch)
    obs = nb * n
    streamed = obs * (8 + 4 + 16 + 1)
    b = bound(sectors["distinct"] * 32 + streamed, 100 * obs)
    print(f"B3 pyramid_sample derivs at {label}'s inputs: {nb} images, levels "
          f"{list(zip(layout.ws, layout.hs))}, {obs} observations ({b3_input_stats(torch, layout, pix, scale)}), "
          f"ok {float(ok.float().mean()):.3f}; max|k - f32 plain| where ok {err:.3e} (value "
          f"{err_value:.3e}); kernel "
          f"{times['ms']:.4f} ms ({times['ms_one_launch']:.4f} ms for one launch between its events); "
          f"taps in the flat pyramid touch {sectors['requests'] / obs:.3f} sectors/obs, "
          f"{sectors['distinct']} distinct ({sectors['distinct'] / obs:.3f}/obs); in the row-paired "
          f"copy {paired['requests'] / obs:.3f} sectors/obs, {paired['distinct']} distinct; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    res = {"obs": obs, "max_abs_err": err, "max_abs_err_value": err_value, **times, **b,
           "sectors_per_obs": paired["requests"] / obs, "flat_sectors_per_obs": sectors["requests"] / obs, "distinct_sectors": sectors["distinct"]}
    if flat_sampler is not None:
        res["flat_sampler"] = compare_b3_with_flat_sampler(torch, tps, flat_sampler, flat, layout, pix,
                                                           scale, pairs, label)
    return res


def run_registrator_dslr(torch, kernels, image_registrator, optimizer, synthetic, cio,
                         quat_to_matrix_np, root: str):
    """The DSLR configuration through the CLI at full resolution. The inputs
    of the run's first derivs-mode B3 launch, of its first H,b geometry
    kernel launch in ``jacobian`` mode and of its first Gram kernel call are
    kept (the large ones on the host, so that the peak device memory is the
    run's own) and returned. Every geometry row of the run is the kernel's
    (the scene's camera is PINHOLE), and every Gram row."""
    from dataset_pipeline_tpu_torch.utils.timing import stages_text

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
    captured, geometry, gram = {}, {}, {}
    sample, jacobian = optimizer.pyramid_sample, optimizer.hb_geometry.jacobian
    gram_assemble = optimizer.hb_gram.gram_assemble

    def keep_first(flat, layout, pix, scale, with_derivs=True, **kw):
        if with_derivs and not captured:
            captured.update(flat=flat.cpu(), layout=layout, pix=pix.cpu(), scale=scale.cpu())
        return sample(flat, layout, pix, scale, with_derivs, **kw)

    def keep_geometry(camera, params, q, t, points, radius, dpx, dpy, dvds, oi, ds):
        if not geometry:
            geometry.update(camera=camera, params=params.clone(), q=q.clone(), t=t.clone(),
                            points=points.cpu(), radius=radius, dpx=dpx.cpu(), dpy=dpy.cpu(),
                            dvds=dvds.cpu(), optimize_intrinsics=oi, dynamic_scale=ds)
        return jacobian(camera, params, q, t, points, radius, dpx, dpy, dvds, oi, ds)

    keep_gram = gram_keeper(gram, gram_assemble)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    optimizer.pyramid_sample = keep_first  # for this run only
    optimizer.hb_geometry.jacobian = keep_geometry
    optimizer.hb_gram.gram_assemble = keep_gram
    t0 = time.perf_counter()
    try:
        rc = image_registrator.main(registrator_args(
            root, out, "cuda", ["--initial_scaling_factor", "1", "--target_scaling_factor", "1",
                                "--merge_distance_factor", str(c["merge_distance_factor"]),
                                "--multi_res_point_cloud_directory_path", os.path.join(root, "cache")]),
            timings=timings, stats=stats)
        torch.cuda.synchronize()
    finally:
        optimizer.pyramid_sample = sample
        optimizer.hb_geometry.jacobian = jacobian
        optimizer.hb_gram.gram_assemble = gram_assemble
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in REG_KERNELS}
    if rc != 0:
        fail(f"image_registrator returned {rc}")
    rows, kernel_rows, gram_rows = (timings.get(f"hb_accumulate.{k}", 0)
                                    for k in ("rows", "geometry_kernel_rows", "gram_kernel_rows"))
    after = pose_errors(os.path.join(out, "scale_1_state"), tq, tt, cio, quat_to_matrix_np)
    sc = stats["scales"][-1]
    tj = json.load(open(os.path.join(out, "timing.json")))
    opt_s = tj["optimize_scale_0"]["total_s"]
    obs = sc["observations"]
    print("DSLR stages (s): " + ", ".join(f"{k} {v['total_s']:.3f}" for k, v in tj.items())
          + "; optimizer: " + stages_text(timings)
          + f"; wall {wall:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"DSLR: levels {stats['levels']} ({sum(stats['levels'])} points); observations per "
          f"iteration {obs}; {opt_s / sc['iterations']:.3f} s/iteration, "
          f"{sum(obs) / opt_s:.4g} observations/s; costs {sc['iteration_costs']} -> optimum "
          f"{sc['optimum_cost']:.6f}; pose error (mm at 5 m) mean {1e3 * before.mean():.3f} -> "
          f"{1e3 * after.mean():.3f}; launches {launches}; geometry rows by the kernel "
          f"{kernel_rows} of {rows}; Gram rows by the kernel {gram_rows}")
    if not 0 < kernel_rows == rows:
        fail(f"DSLR: the H,b geometry kernel computed {kernel_rows} of {rows} geometry rows")
    if not 0 < gram_rows == rows:
        fail(f"DSLR: the H,b Gram kernel computed {gram_rows} of {rows} rows")
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
    if not captured:
        fail("DSLR: no derivs-mode B3 launch to keep the inputs of")
    if not gram:
        fail("DSLR: no Gram kernel call to keep the inputs of")
    return launches, captured, (tq, tt), geometry, gram


def gram_keeper(kept: dict, gram_assemble):
    """``ops/hb_gram.py:gram_assemble`` keeping its first call's inputs in
    ``kept``, all on the host, so that the peak device memory is the run's
    own."""

    def keep(J, inten, ok, neighbors, desc, contrib):
        if not kept:
            kept.update(J=J.cpu(), inten=inten.cpu(), ok=ok.cpu(), neighbors=neighbors.cpu(),
                        desc=desc.cpu(), contrib=contrib.cpu())
        return gram_assemble(J, inten, ok, neighbors, desc, contrib)

    return keep


def hb_pix_tolerance(torch, q, t, pts, f, lens: bool = False):
    """Float32 rounding of the projection per row (as tests/test_torch_cuda.py
    bounds it): the camera-frame point is good to a few ulps of the largest
    coordinate that made it, and the pixel is f (p.xy / z): an error e in p
    moves it by f e (1 + |p.xy / z|) / |z|. A fisheye lens doubles that (its
    slope is below 2) and adds a few ulps of its own arithmetic."""
    from dataset_pipeline_tpu_torch.models.lie import SE3

    p = SE3(q[:, None].double(), t[:, None].double()).apply(pts.double())
    big = torch.maximum(pts.double().abs().amax(-1), t.double().abs().amax(-1)[:, None])
    n = (p[..., :2] / p[..., 2:]).abs().amax(-1)
    tol = (HB_PIX_ULPS * 2.0 ** -24 * float(f) * big * (1 + n) / p[..., 2].abs())[..., None]
    return 2 * tol + 16 * 2.0 ** -24 * float(f) * (1 + n)[..., None] if lens else tol


HB_LENS_ORACLE_POINTS = 1 << 20  # points per block of the float64 oracle under a lens


def run_registrator_lens(torch, kernels, optimizer, seed: int = 19):
    """One LM iteration of the benchmark's fisheye cell (``perfbench``'s
    ``dslr_fisheye.full_res``: ETH3D's THIN_PRISM_FISHEYE DSLR camera at
    6048x4032, built by ``make_optimizer`` as the ImageRegistrator CLI
    builds it) from the seed's start state. Returns its launch counts and
    the inputs of its first H,b geometry ``jacobian`` launch (the large ones
    on the host) and of its first Gram kernel call. Every geometry row is the
    kernel's, and every Gram row."""
    from perfbench import harness
    from perfbench.drivers.register_fisheye import build
    from perfbench.scene.dslr_fisheye import make_scene

    t0 = time.perf_counter()
    cfg = harness.load_json("configs", "eth3d_dslr_fisheye_register")
    scene = make_scene(cfg["scene"], seed, "cuda", levels=True)
    opt, _ = build(scene, cfg, "cuda")
    del scene
    torch.cuda.synchronize()
    set_up = time.perf_counter() - t0
    geometry, jacobian = {}, optimizer.hb_geometry.jacobian

    def keep_geometry(camera, params, q, t, points, radius, dpx, dpy, dvds, oi, ds):
        if not geometry:
            geometry.update(camera=camera, params=params.clone(), q=q.clone(), t=t.clone(),
                            points=points.cpu(), radius=radius, dpx=dpx.cpu(), dpy=dpy.cpu(),
                            dvds=dvds.cpu(), optimize_intrinsics=oi, dynamic_scale=ds)
        return jacobian(camera, params, q, t, points, radius, dpx, dpy, dvds, oi, ds)

    gram, gram_assemble = {}, optimizer.hb_gram.gram_assemble
    timings = {}
    opt.timings = timings
    opt.current_scale = 0
    kernels.reset_launch_counts()
    optimizer.hb_geometry.jacobian = keep_geometry  # for this run only
    optimizer.hb_gram.gram_assemble = gram_keeper(gram, gram_assemble)
    t0 = time.perf_counter()
    try:
        opt.run_on_current_scale(max_iterations=1)
        torch.cuda.synchronize()
    finally:
        optimizer.hb_geometry.jacobian = jacobian
        optimizer.hb_gram.gram_assemble = gram_assemble
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in REG_KERNELS}
    rows, kernel_rows, gram_rows = (timings.get(f"hb_accumulate.{k}", 0)
                                    for k in ("rows", "geometry_kernel_rows", "gram_kernel_rows"))
    W, H = cfg["scene"]["image_size"]
    print(f"fisheye registrator (THIN_PRISM_FISHEYE, {W}x{H}, seed {seed}): set-up {set_up:.1f} s, "
          f"one LM iteration with its refresh and final cost {wall:.3f} s; launches {launches}; "
          f"geometry rows by the kernel {kernel_rows} of {rows}; Gram rows by the kernel {gram_rows}")
    if not 0 < kernel_rows == rows:
        fail(f"fisheye registrator: the H,b geometry kernel computed {kernel_rows} of {rows} rows")
    if not 0 < gram_rows == rows:
        fail(f"fisheye registrator: the H,b Gram kernel computed {gram_rows} of {rows} rows")
    if not geometry or not gram:
        fail("fisheye registrator: no H,b geometry jacobian launch or Gram call to keep the inputs of")
    del opt
    return launches, geometry, gram


def check_hb_geometry(torch, hg, cap: dict, label: str):
    """The H,b geometry kernel's two modes at ``cap``'s inputs against the
    plain version (``torch.func.jvp`` under ``vmap``): valid equal, pix
    within the projection's float32 rounding, J within HB_J_RTOL on valid
    rows; each mode's CUDA-event times beside its bound in bytes (project:
    12 B a point read, pix and valid 9 B a row written; jacobian: 12 B a
    point, B3's derivatives 12 B a row (8 without the footprint row) read,
    4 V B a row written), and the plain version's time. Under a fisheye
    lens, which the kernel takes in float64, J is held to the plain version
    in float64, in blocks of HB_LENS_ORACLE_POINTS points."""
    cam, params, q, t, r = cap["camera"], cap["params"], cap["q"], cap["t"], cap["radius"]
    oi, ds = cap["optimize_intrinsics"], cap["dynamic_scale"]
    pts = cap["points"].cuda()
    dpx, dpy, dvds = (cap[k].cuda() for k in ("dpx", "dpy", "dvds"))
    nb, M = dpx.shape
    V = (params.shape[0] if oi else 0) + 6
    lens = cam.spec.fisheye

    def project():
        return hg.project(cam, params, q, t, pts)

    def jacobian():
        return hg.jacobian(cam, params, q, t, pts, r, dpx, dpy, dvds, oi, ds)

    def plain():
        pix, _ = hg.project_plain(cam, params, q, t, pts)
        return pix, hg.jacobian_plain(cam, params, q, t, pts, r, dpx, dpy, dvds, oi, ds)

    pix, valid = project()
    J = jacobian()
    if not (torch.equal(pix, project()[0]) and torch.equal(J, jacobian())):
        fail(f"H,b geometry at {label}: two identical launches disagree")
    pix_p, valid_p = hg.project_plain(cam, params, q, t, pts)
    if not torch.equal(valid, valid_p):
        fail(f"H,b geometry at {label}: valid differs from the plain version in "
             f"{int((valid != valid_p).sum())} rows")
    pix_err = ((pix.double() - pix_p.double()).abs()
               / hb_pix_tolerance(torch, q, t, pts, params[0], lens))
    pix_err = float(pix_err[valid_p].max())
    del pix_p
    if lens:
        import dataclasses

        # every row, in blocks of points, against the plain version in float64
        c64 = dataclasses.replace(cam, params=params.double())
        J_p = torch.empty((nb, M, V), dtype=torch.float64, device=J.device)
        for a in range(0, M, HB_LENS_ORACLE_POINTS):
            sl = slice(a, a + HB_LENS_ORACLE_POINTS)
            J_p[:, sl] = hg.jacobian_plain(
                c64, c64.params, q.double(), t.double(),
                (pts[:, sl] if pts.dim() == 3 else pts[sl]).double(), r, dpx[:, sl].double(),
                dpy[:, sl].double(), dvds[:, sl].double(), oi, ds)
        Jpv = J_p[valid_p]
    else:
        J_p = hg.jacobian_plain(cam, params, q, t, pts, r, dpx, dpy, dvds, oi, ds)
        Jpv = J_p[valid_p].double()
    del J_p
    Jv = J[valid_p].double()
    J_err = float(((Jv - Jpv).abs() / (HB_J_RTOL * (Jpv.abs() + 1e-3 * Jpv.abs().amax(0)))).max())
    finite = bool(torch.isfinite(Jv).all())
    del Jv, Jpv
    rows = nb * M
    point_rows = rows if pts.dim() == 3 else M
    res = {"images": nb, "points": M, "rows": rows, "valid_rows": int(valid_p.sum()), "V": V,
           "dynamic_scale": bool(ds), "optimize_intrinsics": bool(oi),
           "pix_err_over_tolerance": pix_err, "J_err_over_tolerance": J_err, "library_ms": None}
    torch.cuda.empty_cache()
    res.update(kernel_ms(jacobian, torch), **bound(12 * point_rows + (8 + 4 * ds + 4 * V) * rows, 0))
    res["project"] = {**kernel_ms(project, torch), **bound(12 * point_rows + 9 * rows, 0)}
    res["plain_ms"] = cuda_ms(plain, torch, warmup=1, reps=3)  # both modes, as _hb_batch ran them
    print(f"H,b geometry kernel ({cam.spec.name}) at {label} ({nb} images x {M} points, V = {V}, footprint row "
          f"{bool(ds)}): pix / tolerance max {pix_err:.3f}, J / tolerance max {J_err:.3f} on "
          f"{res['valid_rows']} valid rows; project {res['project']['ms']:.4f} ms (one launch "
          f"{res['project']['ms_one_launch']:.4f}, bound {res['project']['bound_ms']:.4f}), jacobian "
          f"{res['ms']:.4f} ms (one launch {res['ms_one_launch']:.4f}, bound {res['bound_ms']:.4f}); "
          f"the plain version {res['plain_ms']:.2f} ms for both")
    if not (pix_err <= 1.0 and J_err <= 1.0 and finite):
        fail(f"H,b geometry at {label}: the kernel is off the plain version (pix {pix_err:.3f}, J "
             f"{J_err:.3f} of their tolerances, J finite {finite})")
    return res


def check_hb_gram(torch, optimizer, cap: dict, label: str):
    """The H,b Gram kernel (``ops/hb_gram.py``) at ``cap``'s inputs (brought
    back to the card) against the plain ``gram_assemble_plain`` with J in
    float64, image by image (``hb_gram.oracle``): the count equal, H within
    HB_GRAM_RTOL of sqrt(H_ii H_jj), b within HB_GRAM_RTOL of its largest
    entry on that scale, the cost within HB_GRAM_COST_RTOL
    (``hb_gram.gaps``, as the card tests measure them); two launches
    bit-equal. CUDA-event times beside the bound from the launch's inputs
    alone: bytes, every row's intensity, validity and contribution flag
    (6 B), the neighbour lists and descriptors (12 B a neighbour, once per
    point when the images share them) and J's row of each residual row
    (4 V B); operations, (V^2 + 5 V) per neighbour of a residual row (the
    upper triangle and b as FMAs, D and w D). And the plain version's time
    in float32."""
    hg = optimizer.hb_gram
    J, inten, ok, nbr, desc, contrib = (cap[k].cuda() for k in ("J", "inten", "ok", "neighbors",
                                                                "desc", "contrib"))
    nb, M, V = J.shape
    K = nbr.shape[-1]

    def kernel():
        return hg.gram_assemble(J, inten, ok, nbr, desc, contrib)

    def plain():
        return hg.gram_assemble_plain(J, inten, ok, nbr, desc, contrib)

    out = [x.clone() for x in kernel()]
    if not all(torch.equal(a, b) for a, b in zip(out, kernel())):
        fail(f"H,b Gram at {label}: two identical launches disagree")
    ref = hg.oracle(J, inten, ok, nbr, desc, contrib)
    H_gap, b_gap, cost_gap = hg.gaps(out, ref)
    nr = ref[3]
    del ref
    n_res = int(out[3])
    point_rows = M if nbr.dim() == 2 else nb * M
    res = {"images": nb, "points": M, "rows": nb * M, "residual_rows": n_res, "V": V, "K": K,
           "H_gap": H_gap, "b_gap": b_gap, "cost_gap": cost_gap, "count_equal": n_res == nr,
           "library_ms": None}
    torch.cuda.empty_cache()
    res.update(kernel_ms(kernel, torch),
               **bound(6 * nb * M + 12 * K * point_rows + 4 * V * n_res, K * n_res * (V * V + 5 * V)))
    res["plain_ms"] = cuda_ms(plain, torch, warmup=1, reps=3)
    print(f"H,b Gram kernel at {label} ({nb} images x {M} points, V = {V}, K = {K}, {n_res} residual "
          f"rows): H_gap {H_gap:.3e}, b_gap {b_gap:.3e}, cost_gap {cost_gap:.3e}, count equal "
          f"{n_res == nr}; {res['ms']:.4f} ms (one launch {res['ms_one_launch']:.4f}, bound "
          f"{res['bound_ms']:.4f} by {res['bound_by']}); the plain version {res['plain_ms']:.2f} ms")
    if not (n_res == nr and H_gap <= HB_GRAM_RTOL and b_gap <= HB_GRAM_RTOL
            and cost_gap <= HB_GRAM_COST_RTOL):
        fail(f"H,b Gram at {label}: the kernel is off the plain version (count {n_res} / {nr}, H_gap "
             f"{H_gap:.3e}, b_gap {b_gap:.3e}, cost_gap {cost_gap:.3e})")
    return res


# ---------------------------------------------------------------------------
# Ground truth and rendering (slice 3): no hand-written kernel on this path
# ---------------------------------------------------------------------------

GT_DEPTH_TOL = 1e-3  # m, a ground-truth pixel against the ray-cast surface at its centre
GT_MESH_TOL = 1e-4  # m, the mesh occlusion depth against the ray-cast surface
# The least valid share of a ground-truth map, derived before the first run on
# the card from the points per pixel: the DSLR scan has 200,000 points per m^2
# and a pixel at 5 m covers (5 / 2800)^2 m^2, so a pixel centre's +-0.5 px
# window holds Poisson(0.638) points and is valid with probability
# 1 - exp(-0.638) = 0.472 when every point is kept and visible; 0.9 of that
# leaves room for the 2-view filter at the scan's rim and the depth spread.
GT_MIN_VALID = 0.9 * (1.0 - np.exp(-200_000 * (5.0 / 2800.0) ** 2))
GT_MESH_SPACING = 0.01  # m: a 1 cm edge is ~5.6 px at 5 m, the 8-px raster tier
GT_HOLE = (-0.5, 0.5, -0.4, 0.4)  # m, the rectangle the splat creator's mesh leaves out
GT_SPLATS_IN_HOLE = 0.95
CUBE_POINTS, CUBE_SIZE, CUBE_SAMPLES = 10_000_000, 2048, 100_000  # bench.py:461
CUBE_SMALL = (200_000, 256)
SFM_SCALE, SFM_TOL = 2.0, 1e-4
CPU_GAP_SHARE = 1e-4  # at most this share of depth pixels may differ between CUDA and CPU
SMALL_MLP_TOL = 1e-6


def cube_cloud(n_points, seed=0):
    """A copy of ``bench.py:_cube_cloud``: random directions, distances 1-20."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(1.0, 20.0, n_points).astype(np.float32)
    v = rng.randn(n_points, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    cols = rng.randint(0, 255, (n_points, 3)).astype(np.uint8)
    return v * d[:, None], cols


def read_raw(path: str, h: int, w: int):
    return np.fromfile(path, np.float32).reshape(h, w)


def stage_line(label: str, timings: dict) -> str:
    from dataset_pipeline_tpu_torch.utils.timing import stages_text

    return f"{label} stages (s): " + stages_text(timings)


def check_gt_run(torch, gt, synthetic, state, out: str, c: dict, label: str, mesh: bool):
    """One GroundTruthCreator run's outputs against the ray-cast surface:
    every valid ground-truth pixel within GT_DEPTH_TOL, the valid share at
    least GT_MIN_VALID, the mesh occlusion depth within GT_MESH_TOL on covered
    interior pixels, and every kept point seen in >= 2 images by the port's
    own ``_visible_mask`` (recounted from the written occlusion depths)."""
    from dataset_pipeline_tpu_torch.io.ply import read_ply

    W, H, f = c["width"], c["height"], c["f"]
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    kept = torch.from_numpy(read_ply(os.path.join(out, "scan0.ply")).positions).cuda()
    counts = torch.zeros(len(kept), dtype=torch.int32, device="cuda")
    worst, worst_mesh, least_valid = 0.0, 0.0, 1.0
    for im in state.images:
        truth = synthetic.surface_depth(torch.as_tensor(im.qvec, device="cuda"),
                                        torch.as_tensor(im.tvec, device="cuda"), W, H, f, cx, cy,
                                        synthetic.DEPTH)
        d = torch.from_numpy(read_raw(os.path.join(out, "ground_truth_depth", im.name), H, W)).cuda()
        ok = torch.isfinite(d)
        least_valid = min(least_valid, float(ok.double().mean()))
        worst = max(worst, float((d[ok].double() - truth[ok]).abs().max()))
        od = torch.from_numpy(read_raw(os.path.join(out, "occlusion_depth", im.name), H, W)).cuda()
        if mesh:
            inner = torch.zeros_like(ok)
            inner[4:-4, 4:-4] = True
            cov = inner & (od > 0)
            if float(cov.double().mean()) < 0.9:
                fail(f"{label}: the mesh covers {float(cov.double().mean()):.3f} of {im.name}")
            worst_mesh = max(worst_mesh, float((od[cov].double() - truth[cov]).abs().max()))
        cam = state.cameras[im.camera_id]
        pose = gt._image_pose(im, np.eye(4), "cuda")
        vis, _, _, _ = gt._visible_mask(cam, pose.q, pose.t, kept, od, W, H)
        counts += vis.to(torch.int32)
    least_views = int(counts.min())
    print(f"{label}: ground truth vs the ray-cast surface max |d| {worst * 1e3:.6f} mm; least valid "
          f"share {least_valid:.4f} (bound {GT_MIN_VALID:.4f}); kept {len(kept)} points, least "
          f"views {least_views}" + (f"; mesh occlusion depth max |d| {worst_mesh * 1e3:.6f} mm"
                                    if mesh else ""))
    if not worst <= GT_DEPTH_TOL:
        fail(f"{label}: a ground-truth pixel is {worst:.3e} m from the surface (> {GT_DEPTH_TOL})")
    if not least_valid >= GT_MIN_VALID:
        fail(f"{label}: a ground-truth map is {least_valid:.4f} valid (< {GT_MIN_VALID:.4f})")
    if mesh and not worst_mesh <= GT_MESH_TOL:
        fail(f"{label}: the mesh occlusion depth is {worst_mesh:.3e} m off (> {GT_MESH_TOL})")
    if least_views < 2:
        fail(f"{label}: a kept point is visible in {least_views} image(s)")
    return {"max_abs_m": worst, "least_valid": least_valid, "kept": len(kept)}


def profile_shares(torch, fn, label: str):
    """Device time of ``fn`` under torch.profiler, and the shares of
    ``scatter_reduce_`` and of the raster tiers' ranges in it. The device
    time is counted once, on the host-side events (an op's self device time
    holds the kernels it launched itself; a range's total, those of its ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(5):  # the first call warms; the median of the five is the steady wall
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    total = sum(e.self_device_time_total for e in ev)
    scat = sum(e.self_device_time_total for e in ev if "scatter_reduce" in e.key)
    tiers = sum(e.device_time_total for e in ev if e.key.startswith("mesh_raster.tier"))
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    wall = float(np.median(walls)) * 1e3
    print(f"profile {label}: wall {wall:.3f} ms (median of 5, first {walls[0] * 1e3:.3f}); device "
          f"{total / 1e3:.3f} ms; scatter_reduce_ {scat / max(total, 1):.3f}"
          f", raster tiers {tiers / max(total, 1):.3f}; top ops (ms): "
          + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.3f}" for e in top))
    if total <= 0:
        fail(f"profile {label}: no device time recorded")
    return {"wall_ms": wall, "device_ms": total / 1e3, "scatter_share": scat / total,
            "raster_share": tiers / total}


def check_zbuffer_forms(torch, splat):
    """The z-buffer scatter as shipped (the landing points selected first)
    against the first form (the others routed to a spare slot, as an ``inf``
    or, as the first raster tiers had it, a finite value), at the shapes of
    the splat tiers, the GT z-buffer, the six cube faces and a raster tier,
    on uniform random pixel ids: equal results, times in turns."""
    def spare_slot(flat, z, n_px, finite=False):
        inside = (flat >= 0) & (flat < n_px)
        d = torch.full((n_px + 1,), float("inf"), device="cuda")
        d.scatter_reduce_(0, torch.where(inside, flat, n_px),
                          z if finite else torch.where(inside, z, float("inf")),
                          reduce="amin", include_self=True)
        return d[:n_px]

    g = torch.Generator(device="cuda").manual_seed(12)
    res = {}
    for label, n, n_px, off in (("splat_tiers", 5_647_680, 4 * 3078 * 2054, 0.5),
                                ("gt_zbuffer", 5_647_680, 3072 * 2048, 0.6),
                                ("cube_faces", 60_000_000, 6 * 2048 * 2048, 5 / 6),
                                ("raster_tier8", 25_000_000, 3072 * 2048, 0.75)):
        flat = torch.randint(0, n_px, (n,), generator=g, device="cuda")
        flat = torch.where(torch.rand(n, generator=g, device="cuda") < off, -1, flat)
        z = torch.rand(n, generator=g, device="cuda") + 1.0
        if not torch.equal(spare_slot(flat, z, n_px), splat.zbuffer_min(flat, z, n_px)):
            fail(f"z-buffer forms disagree at {label}")
        first, shipped = in_turns(lambda: spare_slot(flat, z, n_px),
                                  lambda: splat.zbuffer_min(flat, z, n_px), torch, {}, {})
        finite = cuda_ms(lambda: spare_slot(flat, z, n_px, finite=True), torch)
        res[label] = {"spare_slot_ms": first, "shipped_ms": shipped, "spare_finite_ms": finite}
        print(f"z-buffer {label} (n {n}, {n_px} px, {off:.2f} off the buffer): shipped "
              f"{shipped[0]:.3f} / {shipped[1]:.3f} ms, spare slot {first[0]:.3f} / {first[1]:.3f} ms "
              f"(inf), {finite:.3f} ms (finite values)")
        del flat, z
    return res


def run_gt_dslr(torch, synthetic, root: str, truth):
    """(a) GroundTruthCreator at the DSLR configuration's full width, with
    splat occlusion and with a 1 cm surface mesh, then (d) NormalEstimator
    and SplatCreator on the DSLR scan and the GroundTruthCreator with mesh +
    splats."""
    from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
    from dataset_pipeline_tpu_torch.io.state import load_colmap_state
    from dataset_pipeline_tpu_torch.tools import ground_truth_creator as gt
    from dataset_pipeline_tpu_torch.tools import normal_estimator, splat_creator

    c = synthetic.DSLR
    state_dir = os.path.join(root, "state_true")
    synthetic.write_state(state_dir, *truth)
    state = load_colmap_state(state_dir, device="cuda")
    half_w, half_h = synthetic.scan_extent(c["width"], c["height"], c["f"], c["n_images"],
                                           synthetic.DEPTH, c["baseline"])
    t0 = time.perf_counter()
    verts, faces = synthetic.surface_mesh(half_w, half_h, GT_MESH_SPACING, synthetic.DEPTH)
    write_ply(os.path.join(root, "mesh.ply"), PointCloud(verts, faces=faces))
    hv, hf = synthetic.surface_mesh(half_w, half_h, GT_MESH_SPACING, synthetic.DEPTH, hole=GT_HOLE)
    write_ply(os.path.join(root, "mesh_hole.ply"), PointCloud(hv, faces=hf))
    print(f"GT meshes: {len(faces)} faces (1 cm), {len(hf)} with the hole, written in "
          f"{time.perf_counter() - t0:.1f} s")
    base = ["--scan_alignment_path", os.path.join(root, "scene.mlp"), "--state_path", state_dir,
            "--write_occlusion_depth", "1", "--device", "cuda"]
    res = {}
    for label, extra in (("splats", []),
                         ("mesh", ["--occlusion_mesh_path", os.path.join(root, "mesh.ply")])):
        out = os.path.join(root, f"gt_{label}")
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if gt.main(base + ["--output_folder_path", out, *extra], timings=timings) != 0:
            fail(f"ground_truth_creator ({label}) failed")
        wall = time.perf_counter() - t0
        print(stage_line(f"GT DSLR {label}", timings) + f"; wall {wall:.3f} s, "
              f"{wall / len(state.images):.3f} s/image; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        res[label] = check_gt_run(torch, gt, synthetic, state, out, c, f"GT DSLR {label}",
                                  mesh=bool(extra))
        res[label].update(wall_s=wall, stages=timings)
        shutil.rmtree(out)

    # (d) normals, splats where the mesh has a hole, then GT with mesh + splats
    timings = {}
    t0 = time.perf_counter()
    merged = os.path.join(root, "merged.ply")
    if normal_estimator.main(["-i", os.path.join(root, "scene.mlp"), "-o", merged,
                              "--device", "cuda"], timings=timings) != 0:
        fail("normal_estimator failed")
    splats = os.path.join(root, "splats.ply")
    if splat_creator.main(["--point_normal_cloud_path", merged, "--mesh_path",
                           os.path.join(root, "mesh_hole.ply"), "--output_path", splats,
                           "--device", "cuda"], timings=timings) != 0:
        fail("splat_creator failed")
    print(stage_line("normals + splats DSLR", timings)
          + f"; wall {time.perf_counter() - t0:.3f} s")
    centres = read_ply(splats).positions.reshape(-1, 4, 3).mean(1)
    x0, x1, y0, y1 = GT_HOLE
    m = GT_MESH_SPACING
    in_hole = ((centres[:, 0] >= x0 - m) & (centres[:, 0] <= x1 + m)
               & (centres[:, 1] >= y0 - m) & (centres[:, 1] <= y1 + m))
    share = float(in_hole.mean()) if len(centres) else 0.0
    hole_pts = (x1 - x0) * (y1 - y0) * c["scan_density"]
    print(f"splats: {len(centres)} (the hole holds ~{hole_pts:.0f} scan points), "
          f"{share:.4f} of their centres in the hole")
    if len(centres) < 0.5 * hole_pts or share < GT_SPLATS_IN_HOLE:
        fail(f"splats: {len(centres)} splats, {share:.4f} in the hole (< {GT_SPLATS_IN_HOLE})")
    out = os.path.join(root, "gt_mesh_splats")
    timings = {}
    t0 = time.perf_counter()
    if gt.main(base + ["--output_folder_path", out, "--occlusion_mesh_path",
                       os.path.join(root, "mesh_hole.ply"), "--occlusion_splats_path", splats],
               timings=timings) != 0:
        fail("ground_truth_creator (mesh + splats) failed")
    print(stage_line("GT DSLR mesh + splats", timings) + f"; wall {time.perf_counter() - t0:.3f} s")
    res["mesh_splats"] = check_gt_run(torch, gt, synthetic, state, out, c,
                                      "GT DSLR mesh + splats", mesh=False)
    # one image's GT stages under the profiler (mesh occlusion)
    mesh = gt.build_occlusion_mesh(verts, faces, device="cuda")
    im = state.images[len(state.images) // 2]
    cam, pose = state.cameras[im.camera_id], gt._image_pose(im, np.eye(4), "cuda")
    pts = torch.from_numpy(read_ply(os.path.join(root, "scan.ply")).positions).cuda()
    keep = torch.ones(len(pts), dtype=torch.bool, device="cuda")

    def one_image(occlusion_mesh):
        od = gt.render_occlusion_depth(cam, pose, pts, 0.03, occlusion_mesh=occlusion_mesh)
        gt._visible_mask(cam, pose.q, pose.t, pts, od, cam.width, cam.height)
        gt._gt_depth_image(cam, pose.q, pose.t, pts, keep, od, cam.width, cam.height)

    res["profile_splats"] = profile_shares(torch, lambda: one_image(None),
                                           "one DSLR GT image (splat occlusion)")
    res["profile"] = profile_shares(torch, lambda: one_image(mesh), "one DSLR GT image (mesh occlusion)")
    shutil.rmtree(out)
    return res


def run_cube_and_sfm(torch, root: str):
    """(b) CubeMapRenderer at bench.py's size with the raw z-buffer checked
    against an independent sort, (c) SfMScaleEstimator on its faces."""
    from dataset_pipeline_tpu_torch.io import colmap as cio
    from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
    from dataset_pipeline_tpu_torch.ops import splat
    from dataset_pipeline_tpu_torch.tools import cube_map_renderer as cube
    from dataset_pipeline_tpu_torch.tools import sfm_scale_estimator as sfm

    t0 = time.perf_counter()
    pos, cols = cube_cloud(CUBE_POINTS)
    os.makedirs(os.path.join(root, "cube"))
    ply = os.path.join(root, "cube", "scan0.ply")
    write_ply(ply, PointCloud(pos, None, cols))
    print(f"cube cloud: {CUBE_POINTS} points written in {time.perf_counter() - t0:.1f} s")
    timings, stats = {}, {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cube.main(["-c", ply, "-o", ply, "--size", str(CUBE_SIZE), "--device", "cuda"],
                 timings=timings, stats=stats) != 0:
        fail("cube_map_renderer failed")
    wall = time.perf_counter() - t0
    print(stage_line("cube map", timings) + f"; wall {wall:.3f} s, {wall / 6:.3f} s/face; "
          f"flood fill steps {stats['flood_fill_steps']}, unfilled {stats['flood_fill_unfilled']}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if stats["flood_fill_unfilled"] != 0:
        fail(f"cube map: the flood fill left {stats['flood_fill_unfilled']} pixels uncoloured")

    # the raw z-buffer, by the tool's own render call, against a sort of (pixel, z, index)
    S = CUBE_SIZE
    p = cube.face_points(torch.from_numpy(pos).cuda())
    c_dev = torch.from_numpy(cols).cuda()
    raw, rcol = splat.render_points_depth_color(p, c_dev, S, S, S / 2.0, S / 2.0, S // 2, S // 2)
    z = p[..., 2]
    x = (S / 2.0) * p[..., 0] / torch.where(z > 0, z, 1.0) + S // 2
    y = (S / 2.0) * p[..., 1] / torch.where(z > 0, z, 1.0) + S // 2
    ix, iy = torch.floor(x), torch.floor(y)
    ok = (z > 0) & (ix >= 0) & (iy >= 0) & (ix < S) & (iy < S)
    face = torch.arange(6, device="cuda")[:, None].expand_as(z)
    key = torch.where(ok, (face * S + iy.long().clamp(0, S - 1)) * S + ix.long().clamp(0, S - 1),
                      6 * S * S).reshape(-1)
    zz = torch.where(ok, z, float("inf")).reshape(-1)
    order = torch.argsort(zz, stable=True)  # points by index already: then z, then pixel
    order = order[torch.argsort(key[order], stable=True)]
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    win_px, win_pt = ks[first], order[first] % CUBE_POINTS
    keep = win_px < 6 * S * S
    win_px, win_pt, win_z = win_px[keep], win_pt[keep], zz[order][first][keep]
    g = torch.Generator(device="cuda").manual_seed(0)
    sample = torch.randint(0, 6 * S * S, (CUBE_SAMPLES,), generator=g, device="cuda")
    pos_in = torch.searchsorted(win_px, sample)
    hit = (pos_in < len(win_px)) & (win_px[pos_in.clamp(max=len(win_px) - 1)] == sample)
    exp_z = torch.where(hit, win_z[pos_in.clamp(max=len(win_px) - 1)], float("inf"))
    got_z = raw.reshape(-1)[sample]
    bad_z = int((got_z != exp_z).sum())
    exp_c = c_dev[win_pt[pos_in.clamp(max=len(win_px) - 1)]]
    got_c = rcol.reshape(-1, 3)[sample]
    bad_c = int((hit[:, None] & (got_c != exp_c)).any(1).sum())
    depth_file = torch.from_numpy(np.stack([read_raw(f"{ply}.{n}.depth", S, S)
                                            for n in splat.CUBE_FACE_NAMES])).cuda().reshape(-1)
    fin = torch.isfinite(got_z)
    bad_file = int((depth_file[sample][fin] != got_z[fin]).sum())
    print(f"cube map raw z-buffer at {CUBE_SAMPLES} random pixels ({int(hit.sum())} covered): "
          f"{bad_z} depths and {bad_c} colours differ from the sort of (pixel, z, index); "
          f"{bad_file} covered pixels changed by the hole fill")
    if bad_z or bad_c or bad_file:
        fail("cube map: the z-buffer disagrees with the independent sort")
    def one_face():
        d, col = splat.render_points_depth_color(p[:1], c_dev, S, S, S / 2.0, S / 2.0, S // 2, S // 2)
        splat.fill_depth_holes(d)
        splat.flood_fill_colors(*splat.fill_color_from_depth(d, col))

    face_ms = profile_shares(torch, one_face, "one 2048^2 cube face (render and fills)")
    del p, raw, rcol, z, x, y, key, zz, order, ks

    # (c) SfM on the "right" face at a known scale
    rng = np.random.RandomState(77)
    depth = read_raw(f"{ply}.right.depth", S, S)
    ys, xs = np.nonzero(np.isfinite(depth))
    sel = rng.choice(len(ys), size=500, replace=False)
    keyp = np.stack([xs[sel], ys[sel]], -1).astype(np.float64)
    f = cc = S / 2
    zs = depth[ys[sel], xs[sel]]
    pts3 = np.stack([(keyp[:, 0] - cc) / f * zs, (keyp[:, 1] - cc) / f * zs, zs], -1)
    R = splat.CUBE_FACE_ROTATIONS[3]
    w = np.sqrt(1 + np.trace(R)) / 2
    q = np.asarray([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                    (R[1, 0] - R[0, 1]) / (4 * w)])
    sfm_dir = os.path.join(root, "sfm")
    cio.write_model(sfm_dir, cio.ColmapModel(
        {1: cio.ColmapCamera(1, "PINHOLE", S, S, np.asarray([f, f, cc, cc]))},
        {1: cio.ColmapImage(1, q, np.zeros(3), 1, "scan0.ply.right.png", keyp,
                            np.arange(500, dtype=np.int64))},
        {i: cio.ColmapPoint3D(i, (pts3 @ R)[i] / SFM_SCALE, np.zeros(3, np.uint8), 0.1, [(1, i)])
         for i in range(500)}))
    t0 = time.perf_counter()
    cube_dir = os.path.join(root, "cube")
    if sfm.main(["-s", sfm_dir, "-si", cube_dir, "-i", cube_dir,
                 "-o", os.path.join(root, "scaled")]) != 0:
        fail("sfm_scale_estimator failed")
    scale, _, count = sfm.estimate_scale_and_poses(cio.read_model(sfm_dir, read_points=True),
                                                   cube_dir, 1)
    print(f"SfM scale estimator: scale {scale:.9f} from {count} observations (true {SFM_SCALE}) "
          f"in {time.perf_counter() - t0:.3f} s")
    if not abs(scale - SFM_SCALE) <= SFM_TOL:
        fail(f"SfM scale {scale} is not within {SFM_TOL} of {SFM_SCALE}")
    shutil.rmtree(cube_dir)
    return {"wall_s": wall, "stages": timings, **stats, "profile": face_ms}


def compare_depth_dirs(a: str, b: str, label: str):
    """Bit-equality of the raw depth maps of two output folders; returns the
    number of differing pixels and fails above CPU_GAP_SHARE of them."""
    n_px = n_diff = 0
    worst = 0.0
    for d, _, fs in os.walk(a):
        for fname in fs:
            rel = os.path.relpath(os.path.join(d, fname), a)
            if not ("ground_truth_depth" in rel or "occlusion_depth" in rel or rel.endswith(".depth")):
                continue
            x, y = np.fromfile(os.path.join(a, rel), np.float32), np.fromfile(os.path.join(b, rel), np.float32)
            if x.shape != y.shape:
                fail(f"{label}: {rel} differs in size")
            diff = (x != y) & ~(np.isnan(x) & np.isnan(y))
            n_px += x.size
            n_diff += int(diff.sum())
            if diff.any():
                worst = max(worst, float(np.nanmax(np.abs(x[diff].astype(np.float64) - y[diff]))))
    print(f"{label}: CUDA vs CPU depth maps: {n_diff} of {n_px} pixels differ (max {worst:.3e})")
    if n_px == 0 or n_diff > CPU_GAP_SHARE * n_px:
        fail(f"{label}: {n_diff} of {n_px} depth pixels differ between CUDA and CPU")
    return n_diff


def run_small_cuda_vs_cpu(torch, synthetic, root: str):
    """(e) The four device tools on small inputs on the card and on the CPU:
    the same files (depth maps bit for bit, kept clouds and counts, .mlp
    within SMALL_MLP_TOL, splats and normals)."""
    from dataset_pipeline_tpu_torch.io.meshlab import read_meshlab_project
    from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
    from dataset_pipeline_tpu_torch.tools import cube_map_renderer as cube
    from dataset_pipeline_tpu_torch.tools import ground_truth_creator as gt
    from dataset_pipeline_tpu_torch.tools import normal_estimator, splat_creator

    t0 = time.perf_counter()
    half_w, half_h = synthetic.scan_extent(640, 480, 2800.0 * 640 / 3072, 2, synthetic.DEPTH, 0.15)
    verts, faces = synthetic.surface_mesh(half_w, half_h, 0.02, synthetic.DEPTH, hole=GT_HOLE)
    write_ply(os.path.join(root, "mesh_small.ply"), PointCloud(verts, faces=faces))
    outs = {}
    for dev in ("cuda", "cpu"):
        o = os.path.join(root, f"tools_{dev}")
        for extra, sub in (([], "gt"), (["--occlusion_mesh_path", os.path.join(root, "mesh_small.ply")],
                                        "gt_mesh")):
            if gt.main(["--scan_alignment_path", os.path.join(root, "scene.mlp"), "--state_path",
                        os.path.join(root, "state"), "--output_folder_path", os.path.join(o, sub),
                        "--write_occlusion_depth", "1", "--device", dev, *extra]) != 0:
                fail(f"small ground_truth_creator on {dev} failed")
        if normal_estimator.main(["-i", os.path.join(root, "scene.mlp"), "-o",
                                  os.path.join(o, "merged.ply"), "--device", dev]) != 0:
            fail(f"small normal_estimator on {dev} failed")
        # both splat creators read the CPU's normals, so only the splat step is compared
        if splat_creator.main(["--point_normal_cloud_path", os.path.join(root, "tools_cuda", "merged.ply"),
                               "--mesh_path", os.path.join(root, "mesh_small.ply"),
                               "--output_path", os.path.join(o, "splats.ply"), "--device", dev]) != 0:
            fail(f"small splat_creator on {dev} failed")
        os.makedirs(os.path.join(o, "cube"), exist_ok=True)
        if dev == "cuda":
            pos, cols = cube_cloud(CUBE_SMALL[0])
            write_ply(os.path.join(root, "cube_small.ply"), PointCloud(pos, None, cols))
        if cube.main(["-c", os.path.join(root, "cube_small.ply"), "-o",
                      os.path.join(o, "cube", "s.ply"), "--size", str(CUBE_SMALL[1]),
                      "--device", dev]) != 0:
            fail(f"small cube_map_renderer on {dev} failed")
        outs[dev] = o
    a, b = outs["cuda"], outs["cpu"]
    n_diff = compare_depth_dirs(a, b, "small tools")
    for sub in ("gt", "gt_mesh"):
        ka, kb = (read_ply(os.path.join(x, sub, "scan0.ply")).positions for x in (a, b))
        if len(ka) != len(kb) or not np.array_equal(ka, kb):
            fail(f"small {sub}: kept points differ ({len(ka)} on CUDA, {len(kb)} on the CPU)")
        ma, mb = (read_meshlab_project(os.path.join(x, sub, "scan_alignment.mlp"))[0].global_T_mesh
                  for x in (a, b))
        if not np.abs(ma - mb).max() <= SMALL_MLP_TOL:
            fail(f"small {sub}: scan_alignment.mlp differs")
    na, nb = (read_ply(os.path.join(x, "merged.ply")) for x in (a, b))
    n_gap = float(np.abs(na.normals - nb.normals).max())
    sa, sb = (read_ply(os.path.join(x, "splats.ply")) for x in (a, b))
    s_gap = float(np.abs(sa.positions - sb.positions).max()) if len(sa.positions) == len(sb.positions) else np.inf
    for name in sorted(os.listdir(os.path.join(a, "cube"))):
        if name.endswith(".png"):
            from PIL import Image

            if not np.array_equal(np.asarray(Image.open(os.path.join(a, "cube", name))),
                                  np.asarray(Image.open(os.path.join(b, "cube", name)))):
                fail(f"small cube map: {name} differs between CUDA and CPU")
    print(f"small tools CUDA vs CPU ({time.perf_counter() - t0:.1f} s): kept points equal; normals max "
          f"|d| {n_gap:.3e}; splats {len(sa.positions) // 4} vs {len(sb.positions) // 4}, max |d| {s_gap:.3e}")
    if not np.array_equal(na.positions, nb.positions) or not n_gap <= 1e-4:
        fail("small normal_estimator: CUDA and CPU normals differ by more than 1e-4")
    if not s_gap <= SMALL_MLP_TOL:
        fail("small splat_creator: CUDA and CPU splats differ")
    return n_diff


# ---------------------------------------------------------------------------
# Slice 4: the cleaner and the rest of the registrator (B3 on the rig, depth
# and observations-cache paths)
# ---------------------------------------------------------------------------

CLEAN_FILTERS = ("270,1.15", "20,1.15")  # the ETH3D recipe (reference README.md:372)
CLEAN_PLANTED = 0.01  # share of planted points, hovering 4-12 point spacings over the surface
CLEAN_SURFACE_KEPT, CLEAN_PLANTED_KEPT = 0.97, 0.5  # first filter, as tests/test_knn.py:196
CLEAN_AGREE = 0.999  # the card's adaptive-kNN mask against the host kNN's, first filter
# None: the whole DSLR scan; else a cut to the scan's central rectangle holding about this many
# points, at the scan's own density (the planted points keep their 4-12 spacings). Cut to 2 M of
# the 5,647,680 to keep the whole smoke near 800 s (the host kNN at k = 271 took 70-87 s on the
# whole scan); the gates are shares, independent of the count
CLEAN_POINTS = 2_000_000
RIG_DSLR = (-0.2, 0.0, 0.0, 0.0, 0.004, 0.0)  # second camera one baseline to the right, turned 4 mrad
OBS_CHECK_INTERVAL = 3  # the cache's hit rate is measured after the third iteration


class CaptureB3:
    """For one run: keep (on the host) the inputs of the first derivs-mode B3
    launch made inside ``optimizer.<core>`` for which ``want(args)`` holds."""

    def __init__(self, optimizer, core: str, want=lambda args: True):
        self.opt, self.core, self.want = optimizer, core, want
        self.cap, self.inside = {}, False

    def __enter__(self):
        sample, core = self.opt.pyramid_sample, getattr(self.opt, self.core)
        self.saved = (sample, core)

        def sampler(flat, layout, pix, scale, with_derivs=True, **kw):
            if self.inside and with_derivs and not self.cap:
                self.cap.update(flat=flat.cpu(), layout=layout, pix=pix.cpu(), scale=scale.cpu())
            return sample(flat, layout, pix, scale, with_derivs, **kw)

        def wrapped(*args, **kw):
            self.inside = self.want(args)
            try:
                return core(*args, **kw)
            finally:
                self.inside = False

        self.opt.pyramid_sample = sampler
        setattr(self.opt, self.core, wrapped)
        return self.cap

    def __exit__(self, *exc):
        self.opt.pyramid_sample, core = self.saved
        setattr(self.opt, self.core, core)


def b3_launches(kernels):
    return {k: kernels.LAUNCHES[k] for k in REG_KERNELS}


def read_timing(out: str) -> dict:
    return {k: v["total_s"] for k, v in json.load(open(os.path.join(out, "timing.json"))).items()}


def run_cleaner_dslr(torch, root: str):
    """(a) PointCloudCleaner on the DSLR scan with 1 % planted points, the
    ETH3D recipe on the card (the host kNN above 200,000 points); then the
    card's adaptive kNN filter on the same points for the first filter."""
    from dataset_pipeline_tpu_torch.io.ply import PointCloud, read_ply, write_ply
    from dataset_pipeline_tpu_torch.ops import outlier
    from dataset_pipeline_tpu_torch.tools import point_cloud_cleaner
    from dataset_pipeline_tpu_torch.utils import synthetic

    c = synthetic.DSLR
    t0 = time.perf_counter()
    scan = read_ply(os.path.join(root, "scan.ply"))
    surf, cols = scan.positions, scan.colors
    half_w, half_h = synthetic.scan_extent(c["width"], c["height"], c["f"], c["n_images"],
                                           synthetic.DEPTH, c["baseline"])
    if CLEAN_POINTS is not None:
        a = np.sqrt(CLEAN_POINTS / len(surf))
        half_w, half_h = a * half_w, a * half_h
        inside = (np.abs(surf[:, 0]) <= half_w) & (np.abs(surf[:, 1]) <= half_h)
        surf, cols = surf[inside], cols[inside]
    n = len(surf)
    rng = np.random.RandomState(13)
    m = int(CLEAN_PLANTED * n)
    x = torch.from_numpy((rng.rand(m) * 2 - 1) * half_w)
    y = torch.from_numpy((rng.rand(m) * 2 - 1) * half_h)
    gap = rng.uniform(4, 12, m) / np.sqrt(c["scan_density"])  # 4-12 point spacings toward the cameras
    planted = torch.stack([x, y, synthetic.surface_height(x, y, synthetic.DEPTH)
                           - torch.from_numpy(gap)], -1).float().numpy()
    pts = np.concatenate([surf, planted])
    os.makedirs(os.path.join(root, "clean"), exist_ok=True)
    path = os.path.join(root, "clean", "scan.ply")
    write_ply(path, PointCloud(pts, None, np.concatenate([cols, np.zeros((m, 3), np.uint8)])))
    print(f"cleaner input: {n} surface + {m} planted points written in "
          f"{time.perf_counter() - t0:.1f} s")
    masks, timings = [], {}
    remove = point_cloud_cleaner.remove_outliers

    def keep_masks(*a, **kw):
        return remove(*a, masks=masks, **kw)

    point_cloud_cleaner.remove_outliers = keep_masks  # for this run only
    t0 = time.perf_counter()
    try:
        rc = point_cloud_cleaner.main(["--in", path, *[x for f in CLEAN_FILTERS for x in ("--filter", f)],
                                       "--device", "cuda"], timings=timings)
        torch.cuda.synchronize()
    finally:
        point_cloud_cleaner.remove_outliers = remove
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"point_cloud_cleaner returned {rc}")
    first, final = masks[0], masks[-1]
    kept = [(float(mk[:n].mean()), float(mk[n:].mean())) for mk in (first, final)]
    inl = read_ply(os.path.join(root, "clean", "scan.inliers.ply"))
    print(stage_line("cleaner (host kNN, filter on the card)", timings) + f"; wall {wall:.3f} s; "
          f"first filter keeps {kept[0][0]:.5f} of the surface, {kept[0][1]:.5f} of the planted "
          f"points; both filters {kept[1][0]:.5f} / {kept[1][1]:.5f}; {len(inl)} inliers written")
    if len(inl) != int(final.sum()):
        fail("cleaner: the inliers file does not hold the mask's points")
    if not (kept[0][0] > CLEAN_SURFACE_KEPT and kept[0][1] < CLEAN_PLANTED_KEPT):
        fail(f"cleaner: the first filter kept {kept[0]} (surface > {CLEAN_SURFACE_KEPT}, "
             f"planted < {CLEAN_PLANTED_KEPT} required)")
    if not kept[1][1] < CLEAN_PLANTED_KEPT:
        fail(f"cleaner: the recipe kept {kept[1][1]:.4f} of the planted points")
    del inl
    # the first filter again, through the card's exact adaptive kNN
    k, factor = (float(v) for v in CLEAN_FILTERS[0].split(","))
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    dev_pts = torch.from_numpy(pts).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = outlier._outliers_from_adaptive_knn(dev_pts, int(k), factor, stats=stats)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card = card.cpu().numpy()
    differ = int((card != first).sum())
    agree = 1.0 - differ / len(pts)
    print(f"cleaner: the card's adaptive kNN (k = {int(k) + 1}) and filter {card_s:.3f} s "
          f"(cell {stats['cell']:.4g} m, cap {stats['cap']}, {stats['grid_cells']} grid cells, "
          f"grid repairs {stats['grid_repairs']}, brute-force repairs {stats['bruteforce_repairs']}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) against the "
          f"host kNN's {timings.get('knn_host', float('nan')):.3f} s; masks differ at {differ} of "
          f"{len(pts)} points (agree {agree:.6f})")
    if not stats["grid_cells"] < 2 ** 31:
        fail(f"cleaner: {stats['grid_cells']} grid cells reach the int32 cell-id limit")
    if agree < CLEAN_AGREE:
        fail(f"cleaner: the card's mask agrees with the host path's at {agree:.6f} < {CLEAN_AGREE}")
    return {"points": len(pts), "planted": m, "wall_s": wall, "stages": timings, "kept": kept,
            "card_knn_filter_s": card_s, "card_knn": stats, "masks_differ": differ}


def run_registrator_caches(torch, kernels, image_registrator, optimizer, cio, root: str, cache: str):
    """(b) The DSLR configuration twice with both caches (the cloud cache that
    the main DSLR run wrote, the observations cache after the first scale):
    scale 0.5 then 1, three iterations each; the second run loads the
    observations cache the first wrote. B3 is kept at the first derivs
    launch on the views."""
    c_merge = ["--merge_distance_factor", "3.0"]
    make = image_registrator.make_optimizer
    outs, caps, res = [], [], {}

    def checked_often(*a, **kw):
        opt = make(*a, **kw)
        opt.obs_cache_check_interval = OBS_CHECK_INTERVAL
        return opt

    image_registrator.make_optimizer = checked_often
    try:
        for run in (1, 2):
            out = os.path.join(root, f"out_cache{run}")
            kernels.reset_launch_counts()
            stats = {}
            t0 = time.perf_counter()
            with CaptureB3(optimizer, "_hb_batch", lambda a: a[4].dim() == 3) as cap:
                rc = image_registrator.main(registrator_args(
                    root, out, "cuda", ["--initial_scaling_factor", "0.5", "--target_scaling_factor", "1",
                                        *c_merge, "--multi_res_point_cloud_directory_path", cache,
                                        "--cache_observations"]), stats=stats)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                fail(f"registrator with both caches (run {run}) returned {rc}")
            tj = read_timing(out)
            launches = b3_launches(kernels)
            hit = [sc["obs_cache_hit_log"] for sc in stats["scales"]]
            meta = dict(ln.split(" ", 1) for ln in open(os.path.join(
                out, "scale_1_state", "metadata.txt")).read().splitlines())
            print(f"DSLR with both caches, run {run}: wall {wall:.3f} s; stages "
                  + ", ".join(f"{k} {v:.3f}" for k, v in tj.items())
                  + f"; costs {[sc['iteration_costs'] for sc in stats['scales']]}; cache hit rates "
                  f"{hit} (metadata {meta.get('obs_cache_hit_rate')}); launches {launches}")
            if {"build_multiscale_cloud", "determine_point_neighbors"} & set(tj):
                fail(f"run {run} with the cloud cache rebuilt the cloud or the neighbours")
            if any(v <= 0 for v in launches.values()):
                fail(f"the observations-cache run {run} never launched a B3 kernel: {launches}")
            if not cap:
                fail(f"run {run}: no B3 derivs launch on the observations cache's views")
            if "obs_cache_hit_rate" not in meta:
                fail("the scale run on the cache wrote no obs_cache_hit_rate")
            for sc in stats["scales"]:
                if not sc["optimum_cost"] < sc["iteration_costs"][0]:
                    fail(f"run {run}: a scale's optimum is not below its first cost")
            outs.append(out)
            caps.append(dict(cap))
            res[f"run{run}"] = {"wall_s": wall, "stages": tj, "launches": launches, "hit_rates": hit}
    finally:
        image_registrator.make_optimizer = make
    scales, (dq, dt, dp, dc), _ = compare_registrator_states(outs[0], outs[1],
                                                             os.path.join(root, "state"), cio)
    print(f"DSLR with both caches: run 1 vs run 2 ({scales}) qvec {dq:.3e} tvec {dt:.3e} params "
          f"{dp:.3e} px, optimum cost rel {dc:.3e}")
    if not (dq <= REG_Q_TOL and dt <= REG_T_TOL and dp <= REG_PARAM_TOL and dc <= REG_COST_RTOL):
        fail("DSLR with both caches: the run that loaded the caches ended elsewhere")
    res["gaps"] = [dq, dt, dp, dc]
    return res, caps[1]


def run_registrator_rig(torch, kernels, image_registrator, optimizer, synthetic, cio,
                        quat_to_matrix_np, root: str, cache: str):
    """(c) The DSLR scene's 16 images as 8 synchronised sets of a two-camera
    rig (``rigs.json``), from perturbed poses, at scale 0 with the cloud
    cache: the rig core's first derivs launch is kept."""
    c = synthetic.DSLR
    t0 = time.perf_counter()
    n, tq, tt = synthetic.write_scene_at_density(
        root, c["width"], c["height"], c["f"], c["n_images"], c["baseline"], c["scan_density"],
        seed=5, device="cuda", rig=list(RIG_DSLR))
    print(f"rig scene: {c['n_images'] // 2} sets of a two-camera rig, scan {n} points, written in "
          f"{time.perf_counter() - t0:.1f} s")
    before = pose_errors(os.path.join(root, "state"), tq, tt, cio, quat_to_matrix_np)
    out = os.path.join(root, "out")
    kernels.reset_launch_counts()
    stats = {}
    t0 = time.perf_counter()
    with CaptureB3(optimizer, "_hb_rig_batch") as cap:
        rc = image_registrator.main(registrator_args(
            root, out, "cuda", ["--initial_scaling_factor", "1", "--target_scaling_factor", "1",
                                "--merge_distance_factor", str(c["merge_distance_factor"]),
                                "--multi_res_point_cloud_directory_path", cache]), stats=stats)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"rig registrator returned {rc}")
    launches = b3_launches(kernels)
    after = pose_errors(os.path.join(out, "scale_1_state"), tq, tt, cio, quat_to_matrix_np)
    sc = stats["scales"][-1]
    print(f"rig DSLR: wall {wall:.3f} s; stages "
          + ", ".join(f"{k} {v:.3f}" for k, v in read_timing(out).items())
          + f"; costs {sc['iteration_costs']} -> optimum {sc['optimum_cost']:.6f}; pose error "
          f"(mm at 5 m) mean {1e3 * before.mean():.3f} -> {1e3 * after.mean():.3f}; launches {launches}")
    if not os.path.exists(os.path.join(out, "scale_1_state", "rigs.json")):
        fail("rig registrator: no rigs.json beside the exported state")
    if not (sc["optimum_cost"] < sc["iteration_costs"][0] and after.mean() < before.mean()):
        fail("rig registrator: the cost or the pose error did not go down")
    if any(v <= 0 for v in launches.values()) or not cap:
        fail(f"rig registrator: B3 launches {launches}, rig-core launch kept {bool(cap)}")
    return {"wall_s": wall, "launches": launches, "pose_error_mm": [1e3 * before.mean(),
                                                                    1e3 * after.mean()],
            "costs": sc["iteration_costs"], "optimum": sc["optimum_cost"]}, dict(cap)


def run_registrator_depth(torch, kernels, image_registrator, optimizer, synthetic, root: str,
                          cache: str, truth):
    """The depth residuals through the optimizer's API (the CLI gives the
    optimizer no depth maps): the DSLR problem from the cloud cache, depth
    maps ray cast at the true poses, fixed colours and depth weight 1, three
    iterations at scale 0; the depth core's first derivs launch is kept."""
    from dataset_pipeline_tpu_torch.photometric.problem import build_image_pyramid
    from dataset_pipeline_tpu_torch.utils.timing import StageTimer

    c = synthetic.DSLR
    args, params = image_registrator.parse_args(registrator_args(
        root, os.path.join(root, "out_depth"), "cuda",
        ["--depth_residuals_weight", "1", "--multi_res_point_cloud_directory_path", cache]))
    t0 = time.perf_counter()
    problem, _, _, _ = image_registrator.build_problem(args, params, torch.device("cuda"),
                                                       StageTimer(torch.device("cuda")))
    cx, cy = (c["width"] - 1) / 2.0, (c["height"] - 1) / 2.0
    depth_pyramids = []
    for g in problem.groups:
        maps = np.stack([synthetic.surface_depth(
            torch.as_tensor(truth[0][iid - 1], device="cuda"), torch.as_tensor(truth[1][iid - 1], device="cuda"),
            c["width"], c["height"], c["f"], cx, cy, synthetic.DEPTH).float().cpu().numpy()
            for iid in g.image_ids])
        depth_pyramids.append(build_image_pyramid(maps, g.level_count, device="cuda"))
    problem.depth_map_pyramids = depth_pyramids
    kernels.reset_launch_counts()  # the optimizer builds the chunks' row-paired copies
    opt = image_registrator.make_optimizer(problem, args, params)
    print(f"depth problem: cloud cache and {len(depth_pyramids[0][0])} ray-cast depth maps in "
          f"{time.perf_counter() - t0:.1f} s")
    opt.current_scale = 0
    costs = []
    t0 = time.perf_counter()
    with CaptureB3(optimizer, "_hb_depth_batch") as cap:
        report = opt.run_on_current_scale(3, iteration_costs=costs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = b3_launches(kernels)
    print(f"depth residuals (weight 1) on DSLR: 3 iterations {wall:.3f} s; costs {costs} -> optimum "
          f"{report.optimum_cost:.6f}; launches {launches}")
    if not report.optimum_cost < costs[0]:
        fail("depth residuals: the optimum cost is not below the first iteration's")
    if any(v <= 0 for v in launches.values()) or not cap:
        fail(f"depth residuals: B3 launches {launches}, depth-core launch kept {bool(cap)}")
    del opt, problem
    return {"wall_s": wall, "launches": launches, "costs": costs}, dict(cap)


def run_registrator_mesh(torch, kernels, image_registrator, cio, quat_to_matrix_np, root: str,
                         cache: str, truth):
    """(d) The DSLR configuration with the ground-truth phase's 1 cm surface
    mesh as occlusion geometry (``--occlusion_mesh_path``), at scale 0."""
    out = os.path.join(root, "out_mesh")
    kernels.reset_launch_counts()
    stats = {}
    t0 = time.perf_counter()
    rc = image_registrator.main(registrator_args(
        root, out, "cuda", ["--initial_scaling_factor", "1", "--target_scaling_factor", "1",
                            "--merge_distance_factor", "3.0", "--occlusion_mesh_path",
                            os.path.join(root, "mesh.ply"), "--multi_res_point_cloud_directory_path",
                            cache]), stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"mesh-occlusion registrator returned {rc}")
    launches = b3_launches(kernels)
    before = pose_errors(os.path.join(root, "state"), *truth, cio, quat_to_matrix_np)
    after = pose_errors(os.path.join(out, "scale_1_state"), *truth, cio, quat_to_matrix_np)
    sc = stats["scales"][-1]
    print(f"mesh-occlusion DSLR: wall {wall:.3f} s; stages "
          + ", ".join(f"{k} {v:.3f}" for k, v in read_timing(out).items())
          + f"; observations {sc['observations']}; costs {sc['iteration_costs']} -> optimum "
          f"{sc['optimum_cost']:.6f}; pose error mean {1e3 * before.mean():.3f} -> "
          f"{1e3 * after.mean():.3f} mm; launches {launches}")
    if not (sc["optimum_cost"] < sc["iteration_costs"][0] and after.mean() < before.mean()):
        fail("mesh-occlusion registrator: the cost or the pose error did not go down")
    if any(v <= 0 for v in launches.values()):
        fail(f"mesh-occlusion registrator never launched a B3 kernel: {launches}")
    return {"wall_s": wall, "launches": launches, "observations": sc["observations"]}


def run_slice4(torch, kernels, image_registrator, optimizer, synthetic, cio, quat_to_matrix_np,
               tps, root: str, truth):
    """(a)-(d) and the depth residuals; returns (results, B3 launches per
    path, B3 checks at the kept launches)."""
    cache = os.path.join(root, "dslr", "cache")
    res, launches, b3_at = {}, {}, {}
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    res["cleaner"] = run_cleaner_dslr(torch, os.path.join(root, "dslr"))
    torch.cuda.empty_cache()
    print(f"(a) cleaner: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res["caches"], cap = run_registrator_caches(torch, kernels, image_registrator, optimizer, cio,
                                                os.path.join(root, "dslr"), cache)
    launches["registrator_caches"] = res["caches"]["run2"]["launches"]
    b3_at["views"] = check_b3_at_captured(torch, tps, cap, "the cache run's first launch on the views")
    torch.cuda.empty_cache()
    print(f"(b) both caches: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res["depth"], cap = run_registrator_depth(torch, kernels, image_registrator, optimizer, synthetic,
                                              os.path.join(root, "dslr"), cache, truth)
    launches["registrator_depth"] = res["depth"]["launches"]
    b3_at["depth"] = check_b3_at_captured(torch, tps, cap, "the depth core's first launch")
    torch.cuda.empty_cache()
    print(f"depth residuals: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res["mesh"] = run_registrator_mesh(torch, kernels, image_registrator, cio, quat_to_matrix_np,
                                       os.path.join(root, "dslr"), cache, truth)
    launches["registrator_mesh"] = res["mesh"]["launches"]
    torch.cuda.empty_cache()
    print(f"(d) mesh occlusion: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res["rig"], cap = run_registrator_rig(torch, kernels, image_registrator, optimizer, synthetic, cio,
                                          quat_to_matrix_np, os.path.join(root, "rig"), cache)
    launches["registrator_rig"] = res["rig"]["launches"]
    b3_at["rig"] = check_b3_at_captured(torch, tps, cap, "the rig core's first launch")
    torch.cuda.empty_cache()
    print(f"(c) rigs: {time.perf_counter() - t0:.1f} s")
    print(f"slice-4 phase: {time.perf_counter() - t_all:.1f} s")
    return res, launches, b3_at


# ---------------------------------------------------------------------------
# Slice 5: joint multi-scene BA (B3 the only kernel, in both modes)
# ---------------------------------------------------------------------------

# the DSLR configuration as joint-BA scenes: bench.py bench_joint_ba takes 4
# scenes; 2 here, for the host set-up (the greedy merge, 25-41 s a scene)
JBA_SCENES, JBA_IMAGES, JBA_ITERATIONS = 2, 8, 3
JBA_SMALL = (320, 240, 3, 10_000)  # the plain CUDA = CPU scenes: width, height, images, points per scan
# the normal-shift scenes' scan-1 error, a 4 mm shift along the surface normal,
# and the ICP weight at which the system sees it to first order
JBA_SMALL_SCAN1_ERROR, JBA_SMALL_ICP_WEIGHT = (0.0, 0.0, 0.004, 0.0, 0.0, 0.0), "1e6"
JBA_RIG_SMALL = (640, 480, 4, 20_000)  # the rig route: 2 sets of a two-camera rig
JBA_RIG = (-0.06, 0.0, 0.0, 0.0, 0.004, 0.0)  # the small rig's second camera: 6 cm right, 4 mrad


class CaptureB3Modes:
    """For one run: keep (on the host) the inputs of the first B3 launch of
    each mode made through ``module.pyramid_sample``."""

    def __init__(self, *modules):
        self.modules, self.cap = modules, {}

    def __enter__(self):
        self.saved = [m.pyramid_sample for m in self.modules]
        sample = self.saved[0]

        def keep(flat, layout, pix, scale, with_derivs=True, **kw):
            mode = "derivs" if with_derivs else "value"
            if mode not in self.cap:
                self.cap[mode] = dict(flat=flat.cpu(), layout=layout, pix=pix.cpu(), scale=scale.cpu())
            return sample(flat, layout, pix, scale, with_derivs, **kw)

        for m in self.modules:
            m.pyramid_sample = keep
        return self.cap

    def __exit__(self, *exc):
        for m, f in zip(self.modules, self.saved):
            m.pyramid_sample = f


class TimeCalls:
    """Every call of the named methods of ``cls``, in call order: (name, its
    string arguments, seconds, the rise of ``launches()``), the card
    synchronized around each."""

    def __init__(self, torch, cls, names, launches=lambda: 0):
        self.torch, self.cls, self.names, self.launches, self.calls = torch, cls, names, launches, []

    def __enter__(self):
        self.saved = {n: getattr(self.cls, n) for n in self.names}
        for n, f in self.saved.items():
            def timed(obj, *a, _f=f, _n=n, **kw):
                self.torch.cuda.synchronize()
                before, t0 = self.launches(), time.perf_counter()
                out = _f(obj, *a, **kw)
                self.torch.cuda.synchronize()
                self.calls.append((_n, tuple(x for x in a if isinstance(x, str)),
                                   time.perf_counter() - t0, self.launches() - before))
                return out
            setattr(self.cls, n, timed)
        return self.calls

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.cls, n, f)


def check_b3_value_at_captured(torch, tps, cap: dict, label: str):
    """B3 in value mode at a launch's own inputs against its float32 plain
    version, and its time there."""
    flat, layout = cap["flat"].cuda(), cap["layout"]
    pix, scale = cap["pix"].cuda(), cap["scale"].cuda()
    pairs = tps.pair_rows(flat, layout)
    v, ok = tps.pyramid_sample(flat, layout, pix, scale, False, pairs)
    pv, pok = tps.sample_plain(flat, layout, pix, scale, False)
    if not torch.equal(ok, pok):
        fail(f"B3 value mode at {label}'s inputs: ok differs from the plain version")
    err = float((v - pv)[ok].abs().max()) if bool(ok.any()) else 0.0
    if not err <= B3_VALUE_TOL:
        fail(f"B3 value mode at {label}'s inputs: max|k - plain| {err:.3e} > {B3_VALUE_TOL}")
    times = kernel_ms(lambda: tps.pyramid_sample(flat, layout, pix, scale, False, pairs), torch)
    obs = scale.numel()
    b = bound(tap_sectors(torch, layout, pix, scale)["distinct"] * 32 + obs * (8 + 4 + 4 + 1),
              40 * obs)
    print(f"B3 pyramid_sample value at {label}'s inputs: {obs} observations, max|k - f32 plain| "
          f"where ok {err:.3e}; kernel {times['ms']:.4f} ms; bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    return {"obs": obs, "max_abs_err": err, **times, **b}


def joint_scene_errors(torch, out: str, scenes, SE3, cio, quat_to_matrix_np):
    """Per scene: (|log| of scan 1's output pose, i.e. of the correction
    composed with the known error; the per-image pose errors (m at 5 m))."""
    from dataset_pipeline_tpu_torch.io.meshlab import read_meshlab_project

    res = []
    for si, (root, tq, tt) in enumerate(scenes):
        d = os.path.join(out, f"scene_{si}")
        M = read_meshlab_project(os.path.join(d, "scan_alignment.mlp"))[1].global_T_mesh
        e = float(torch.linalg.norm(SE3.from_matrix(torch.from_numpy(M).float()).log()))
        res.append((e, pose_errors(d, tq, tt, cio, quat_to_matrix_np)))
    return res


def scene_args(scenes):
    args = []
    for root, _, _ in scenes:
        args += ["--scene", f"{os.path.join(root, 'scene.mlp')},{os.path.join(root, 'state')},"
                            f"{os.path.join(root, 'images')}"]
    return args


def run_joint_ba_dslr(torch, kernels, jtool, jmod, synthetic, cio, quat_to_matrix_np, root: str):
    """Two DSLR scenes of 8 images (3072x2048, f = 2800), each scanned twice
    at 100,000 points/m^2, scan 1 off by ``synthetic.SCAN1_ERROR``, image
    poses perturbed as in the DSLR cell, through the CLI on the card with its
    defaults and 3 iterations."""
    from dataset_pipeline_tpu_torch.models.lie import SE3

    c = synthetic.DSLR
    t0 = time.perf_counter()
    scenes = []
    for si in range(JBA_SCENES):
        d = os.path.join(root, f"scene{si}")
        n, tq, tt = synthetic.write_scene_at_density(
            d, c["width"], c["height"], c["f"], JBA_IMAGES, c["baseline"], c["scan_density"],
            seed=21 + 10 * si, device="cuda", n_scans=2)
        scenes.append((d, tq, tt))
    print(f"joint-BA scenes: {JBA_SCENES} x {JBA_IMAGES} images {c['width']}x{c['height']}, "
          f"2 scans x {n} points each, written in {time.perf_counter() - t0:.1f} s")
    e0 = float(torch.linalg.norm(torch.as_tensor(synthetic.SCAN1_ERROR, dtype=torch.float64)))
    before = [pose_errors(os.path.join(d, "state"), tq, tt, cio, quat_to_matrix_np)
              for d, tq, tt in scenes]
    out = os.path.join(root, "out")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CaptureB3Modes(jmod) as cap, TimeCalls(torch, jmod.JointBASystem,
                                                ("visibility", "step", "cost")) as calls:
        rc = jtool.main(scene_args(scenes) + [
            "--output_folder_path", out, "--max_iterations", str(JBA_ITERATIONS),
            "--merge_distance_factor", str(c["merge_distance_factor"]), "--device", "cuda"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"joint_ba returned {rc}")
    launches = b3_launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    tj = json.load(open(os.path.join(out, "timing.json")))
    costs = [float(v) for v in open(os.path.join(out, "scene_0", "metadata.txt")).read()
             .splitlines()[2].split()[1:]]
    after = joint_scene_errors(torch, out, scenes, SE3, cio, quat_to_matrix_np)
    per_call = {}
    for name, _, sec, _ in calls:
        per_call.setdefault(name, []).append(round(sec, 4))
    print("joint-BA DSLR stages (s): " + ", ".join(
        f"{k} {v['total_s']:.3f} ({v['count']} calls)" for k, v in tj.items())
        + f"; per call (s): {per_call}; wall {wall:.3f} s; peak device memory {peak:.2f} GiB")
    print(f"joint-BA DSLR: costs {costs}; scan-1 error |log| {e0:.6f} -> "
          f"{[round(e, 6) for e, _ in after]}; mean pose error (mm at 5 m) "
          f"{[round(1e3 * b.mean(), 4) for b in before]} -> "
          f"{[round(1e3 * a.mean(), 4) for _, a in after]}; launches {launches}")
    if not costs[-1] < costs[0]:
        fail("joint-BA DSLR: the cost did not fall")
    # the scan-1 error is recorded, not gated: SCAN1_ERROR is mostly a shift along
    # this nearly flat surface, which the descriptor rows do not see and the ICP
    # rows at the default weight barely see, and the JAX tool leaves it where the
    # port does (tests/test_torch_synthetic_scans.py; ROADMAP C). The normal-shift
    # scenes (run_joint_ba_normal_shift) gate the recovery of a shift it sees.
    if not np.mean([a.mean() for _, a in after]) < np.mean([b.mean() for b in before]):
        fail("joint-BA DSLR: the mean image pose error did not fall")
    for k in ("pyramid_sample_derivs", "pyramid_sample_value", "pyramid_pairs"):
        if launches[k] <= 0:
            fail(f"joint-BA DSLR never launched {k}")
    if set(cap) != {"derivs", "value"}:
        fail(f"joint-BA DSLR: first launches kept for {sorted(cap)}")
    return {"wall_s": wall, "peak_gib": peak, "stages": tj, "per_call_s": per_call,
            "costs": costs, "scan1_error": [e0, [e for e, _ in after]],
            "pose_error_mm": [[1e3 * b.mean() for b in before], [1e3 * a.mean() for _, a in after]],
            "launches": launches}, dict(cap)


def compare_joint_ba_outputs(a_dir: str, b_dir: str, n_scenes: int, cio):
    """Max gaps (.mlp entries, qvec, tvec, camera params, relative cost) of
    two joint-BA runs' outputs."""
    from dataset_pipeline_tpu_torch.io.meshlab import read_meshlab_project

    gaps = [0.0] * 5
    for si in range(n_scenes):
        a, b = os.path.join(a_dir, f"scene_{si}"), os.path.join(b_dir, f"scene_{si}")
        ma = read_meshlab_project(os.path.join(a, "scan_alignment.mlp"))
        mb = read_meshlab_project(os.path.join(b, "scan_alignment.mlp"))
        gaps[0] = max([gaps[0]] + [float(np.abs(x.global_T_mesh - y.global_T_mesh).max())
                                   for x, y in zip(ma, mb)])
        sa, sb = cio.read_model(a), cio.read_model(b)
        gaps[1] = max([gaps[1]] + [float(np.abs(sa.images[i].qvec - sb.images[i].qvec).max())
                                   for i in sa.images])
        gaps[2] = max([gaps[2]] + [float(np.abs(sa.images[i].tvec - sb.images[i].tvec).max())
                                   for i in sa.images])
        gaps[3] = max([gaps[3]] + [float(np.abs(sa.cameras[c].params - sb.cameras[c].params).max())
                                   for c in sa.cameras])
        ca, cb = (np.asarray(open(os.path.join(x, "metadata.txt")).read().splitlines()[2]
                             .split()[1:], np.float64) for x in (a, b))
        gaps[4] = max(gaps[4], float(np.abs(ca - cb).max() / np.abs(ca).max()))
    return gaps


def rig_extrinsic_error(torch, state_dir: str, rig, cio, quat_to_matrix_np, SE3):
    """Mean over the rig's sets of |log(T_cam1 T_cam0^-1 exp(rig)^-1)|."""
    model = cio.read_model(state_dir)
    by_name = {im.name: im for im in model.images.values()}
    true = SE3.exp(torch.as_tensor(rig, dtype=torch.float64)).matrix().numpy()
    errs = []
    for name, im in by_name.items():
        if not name.startswith("cam0/"):
            continue
        other = by_name["cam1/" + name[len("cam0/"):]]
        T = []
        for x in (im, other):
            M = np.eye(4)
            M[:3, :3], M[:3, 3] = quat_to_matrix_np(x.qvec), x.tvec
            T.append(M)
        rel = T[1] @ np.linalg.inv(T[0]) @ np.linalg.inv(true)
        errs.append(float(torch.linalg.norm(SE3.from_matrix(torch.from_numpy(rel).float()).log())))
    return float(np.mean(errs))


def run_joint_ba_small(torch, kernels, jtool, synthetic, cio, quat_to_matrix_np, root: str,
                       rig: bool):
    """A small joint-BA run through the CLI on CUDA and on the CPU (plain
    versions), held to the registrator's limits: the plain route on two
    two-scan scenes, or the rig route on one two-camera rig scene."""
    from dataset_pipeline_tpu_torch.models.lie import SE3

    w, h, n_img, n_pts = JBA_RIG_SMALL if rig else JBA_SMALL
    scenes = []
    for si in range(1 if rig else 2):
        d = os.path.join(root, f"scene{si}")
        tq, tt = synthetic.write_scene(d, w, h, 2800.0 * w / 3072, n_img, n_pts, seed=31 + 10 * si,
                                       device="cuda", rig=list(JBA_RIG) if rig else None, n_scans=2)
        scenes.append((d, tq, tt))
    label = "rig" if rig else "plain"
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if jtool.main(scene_args(scenes) + ["--output_folder_path", os.path.join(root, dev),
                                            "--max_iterations", str(JBA_ITERATIONS),
                                            "--device", dev]) != 0:
            fail(f"joint-BA {label} scene on {dev} failed")
        if dev == "cuda":
            launches = b3_launches(kernels)
            wall = time.perf_counter() - t0
    dm, dq, dt, dp, dc = compare_joint_ba_outputs(os.path.join(root, "cuda"), os.path.join(root, "cpu"),
                                                  len(scenes), cio)
    costs = [float(v) for v in open(os.path.join(root, "cuda", "scene_0", "metadata.txt")).read()
             .splitlines()[2].split()[1:]]
    res = {"launches": launches, "wall_s": wall, "costs": costs,
           "cuda_vs_cpu": {"mlp": dm, "qvec": dq, "tvec": dt, "params": dp, "cost_rel": dc}}
    msg = (f"joint-BA {label} scene ({len(scenes)} x {n_img} images {w}x{h}): CUDA vs CPU .mlp {dm:.3e} "
           f"qvec {dq:.3e} tvec {dt:.3e} params {dp:.3e} px cost rel {dc:.3e}; costs {costs}; "
           f"launches {launches}")
    if rig:
        res["extrinsic_error"] = [
            rig_extrinsic_error(torch, os.path.join(scenes[0][0], "state"), JBA_RIG, cio,
                                quat_to_matrix_np, SE3),
            rig_extrinsic_error(torch, os.path.join(root, "cuda", "scene_0"), JBA_RIG, cio,
                                quat_to_matrix_np, SE3)]
        msg += f"; extrinsic error {res['extrinsic_error'][0]:.3e} -> {res['extrinsic_error'][1]:.3e}"
    print(msg)
    if not (dm <= REG_T_TOL and dq <= REG_Q_TOL and dt <= REG_T_TOL and dp <= REG_PARAM_TOL
            and dc <= REG_COST_RTOL):
        fail(f"joint-BA {label} scene: CUDA and CPU runs differ beyond the registrator's limits")
    if not costs[-1] < costs[0]:
        fail(f"joint-BA {label} scene: the cost did not fall")
    if rig and not res["extrinsic_error"][1] < res["extrinsic_error"][0]:
        fail("joint-BA rig scene: the extrinsic error did not fall")
    if launches["pyramid_sample_derivs"] <= 0 or launches["pyramid_sample_value"] <= 0:
        fail(f"joint-BA {label} scene: B3 launches {launches}")
    return res


def run_joint_ba_normal_shift(torch, kernels, jtool, synthetic, cio, quat_to_matrix_np, root: str):
    """The plain small scenes with scan 1 shifted 4 mm along the surface
    normal, a scan-1 error the system sees, at ``--icp_weight 1e6``, through
    the CLI on the card: the cost falls and each scene's scan-1 error falls
    below half its start."""
    from dataset_pipeline_tpu_torch.models.lie import SE3

    w, h, n_img, n_pts = JBA_SMALL
    scenes = []
    for si in range(2):
        d = os.path.join(root, f"scene{si}")
        tq, tt = synthetic.write_scene(d, w, h, 2800.0 * w / 3072, n_img, n_pts, seed=31 + 10 * si,
                                       device="cuda", n_scans=2, scan1_error=JBA_SMALL_SCAN1_ERROR)
        scenes.append((d, tq, tt))
    kernels.reset_launch_counts()
    out = os.path.join(root, "cuda")
    if jtool.main(scene_args(scenes) + ["--output_folder_path", out, "--max_iterations",
                                        str(JBA_ITERATIONS), "--icp_weight", JBA_SMALL_ICP_WEIGHT,
                                        "--device", "cuda"]) != 0:
        fail("joint-BA normal-shift scenes failed")
    launches = b3_launches(kernels)
    costs = [float(v) for v in open(os.path.join(out, "scene_0", "metadata.txt")).read()
             .splitlines()[2].split()[1:]]
    e0 = float(torch.linalg.norm(torch.as_tensor(JBA_SMALL_SCAN1_ERROR)))
    after = [e for e, _ in joint_scene_errors(torch, out, scenes, SE3, cio, quat_to_matrix_np)]
    print(f"joint-BA normal-shift scenes (2 x {n_img} images {w}x{h}, --icp_weight "
          f"{JBA_SMALL_ICP_WEIGHT}): scan-1 error {e0:.6f} -> {after}; costs {costs}; "
          f"launches {launches}")
    if not costs[-1] < costs[0]:
        fail("joint-BA normal-shift scenes: the cost did not fall")
    if not all(e < 0.5 * e0 for e in after):
        fail(f"joint-BA normal-shift scenes: a scan-1 error {after} is not below half of {e0}")
    if launches["pyramid_sample_derivs"] <= 0 or launches["pyramid_sample_value"] <= 0:
        fail(f"joint-BA normal-shift scenes: B3 launches {launches}")
    return {"launches": launches, "costs": costs, "scan1_error": [e0, after]}


def run_slice5(torch, kernels, synthetic, cio, quat_to_matrix_np, tps, root: str):
    """The joint-BA phase: the DSLR run (B3 checked at its first launch of
    each mode), then the small plain and rig scenes CUDA vs CPU. Returns
    (results, B3 launches of the DSLR run, B3 checks at the kept launches)."""
    from dataset_pipeline_tpu_torch.parallel import joint_ba as jmod
    from dataset_pipeline_tpu_torch.tools import joint_ba as jtool

    t_all = time.perf_counter()
    res, cap = run_joint_ba_dslr(torch, kernels, jtool, jmod, synthetic, cio, quat_to_matrix_np,
                                 os.path.join(root, "jba"))
    b3_at = {"derivs": check_b3_at_captured(torch, tps, cap["derivs"],
                                            "the joint-BA run's first derivs launch"),
             "value": check_b3_value_at_captured(torch, tps, cap["value"],
                                                 "the joint-BA run's first value launch")}
    del cap
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["small_plain"] = run_joint_ba_small(torch, kernels, jtool, synthetic, cio, quat_to_matrix_np,
                                            os.path.join(root, "jba_small"), rig=False)
    res["small_rig"] = run_joint_ba_small(torch, kernels, jtool, synthetic, cio, quat_to_matrix_np,
                                          os.path.join(root, "jba_rig"), rig=True)
    res["normal_shift"] = run_joint_ba_normal_shift(torch, kernels, jtool, synthetic, cio,
                                                    quat_to_matrix_np, os.path.join(root, "jba_shift"))
    torch.cuda.empty_cache()
    print(f"small joint-BA scenes: {time.perf_counter() - t0:.1f} s; joint-BA phase "
          f"{time.perf_counter() - t_all:.1f} s")
    return res, res["launches"], b3_at


# ---------------------------------------------------------------------------
# Slice 6: the multi-device layer (B4a, B2 and B3 inside each rank). The smoke
# needs one card, and NCCL takes one rank per card, so this shows the NCCL path
# at world size 1 and the sharded logic with two ranks sharing the card over
# Gloo; neither is a scaling number.
# ---------------------------------------------------------------------------

S6_ICP_CLOUDS, S6_REPS = 2, 5
S6_H_RTOL, S6_H_ATOL, S6_COST_RTOL = 1e-4, 1e-3, 1e-5  # tests/test_parallel.py:45-47
S6_GRAM_RTOL = 1e-5  # and atol 1e-5 max|P| (tests/test_parallel.py:182-183)
S6_MOMENT_COST_RTOL = 1e-4  # tests/test_parallel.py:202-203
S6_Q_TOL, S6_T_TOL = 5e-6, 5e-5  # mesh vs one rank (tests/test_parallel_photometric.py:102-103)
S6_REG_COST_RTOL = 1e-5
S6_ICP_KERNELS = ("gn_rows", "moment_gram")


def host_seconds(torch, fn, reps: int) -> float:
    """Seconds per call of ``fn`` on the host clock, the card synchronized
    around the calls (a collective synchronizes the ranks), after one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def slice6_icp_rank(m: int, seed: int) -> dict:
    """One rank of the sharded ICP normal equations: its share of the rows
    through ``sharded_icp_hb`` (B4a) and ``sharded_moment_gram`` (B2)."""
    import torch

    from dataset_pipeline_tpu_torch.entry import sharded_icp_problem
    from dataset_pipeline_tpu_torch.parallel.mesh import (
        initialize_distributed, make_data_mesh, replicated, shard_rows)
    from dataset_pipeline_tpu_torch.parallel.normal_equations import (
        sharded_icp_hb, sharded_moment_gram)

    initialize_distributed(device="cuda")
    mesh = make_data_mesh(device="cuda")
    q, t, *rows = sharded_icp_problem(m, S6_ICP_CLOUDS, seed)
    q, t = replicated(mesh, q), replicated(mesh, t)
    rows = [shard_rows(mesh, x) for x in rows]
    ps, ns, pt, nt, _, _, w = rows
    H, b, cost = sharded_icp_hb(mesh, q, t, *rows, S6_ICP_CLOUDS)
    P = sharded_moment_gram(mesh, ps, ns, pt, nt, w)
    calls, secs = mesh.calls, mesh.seconds
    icp_s = host_seconds(torch, lambda: sharded_icp_hb(mesh, q, t, *rows, S6_ICP_CLOUDS), S6_REPS)
    gram_s = host_seconds(torch, lambda: sharded_moment_gram(mesh, ps, ns, pt, nt, w), S6_REPS)
    return {"backend": mesh.backend, "world": mesh.size, "rows": int(ps.shape[0]),
            "H": H.cpu().numpy(), "b": b.cpu().numpy(), "cost": float(cost), "P": P.cpu().numpy(),
            "icp_hb_s": icp_s, "moment_gram_s": gram_s,
            "collective_calls": mesh.calls, "collective_s_per_call": mesh.seconds / mesh.calls,
            "first_pass_collective_s": secs / calls}


def run_sharded_icp(torch, kernels, gn, launch, pack_group_data, sharded_icp_problem,
                    hb_cost_from_moments):
    """The ICP normal equations at 8M correspondences (bench.py's headline
    size, two clouds) sharded at world 1 over NCCL and at world 2 over Gloo,
    each held against the one-process B4a and B2 results at JAX's bounds;
    and the LM cost that ``hb_cost_from_moments`` derives from each B2 Gram
    against B4a's direct cost of the same rows as one cloud pair, at JAX's
    1e-4 relative (tests/test_parallel.py:202-203; the plain B2 misses it on
    the CPU, ROADMAP C.3)."""
    m, seed = CORR_TOTAL, 12
    q, t, *rows = sharded_icp_problem(m, S6_ICP_CLOUDS, seed)
    dev = [torch.as_tensor(x, device="cuda") for x in rows]
    qd, td = torch.as_tensor(q, device="cuda"), torch.as_tensor(t, device="cuda")
    H1, b1, c1 = (x.cpu().numpy() for x in gn.icp_hb_cost_rows(qd, td, *dev, S6_ICP_CLOUDS))
    ps, ns, pt, nt, sid, _, w = dev
    c_pair = float(gn.icp_hb_cost_rows(qd, td, ps, ns, pt, nt, torch.zeros_like(sid),
                                       torch.ones_like(sid), w, S6_ICP_CLOUDS)[2])
    data, _ = pack_group_data([dict(ps=ps, ns=ns, pt=pt, nt=nt, w=w)], 49152,
                              rows=13, device="cuda")
    P1 = gn.moment_gram_partials(data, 49152)[0].sum(0, dtype=torch.float64).cpu().numpy()

    def moment_cost_gap(P):
        cost = hb_cost_from_moments([P], [(0, 1)], q.astype(np.float64), t.astype(np.float64),
                                    S6_ICP_CLOUDS)[2]
        return abs(float(cost) - c_pair) / abs(c_pair)

    moment_gaps = {"one_process": moment_cost_gap(P1)}
    one_icp_s = host_seconds(torch, lambda: gn.icp_hb_cost_rows(qd, td, *dev, S6_ICP_CLOUDS), S6_REPS)
    one_gram_s = host_seconds(torch, lambda: gn.moment_gram_partials(data, 49152)[0]
                              .sum(0, dtype=torch.float64), S6_REPS)
    del dev, ps, ns, pt, nt, sid, w, data
    torch.cuda.empty_cache()
    res, by_path = {"one_process": {"icp_hb_s": one_icp_s, "moment_gram_s": one_gram_s}}, {}
    for world, want in ((1, "nccl"), (2, "gloo")):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ranks = launch(slice6_icp_rank, world, (m, seed), "cuda")
        wall = time.perf_counter() - t0
        launches = {k: kernels.LAUNCHES[k] for k in S6_ICP_KERNELS}
        by_path[f"sharded_icp_world{world}"] = launches
        gaps = []
        for r, (o, _) in enumerate(ranks):
            if o["backend"] != want:
                fail(f"sharded ICP at world {world}: rank {r} chose {o['backend']}, not {want}")
            dH, db = (float(np.max(np.abs(a - e) / (S6_H_ATOL + S6_H_RTOL * np.abs(e))))
                      for a, e in ((o["H"], H1), (o["b"], b1)))
            dc = abs(o["cost"] - float(c1)) / abs(float(c1))
            dP = float(np.max(np.abs(o["P"] - P1) / (S6_GRAM_RTOL * np.abs(P1)
                                                       + 1e-5 * np.abs(P1).max())))
            gaps.append({"H": dH, "b": db, "cost_rel": dc, "P": dP})
            moment_gaps[f"world{world}_rank{r}"] = moment_cost_gap(o["P"])
            if not (dH <= 1 and db <= 1 and dc <= S6_COST_RTOL and dP <= 1):
                fail(f"sharded ICP at world {world}, rank {r}: H {dH:.3g} b {db:.3g} (share of the "
                     f"bound), cost rel {dc:.3e}, Gram {dP:.3g} (share of the bound)")
        res[f"world{world}"] = {
            "backend": want, "wall_s": wall, "launches": launches, "gaps": gaps,
            "per_rank": [{k: o[k] for k in ("rows", "icp_hb_s", "moment_gram_s", "collective_calls",
                                             "collective_s_per_call", "first_pass_collective_s")}
                         for o, _ in ranks]}
        print(f"sharded ICP normal equations, {m} correspondences, world {world} over {want}: "
              f"wall {wall:.1f} s; per rank (rows, s per sharded_icp_hb, s per sharded_moment_gram, "
              f"s per collective) "
              + "; ".join(f"{o['rows']} {o['icp_hb_s']:.4f} {o['moment_gram_s']:.4f} "
                          f"{o['collective_s_per_call']:.2e}" for o, _ in ranks)
              + f"; one process {one_icp_s:.4f} / {one_gram_s:.4f} s; gaps {gaps}; launches {launches}")
        if any(v <= 0 for v in launches.values()):
            fail(f"sharded ICP at world {world} did not launch B4a and B2: {launches}")
    res["moment_cost_rel"] = moment_gaps
    print(f"LM cost from the B2 moment Gram vs B4a's direct cost ({m} rows as one cloud pair, "
          f"bound {S6_MOMENT_COST_RTOL}): " + ", ".join(f"{k} {v:.3e}" for k, v in moment_gaps.items()))
    if max(moment_gaps.values()) > S6_MOMENT_COST_RTOL:
        fail(f"the moment-derived LM cost is off the direct cost: {moment_gaps}")
    return res, by_path


def run_registrator_devices2(torch, kernels, image_registrator, cio, root: str, extra, label: str):
    """The registrator through the CLI at ``--devices 2`` (two ranks sharing
    the card, over Gloo) beside the one-rank run of the same arguments: poses
    within the mesh-vs-sequential bounds of the JAX tests, the optimum cost
    within 1e-5 relative; every rank launches B3."""
    runs = {}
    for n in (1, 2):
        out = os.path.join(root, f"out_devices{n}")
        timings, stats = {}, {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = image_registrator.main(registrator_args(root, out, "cuda", [*extra, "--devices", str(n)]),
                                    timings=timings, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"{label}: the registrator at --devices {n} returned {rc}")
        iters = stats["scales"][-1]["iterations"]
        runs[n] = {"out": out, "wall_s": wall, "launches": b3_launches(kernels),
                   "s_per_iteration": sum(timings.values()) / iters, "iterations": iters,
                   "hb_s_per_iteration": timings.get("hb_accumulate", 0.0) / iters, "stats": stats}
    scales, (dq, dt, dp, dc), _ = compare_registrator_states(runs[1]["out"], runs[2]["out"],
                                                             os.path.join(root, "state"), cio)
    ranks = []
    for r, rk in enumerate(runs[2]["stats"]["ranks"]):
        it = runs[2]["iterations"]
        col = rk["collectives"]
        ranks.append({"backend": col["backend"], "s_per_iteration": sum(rk["timings"].values()) / it,
                      "hb_s_per_iteration": rk["timings"].get("hb_accumulate", 0.0) / it,
                      "collective_calls": col["calls"],
                      "collective_s_per_call": col["seconds"] / max(col["calls"], 1),
                      "b3": {k: rk["launches"][k] for k in REG_KERNELS}})
    res = {"scales": scales, "gaps": {"qvec": dq, "tvec": dt, "params": dp, "cost_rel": dc},
           "one_rank": {k: runs[1][k] for k in ("wall_s", "s_per_iteration", "hb_s_per_iteration")},
           "devices2": {"wall_s": runs[2]["wall_s"], "launches": runs[2]["launches"], "ranks": ranks}}
    print(f"{label} at --devices 2 (over {ranks[0]['backend']}, one card) vs one rank: qvec {dq:.3e} "
          f"tvec {dt:.3e} params {dp:.3e} px optimum cost rel {dc:.3e}; wall {runs[2]['wall_s']:.1f} "
          f"s vs {runs[1]['wall_s']:.1f} s; s/iteration per rank "
          + ", ".join(f"{x['s_per_iteration']:.3f} (H,b {x['hb_s_per_iteration']:.3f}, "
                      f"{x['collective_calls']} collectives at {x['collective_s_per_call']:.2e} s, "
                      f"B3 {x['b3']})" for x in ranks)
          + f" vs one rank {runs[1]['s_per_iteration']:.3f} (H,b {runs[1]['hb_s_per_iteration']:.3f})")
    if not (dq <= S6_Q_TOL and dt <= S6_T_TOL and dc <= S6_REG_COST_RTOL and dp <= REG_PARAM_TOL):
        fail(f"{label}: --devices 2 and one rank differ beyond the mesh bounds")
    for r, x in enumerate(ranks):
        if x["backend"] != "gloo" or x["b3"]["pyramid_sample_derivs"] <= 0:
            fail(f"{label}: rank {r} ran over {x['backend']} with B3 launches {x['b3']}")
    return res


def run_joint_ba_devices2(torch, kernels, jtool, cio, root: str, rig: bool):
    """A small joint-BA scene of ``run_joint_ba_small`` at ``--devices 2``
    (two ranks sharing the card over Gloo), held against its one-rank CUDA
    run within the registrator's limits."""
    label = "rig" if rig else "plain"
    scenes = sorted(d for d in os.listdir(root) if d.startswith("scene"))
    args = scene_args([(os.path.join(root, d), None, None) for d in scenes])
    out = os.path.join(root, "cuda_devices2")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if jtool.main(args + ["--output_folder_path", out, "--max_iterations", str(JBA_ITERATIONS),
                          "--device", "cuda", "--devices", "2"]) != 0:
        fail(f"joint-BA {label} scene at --devices 2 failed")
    wall = time.perf_counter() - t0
    launches = b3_launches(kernels)
    dm, dq, dt, dp, dc = compare_joint_ba_outputs(os.path.join(root, "cuda"), out, len(scenes), cio)
    print(f"joint-BA {label} scene at --devices 2 vs one rank: .mlp {dm:.3e} qvec {dq:.3e} tvec "
          f"{dt:.3e} params {dp:.3e} px cost rel {dc:.3e}; wall {wall:.1f} s; launches {launches}")
    if not (dm <= REG_T_TOL and dq <= REG_Q_TOL and dt <= REG_T_TOL and dp <= REG_PARAM_TOL
            and dc <= REG_COST_RTOL):
        fail(f"joint-BA {label} scene: --devices 2 and one rank differ beyond the registrator's limits")
    if launches["pyramid_sample_derivs"] <= 0 or launches["pyramid_sample_value"] <= 0:
        fail(f"joint-BA {label} scene at --devices 2: B3 launches {launches}")
    return {"wall_s": wall, "launches": launches,
            "gaps": {"mlp": dm, "qvec": dq, "tvec": dt, "params": dp, "cost_rel": dc}}


def run_dryruns(torch, kernels, entry):
    """``dryrun_multichip(1)`` (NCCL) and ``dryrun_multichip(2)`` (Gloo,
    one card): every stage finite on every rank, the ranks agree."""
    res, by_path = {}, {}
    for n, want in ((1, "nccl"), (2, "gloo")):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ranks = entry.dryrun_multichip(n, "cuda")
        wall = time.perf_counter() - t0
        by_path[f"dryrun_{n}"] = {k: kernels.LAUNCHES[k] for k in ("gn_rows", "moment_gram",
                                                                    *REG_KERNELS)}
        costs = [{k: v for k, v in r.items() if k.endswith("cost")} for r in ranks]
        print(f"dryrun_multichip({n}): {wall:.1f} s over {[r['backend'] for r in ranks]}; "
              f"{[r['collective_calls'] for r in ranks]} collectives at "
              f"{[r['collective_seconds'] / r['collective_calls'] for r in ranks]} s; rank 0 {costs[0]}; "
              f"launches {by_path[f'dryrun_{n}']}")
        if any(r["backend"] != want for r in ranks) or any(c != costs[0] for c in costs):
            fail(f"dryrun_multichip({n}): backends {[r['backend'] for r in ranks]}, costs {costs}")
        res[f"ranks{n}"] = {"wall_s": wall, "backend": want, "costs": costs[0],
                            "collective_s_per_call": [r["collective_seconds"] / r["collective_calls"]
                                                      for r in ranks]}
    return res, by_path


def run_slice6(torch, kernels, image_registrator, entry, pack_group_data, gn, cio, root: str):
    """The multi-device phase: the sharded ICP normal equations at 8M
    correspondences, the DSLR registrator at ``--devices 2`` from the cloud
    cache the DSLR phase wrote, the small joint-BA scenes of the slice-5
    phase at ``--devices 2``, and both dry runs. Returns (results, launches
    by path)."""
    from dataset_pipeline_tpu_torch.icp.moments import hb_cost_from_moments
    from dataset_pipeline_tpu_torch.parallel.mesh import launch
    from dataset_pipeline_tpu_torch.tools import joint_ba as jtool

    t_all = time.perf_counter()
    torch.cuda.empty_cache()
    res, by_path = run_sharded_icp(torch, kernels, gn, launch, pack_group_data,
                                   entry.sharded_icp_problem, hb_cost_from_moments)
    t0 = time.perf_counter()
    c = ["--initial_scaling_factor", "1", "--target_scaling_factor", "1", "--merge_distance_factor",
         "3.0", "--multi_res_point_cloud_directory_path", os.path.join(root, "dslr", "cache")]
    res["registrator_dslr"] = run_registrator_devices2(torch, kernels, image_registrator, cio,
                                                       os.path.join(root, "dslr"), c, "DSLR")
    by_path["registrator_devices2"] = res["registrator_dslr"]["devices2"]["launches"]
    torch.cuda.empty_cache()
    print(f"DSLR at --devices 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for rig, sub in ((False, "jba_small"), (True, "jba_rig")):
        key = f"joint_ba_{'rig' if rig else 'plain'}_devices2"
        res[key] = run_joint_ba_devices2(torch, kernels, jtool, cio, os.path.join(root, sub), rig)
        by_path[key] = res[key]["launches"]
    print(f"joint BA at --devices 2: {time.perf_counter() - t0:.1f} s")
    dry, dry_paths = run_dryruns(torch, kernels, entry)
    res["dryrun"] = dry
    by_path.update(dry_paths)
    torch.cuda.empty_cache()
    print(f"multi-device phase: {time.perf_counter() - t_all:.1f} s")
    return res, by_path


# ---------------------------------------------------------------------------
# Slice 7: the DatasetInspector, the two-frame alignment, the scaling bench
# ---------------------------------------------------------------------------

INSPECTOR_MODES = ("depth", "overlay", "occlusion", "scan", "cost", "cost_variable", "cost_combined",
                   "points")
INSPECTOR_FIRST = ("depth", "overlay", "occlusion", "scan")  # the first call: no optimizer
INSPECTOR_NUDGE = "0.003 -0.004 0 0.0012 -0.0016 0"  # 5 mm, 2 mrad: the localized image's start
# scan points projected with the true pose (>= 20 kept): the float32 bearing residuals put the
# localized pose within ~1e-7 m of its optimum, two devices' roundings apart, and more points
# average that down (port vs JAX on the CPU: up to 9e-7 m at 20 points, 1.3e-7 at 200)
INSPECTOR_CORR = 200
LOCALIZE_Q_TOL, LOCALIZE_T_TOL = 1e-4, 1e-4  # quaternion entries, m: localized vs true
INSPECTOR_MASK_MIN = 1000  # MASK_OBS pixels of the transferred mask, at least
INSPECTOR_SHARE, INSPECTOR_LEVELS = 0.999, 2  # points / cost PNGs CUDA vs CPU: share within levels
PAIR_SIZE = (640, 480)
PAIR_MOTION = (0.005, -0.005, 0.02, 0.002, -0.002, 0.017)  # b_T_a: 2.1 cm, 1.0 degree (mostly roll)
PAIR_CMP_ITERS = 2  # per scale, the CUDA = CPU comparison (the CPU run took 56 s at 5)
SCALING_M = 500_000  # the scaling bench's moment rows a rank, JAX's
SCHUR_PAYLOAD = 101 ** 2 * 4  # its Schur all_reduce: (n_keep + 1)^2 float32 at JAX's n_keep 100


def image_links(src: str, dst: str) -> str:
    """``dst`` with a symlink to each image file of ``src``: an image base
    path of its own (masks written there stay out of ``src``)."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if os.path.isfile(os.path.join(src, name)):
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    return dst


def localize_inputs(root: str, state: str, truth, image: int, W: int, H: int, f: float, cio,
                    seed: int, set_truth: bool):
    """Write ``corr_<seed>.txt``: INSPECTOR_CORR scan points projected with
    image ``image``'s true pose, those inside the image (>= 20); with ``set_truth``
    also put that pose into ``state``. Returns (path, the image's name)."""
    import torch

    from dataset_pipeline_tpu_torch.io.ply import read_ply
    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.models.lie import quat_to_matrix_np

    tq, tt = truth
    model = cio.read_model(state)
    iid = sorted(model.images)[image]
    if set_truth:
        model.images[iid].qvec, model.images[iid].tvec = np.asarray(tq[image]), np.asarray(tt[image])
        cio.write_model(state, model)
    pts = read_ply(os.path.join(root, "scan.ply")).positions
    sel = np.random.RandomState(seed).choice(len(pts), INSPECTOR_CORR, replace=False)
    cam = cm.make_camera("PINHOLE", W, H, [f, f, (W - 1) / 2, (H - 1) / 2], device="cuda")
    pix, ok = cm.project(cam, torch.as_tensor(pts[sel] @ quat_to_matrix_np(tq[image]).T + tt[image],
                                              dtype=torch.float32, device="cuda"))
    ok = (ok & cm.in_image(cam, pix)).cpu().numpy()
    if ok.sum() < 20:
        fail(f"localize inputs: {ok.sum()} of {INSPECTOR_CORR} points in the image")
    path = os.path.join(root, f"corr_{seed}.txt")
    np.savetxt(path, np.concatenate([pix.cpu().numpy()[ok], pts[sel][ok]], 1))
    return path, model.images[iid].name


def pose_gap(state: str, truth, image: int, cio):
    """(max |q - q_true| sign-aligned, |t - t_true|) of image ``image``."""
    images = cio.read_model(state).images
    im = images[sorted(images)[image]]
    q, qt = np.asarray(im.qvec), np.asarray(truth[0][image])
    q = q * np.sign(q @ qt)
    return float(np.abs(q - qt).max()), float(np.linalg.norm(im.tvec - truth[1][image]))


def inspector_args(scene: str, state: str, images: str, out: str, modes, dev: str, extra=()):
    return ["--scan_alignment_path", os.path.join(scene, "scene.mlp"), "--state_path", state,
            "--image_base_path", images, "--output_folder_path", out, "--modes", ",".join(modes),
            "--device", dev, *extra]


def run_inspector_dslr(torch, kernels, optimizer, synthetic, cio, root: str, truth):
    """The DatasetInspector through its CLI on the DSLR scene: a first call
    with the four renderings and a nudge of the image to localize, a second
    with every mode, the localization and a label transfer of a drawn mask."""
    from dataset_pipeline_tpu_torch.photometric.masks import (
        MASK_OBS, draw_mask_polygons, image_mask_path, load_mask, save_mask)
    from dataset_pipeline_tpu_torch.tools import dataset_inspector

    c = synthetic.DSLR
    W, H = c["width"], c["height"]
    scene = os.path.join(root, "dslr")
    work = os.path.join(root, "inspector_dslr")
    state = shutil.copytree(os.path.join(scene, "state"), os.path.join(work, "state"))
    images = image_links(os.path.join(scene, "images"), os.path.join(work, "images"))
    corr, loc_name = localize_inputs(scene, state, truth, 2, W, H, c["f"], cio, seed=13,
                                     set_truth=True)
    names = [m.name for _, m in sorted(cio.read_model(state).images.items())]
    poly = np.asarray([[0.23, 0.2], [0.75, 0.25], [0.78, 0.78], [0.2, 0.73]]) * [W, H]
    save_mask(image_mask_path(images, names[0]), draw_mask_polygons((H, W), [(poly, MASK_OBS)]))
    # the DSLR cell's flag; the inspector, as JAX's, leaves it unused (the cloud at build_multiscale_cloud's defaults)
    merge = ["--merge_distance_factor", str(c["merge_distance_factor"])]
    res = {}

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if dataset_inspector.main(inspector_args(scene, state, images, os.path.join(work, "out1"),
                                             INSPECTOR_FIRST, "cuda",
                                             merge + ["--nudge_image", loc_name,
                                                      "--nudge", INSPECTOR_NUDGE])) != 0:
        fail("inspector (renderings) returned non-zero")
    torch.cuda.synchronize()
    res["renderings"] = {"wall_s": time.perf_counter() - t0,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "launches": b3_launches(kernels)}
    start_gap = pose_gap(state, truth, 2, cio)

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CaptureB3Modes(optimizer) as cap, \
            TimeCalls(torch, optimizer.PhotometricOptimizer,
                      ("render_cost_image", "_compute_variable_descriptors", "_visibility"),
                      lambda: sum(b3_launches(kernels).values())) as calls:
        rc = dataset_inspector.main(inspector_args(
            scene, state, images, os.path.join(work, "out2"), INSPECTOR_MODES, "cuda",
            merge + ["--localize_image", loc_name, "--correspondences", corr,
                     "--transfer_source", names[0], "--transfer_target", names[1]]))
    torch.cuda.synchronize()
    if rc != 0:
        fail("inspector (every mode) returned non-zero")
    launches = b3_launches(kernels)
    rows = {}  # per method, render_cost_image per mode
    for name, strs, sec, b3 in calls:
        row = rows.setdefault(strs[0] if strs else name, {"calls": 0, "b3_launches": 0, "s": 0.0})
        row["calls"] += 1
        row["b3_launches"] += b3
        row["s"] += sec
    res["every_mode"] = {"wall_s": time.perf_counter() - t0,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "launches": launches, "by_call": rows}
    res["setup_and_cost_modes_s"] = res["every_mode"]["wall_s"] - res["renderings"]["wall_s"]
    end_gap = pose_gap(state, truth, 2, cio)
    for out, modes in (("out1", INSPECTOR_FIRST), ("out2", INSPECTOR_MODES)):
        for name in names:
            base = os.path.splitext(os.path.basename(name))[0]
            missing = [m for m in modes if not os.path.exists(os.path.join(work, out, f"{base}.{m}.png"))]
            if missing:
                fail(f"inspector DSLR: {base} lacks {missing} in {out}")
    from PIL import Image

    drawn = [int((np.asarray(Image.open(os.path.join(work, "out2", f"{os.path.splitext(n)[0]}.points.png")))
                  .max(-1) > 0).sum()) for n in names]
    tmask = load_mask(image_mask_path(images, names[1]))
    n_obs = 0 if tmask is None else int((tmask == MASK_OBS).sum())
    res.update(localize_start_gap=start_gap, localize_gap=end_gap, mask_obs_pixels=n_obs,
               points_drawn_min=min(drawn))
    print(f"inspector DSLR ({len(names)} x {W}x{H}): renderings + nudge {res['renderings']['wall_s']:.1f} s "
          f"(peak {res['renderings']['peak_gib']:.2f} GiB), every mode + localize + transfer "
          f"{res['every_mode']['wall_s']:.1f} s (peak {res['every_mode']['peak_gib']:.2f} GiB; the "
          f"difference, the optimizer's set-up and the cost / points modes: "
          f"{res['setup_and_cost_modes_s']:.1f} s); B3 {launches}; by call "
          + ", ".join(f"{k} {v['calls']} calls {v['b3_launches']} launches {v['s']:.2f} s"
                      for k, v in rows.items())
          + f"; localized image: start (q {start_gap[0]:.2e}, t {start_gap[1]:.2e} m) -> "
          f"(q {end_gap[0]:.2e}, t {end_gap[1]:.2e} m); transferred mask {n_obs} obs pixels; "
          f"points drawn per image >= {min(drawn)}")
    if not (end_gap[0] <= LOCALIZE_Q_TOL and end_gap[1] <= LOCALIZE_T_TOL):
        fail(f"inspector DSLR: localized pose {end_gap} off the truth beyond "
             f"({LOCALIZE_Q_TOL}, {LOCALIZE_T_TOL})")
    if not (end_gap[0] < start_gap[0] and end_gap[1] < start_gap[1]):
        fail(f"inspector DSLR: the localized pose {end_gap} is not closer than the start {start_gap}")
    if n_obs <= INSPECTOR_MASK_MIN:
        fail(f"inspector DSLR: the transferred mask has {n_obs} MASK_OBS pixels")
    if min(drawn) <= 100:
        fail("inspector DSLR: a points image shows no optimization points")
    if launches["pyramid_sample_value"] <= 0:
        fail("inspector DSLR: the cost modes never launched B3")
    if "value" not in cap:
        fail("inspector DSLR: no value-mode B3 launch to keep the inputs of")
    return res, launches, cap["value"]


def png_agreement(a_dir: str, b_dir: str, exact, label: str) -> dict:
    """Per mode the least share of pixels of one image whose channels agree
    within INSPECTOR_LEVELS, CUDA against CPU; ``exact`` modes byte for byte."""
    from PIL import Image

    shares = {}
    for f in sorted(os.listdir(a_dir)):
        mode = f.split(".")[-2]
        if mode in exact:
            with open(os.path.join(a_dir, f), "rb") as fa, open(os.path.join(b_dir, f), "rb") as fb:
                if fa.read() != fb.read():
                    fail(f"{label}: {f} differs between CUDA and CPU")
            continue
        a, b = (np.asarray(Image.open(os.path.join(d, f))).astype(int) for d in (a_dir, b_dir))
        agree = float((np.abs(a - b) <= INSPECTOR_LEVELS).all(-1).mean())
        shares[mode] = min(shares.get(mode, 1.0), agree)
    return shares


def run_inspector_small(torch, synthetic, cio, root: str):
    """The inspector's CLI on the 640x480 registrator scene on the card and on
    the CPU: image 1 localized from its perturbed pose with correspondences
    of its true pose; then, from one common state (the card's localized one,
    so that both render the same poses), every mode and a label transfer."""
    from dataset_pipeline_tpu_torch.photometric.masks import (
        MASK_OBS, draw_mask_polygons, image_mask_path, save_mask)
    from dataset_pipeline_tpu_torch.tools import dataset_inspector

    t0 = time.perf_counter()
    scene = os.path.join(root, "small")
    W, H = 640, 480
    names = [m.name for _, m in sorted(cio.read_model(os.path.join(scene, "state")).images.items())]
    poly = np.asarray([[100, 80], [500, 90], [540, 400], [120, 380]], np.float64)
    # the scene's true poses (check_registrator_small's write_scene: 2 images, baseline 0.15, seed 3)
    true = synthetic.true_poses(2, 0.15, 3, device="cpu")
    corr, loc = localize_inputs(scene, os.path.join(scene, "state"), (true.q.numpy(), true.t.numpy()),
                                1, W, H, 2800.0 * W / 3072, cio, seed=17, set_truth=False)
    located, outs = {}, {}
    for dev in ("cuda", "cpu"):
        state = shutil.copytree(os.path.join(scene, "state"), os.path.join(root, f"insp_loc_{dev}"))
        if dataset_inspector.main(inspector_args(scene, state, os.path.join(scene, "images"),
                                                 os.path.join(root, f"insp_loc_out_{dev}"), (), dev,
                                                 ["--localize_image", loc, "--correspondences", corr])) != 0:
            fail(f"small inspector (localize) on {dev} failed")
        located[dev] = cio.read_model(state)
    for dev in ("cuda", "cpu"):
        work = os.path.join(root, f"inspector_small_{dev}")
        state = shutil.copytree(os.path.join(root, "insp_loc_cuda"), os.path.join(work, "state"))
        images = image_links(os.path.join(scene, "images"), os.path.join(work, "images"))
        save_mask(image_mask_path(images, names[0]), draw_mask_polygons((H, W), [(poly, MASK_OBS)]))
        if dataset_inspector.main(inspector_args(
                scene, state, images, os.path.join(work, "out"), INSPECTOR_MODES, dev,
                ["--transfer_source", names[0], "--transfer_target", names[1]])) != 0:
            fail(f"small inspector on {dev} failed")
        with open(image_mask_path(images, names[1]), "rb") as fh:
            outs[dev] = (work, fh.read())
    sa, sb = located["cuda"], located["cpu"]
    dq = max(float(np.abs(sa.images[i].qvec - sb.images[i].qvec).max()) for i in sa.images)
    dt = max(float(np.abs(sa.images[i].tvec - sb.images[i].tvec).max()) for i in sa.images)
    (wa, ma), (wb, mb) = outs["cuda"], outs["cpu"]
    if ma != mb:
        fail("small inspector: the transferred masks differ between CUDA and CPU")
    shares = png_agreement(os.path.join(wa, "out"), os.path.join(wb, "out"), INSPECTOR_FIRST,
                           "small inspector")
    print(f"small inspector CUDA vs CPU ({time.perf_counter() - t0:.1f} s): depth, overlay, occlusion, "
          f"scan PNGs and the mask byte-equal; share of pixels within {INSPECTOR_LEVELS} levels {shares}; "
          f"localized poses qvec {dq:.3e} tvec {dt:.3e}")
    if min(shares.values()) < INSPECTOR_SHARE:
        fail(f"small inspector: CUDA and CPU PNGs agree in less than {INSPECTOR_SHARE}: {shares}")
    if not (dq <= REG_Q_TOL and dt <= REG_T_TOL):
        fail("small inspector: the localized poses differ between CUDA and CPU")
    return {"png_shares": shares, "qvec": dq, "tvec": dt, "s": time.perf_counter() - t0}


def pair_errors(torch, poses, a_T_b):
    """(translation error in m, rotation error in degrees) of a_T_b from two
    image_T_global poses."""
    from dataset_pipeline_tpu_torch.models.lie import SE3

    q, t = poses.q.double().cpu(), poses.t.double().cpu()
    est = SE3(q[0], t[0]).compose(SE3(q[1], t[1]).inverse()).matrix().numpy()
    rel = est[:3, :3] @ a_T_b[:3, :3].T
    return (float(np.linalg.norm(est[:3, 3] - a_T_b[:3, 3])),
            float(np.rad2deg(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))))


def run_pair_alignment(torch, kernels, optimizer, root: str):
    """``align_pair`` on a generated 640x480 RGB-D pair: on the card at the
    harness's defaults (the JAX test's bounds, closer than the start), then
    CUDA against CPU at PAIR_CMP_ITERS iterations per scale."""
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.photometric import pair_alignment as pa
    from dataset_pipeline_tpu_torch.utils import synthetic

    W, H = PAIR_SIZE
    path = synthetic.write_rgbd_pair(os.path.join(root, "pair"), W, H, 2800.0 * W / 3072, PAIR_MOTION,
                                     device="cuda")
    init = np.eye(4, dtype=np.float32)
    fx = pa.load_pair_fixture(path, device="cuda")
    pts, cols = pa.cloud_from_depth(fx.camera, fx.depth_a, fx.depth_factor, fx.image_a)
    t_start, r_start = pair_errors(torch, SE3.identity((2,), device="cpu"), fx.a_T_b)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with CaptureB3Modes(optimizer) as cap:
        poses, _ = pa.align_pair(fx.camera, pts, cols, fx.image_a, fx.image_b, init, init,
                                 device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = b3_launches(kernels)
    t_err, r_err = pair_errors(torch, poses, fx.a_T_b)
    res = {"points": len(pts), "wall_s": wall, "launches": launches,
           "start": (t_start / fx.average_scene_depth, r_start),
           "end": (t_err / fx.average_scene_depth, r_err)}
    out = {}
    for dev in ("cuda", "cpu"):
        f_dev = pa.load_pair_fixture(path, device=dev)
        t1 = time.perf_counter()
        p, _ = pa.align_pair(f_dev.camera, pts, cols, f_dev.image_a, f_dev.image_b, init, init,
                             max_iterations_per_scale=PAIR_CMP_ITERS, device=dev)
        out[dev] = (p.q.cpu().numpy(), p.t.cpu().numpy(), time.perf_counter() - t1)
    res["cuda_vs_cpu"] = (float(np.abs(out["cuda"][0] - out["cpu"][0]).max()),
                          float(np.abs(out["cuda"][1] - out["cpu"][1]).max()))
    print(f"pair alignment ({W}x{H}, {len(pts)} cloud points, motion 2.1 cm / 1.0 deg): {wall:.1f} s on "
          f"the card, B3 {launches}; t_err / depth {res['start'][0]:.3e} -> {res['end'][0]:.3e}, "
          f"rotation {r_start:.4f} -> {r_err:.4f} deg; CUDA vs CPU at {PAIR_CMP_ITERS} iterations a "
          f"scale: qvec {res['cuda_vs_cpu'][0]:.3e} tvec {res['cuda_vs_cpu'][1]:.3e} "
          f"({out['cuda'][2]:.1f} s / {out['cpu'][2]:.1f} s)")
    if not (res["end"][0] <= 1e-2 and r_err <= 1.0):
        fail(f"pair alignment: errors {res['end']} beyond the JAX test's bounds (1e-2, 1 deg)")
    if not (t_err < t_start and r_err < r_start):
        fail("pair alignment: the estimate is not closer to the truth than the start")
    if not (res["cuda_vs_cpu"][0] <= REG_Q_TOL and res["cuda_vs_cpu"][1] <= REG_T_TOL):
        fail("pair alignment: CUDA and CPU poses differ beyond the registrator's limits")
    if min(launches["pyramid_sample_derivs"], launches["pyramid_sample_value"]) <= 0:
        fail("pair alignment: B3 was not launched in both modes")
    if {"derivs", "value"} - set(cap):
        fail("pair alignment: no B3 launch of each mode to keep the inputs of")
    return res, launches, cap


def run_scaling_bench(torch, kernels, gn, pack_group_data):
    """The scaling bench on the card: world 1 over NCCL, world 2 over Gloo
    (two ranks on the one card), JAX's sizes. Each rank's B2 Gram is held
    against the plain version of its rows in float64."""
    from dataset_pipeline_tpu_torch.parallel.normal_equations import MOMENT_CHUNK
    from dataset_pipeline_tpu_torch.utils import scaling_bench as sb

    res, launches = {}, {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        block, ranks, rank_launches = sb.run(world, "cuda")
        per_rank = [r["moment_gram"] for r in rank_launches]
        launches[f"scaling_bench_{world}"] = {"moment_gram": kernels.LAUNCHES["moment_gram"]}
        errs = []
        for r, out in enumerate(ranks):
            rows = sb.moment_rows(SCALING_M * world, r * SCALING_M, (r + 1) * SCALING_M)
            g = dict(zip(("ps", "ns", "pt", "nt", "w"), (torch.as_tensor(a, device="cuda") for a in rows)))
            data, _ = pack_group_data([g], MOMENT_CHUNK, rows=13, device="cuda")
            errs.append(gram_check(f"B2 in the scaling bench's rank {r} at world {world}",
                                   torch.as_tensor(out["moment_gram"]["local"], device="cuda"),
                                   gn.moment_gram_plain(data.double(), MOMENT_CHUNK).sum(0),
                                   gn.moment_gram_plain(data, MOMENT_CHUNK).sum(0))[0])
        block.update(wall_s=time.perf_counter() - t0, moment_gram_launches_per_rank=per_rank,
                     b2_err_of_max_p=max(errs))
        res[f"nd{world}"] = block
        if block["backend"] != backend:
            fail(f"scaling bench at world {world}: backend {block['backend']}, not {backend}")
        if min(per_rank) <= 0:
            fail(f"scaling bench at world {world}: a rank never launched B2")
    for blk in (res["nd1"], res["nd2"]):
        if (blk["moment_gram"]["psum_payload_bytes"] != 42 * 42 * 4
                or blk["joint_schur"]["psum_payload_bytes"] != SCHUR_PAYLOAD):
            fail(f"scaling bench: payloads {blk} differ from JAX's")
    print(f"scaling bench ({sb.ONE_CARD}; each rank's B2 Gram within b2_err_of_max_p of the float64 "
          f"plain version, bound {B2_TOL}): " + json.dumps(res))
    return res, launches


def run_slice7(torch, kernels, optimizer, synthetic, cio, gn, pack_group_data, root: str, truth):
    """The slice-7 phase: the inspector on the DSLR scene (reusing the DSLR
    phase's scene) and on the small scene CUDA vs CPU, the two-frame
    alignment, the scaling bench. Returns (results, launches by path, the
    inputs of the inspector's first value-mode B3 launch and of the pair's
    first launch of each mode)."""
    t_all = time.perf_counter()
    torch.cuda.empty_cache()
    res, by_path = {}, {}
    res["inspector_dslr"], by_path["dataset_inspector"], cap_insp = run_inspector_dslr(
        torch, kernels, optimizer, synthetic, cio, root, truth)
    torch.cuda.empty_cache()
    res["inspector_small"] = run_inspector_small(torch, synthetic, cio, root)
    torch.cuda.empty_cache()
    res["pair_alignment"], by_path["pair_alignment"], cap_pair = run_pair_alignment(
        torch, kernels, optimizer, root)
    torch.cuda.empty_cache()
    res["scaling_bench"], sb_launches = run_scaling_bench(torch, kernels, gn, pack_group_data)
    by_path["scaling_bench"] = {"moment_gram": sum(v["moment_gram"] for v in sb_launches.values())}
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_all
    print(f"slice-7 phase: {res['phase_s']:.1f} s")
    return res, by_path, cap_insp, cap_pair


# ---------------------------------------------------------------------------
# Slice 8: the rest of bench.py through the port's bench tool
# ---------------------------------------------------------------------------

BENCH_REF_KEYS = ("ref_cpp_icp_corr_per_s", "ref_cpp_photo_obs_per_s", "ref_cpp_cubemap_faces_per_s",
                  "ref_cpp_gt_depth_frames_per_s")
BENCH_B3_SECTIONS = ("photometric_hb", "registrator_e2e", "registrator_dslr", "joint_ba", "joint_ba_dense")
BENCH_RATES = ("hbm_copy_gbps", "icp_moment_pass_gbps", "icp_moment_pass_gbps_max", "gather_micro_gbps",
               "gather_row128_gbps")  # GB/s read from the card's memory
BENCH_HB_OBS = 8 * 262_144  # photometric_hb: images x points at bench.py's sizes


def run_slice8(torch, kernels, optimizer, tps, bench_tool, icp_res: dict):
    """``tools.bench.main`` at ``bench.py``'s sizes on the card, every section
    but ``scaling`` (slice 7 runs it), the ICP section's results handed over
    from ``run_icp_bench`` so that it runs once. Keeps the inputs of the DSLR
    section's first derivs-mode B3 launch and holds B3 against its plain
    version there. Returns (results, launches by path, B3's check)."""
    t0 = time.perf_counter()
    res = {}
    kernels.reset_launch_counts()
    with CaptureB3(optimizer, "_hb_batch", lambda a: a[0].width == 3072) as cap:
        rc = bench_tool.main(["--device", "cuda", "--skip", "scaling"], results=res, icp=icp_res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if rc != 0 or "errors" in res:
        fail(f"tools.bench returned {rc}: {res.get('errors')}")
    m = res["metrics"]
    values = {k: v for k, v in m.items() if not isinstance(v, (dict, str))}
    values.update({f"kernel_variants_ms.{k}": v for k, v in m["kernel_variants_ms"].items()})
    missing = [k for k in BENCH_REF_KEYS if k not in m]
    if missing:
        fail(f"tools.bench: no C++ baseline {missing}")
    values.update(value=res["value"], vs_baseline=res["vs_baseline"])
    bad = [k for k, v in values.items() if not np.isfinite(v)]
    if bad:
        fail(f"tools.bench: non-finite values for {bad}")
    checks = {
        "registrator_dslr_obs_per_iter > 0": m["registrator_dslr_obs_per_iter"] > 0,
        "the DSLR section's timed iterations lower the cost":
            m["registrator_dslr_cost_optimum"] < m["registrator_dslr_cost_first"],
        f"photometric_hb_count > {BENCH_HB_OBS // 2}": m["photometric_hb_count"] > BENCH_HB_OBS // 2,
        "joint_ba_cost_final < joint_ba_cost0": m["joint_ba_cost_final"] < m["joint_ba_cost0"],
        "every GT frame has a valid pixel": m["gt_depth_valid_px_min"] > 0,
        "every cube-face pixel is coloured": m["cubemap_uncoloured_px"] == 0,
    }
    checks.update({f"{k} <= {HBM_CEILING} x the stated peak": m[k] <= HBM_CEILING * HBM_BYTES_PER_S / 1e9
                   for k in BENCH_RATES})
    checks.update({f"{s} launched B3": m[f"{s}_b3_launches"] > 0 for s in BENCH_B3_SECTIONS})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"tools.bench: {failed}")
    if not cap:
        fail("tools.bench: no derivs-mode B3 launch in the DSLR section to keep the inputs of")
    b3 = check_b3_at_captured(torch, tps, cap, "the bench's DSLR section's first derivs launch")
    del cap
    torch.cuda.empty_cache()
    print(f"slice-8 phase (tools.bench): {wall:.1f} s; launches {launches}; B3 a section: "
          + ", ".join(f"{s} {m[f'{s}_b3_launches']}" for s in BENCH_B3_SECTIONS)
          + f"; headline {res['value']:.4g} corr*iters/s, vs_baseline {res['vs_baseline']:.4g}")
    print(json.dumps({"bench": res}))
    return res, {"bench": launches}, b3


def check_no_jax() -> None:
    if any(m in ("jax", "dataset_pipeline_tpu") or m.startswith(("jax.", "dataset_pipeline_tpu."))
           for m in sys.modules):
        fail("the port imported jax or the JAX package")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch + CUDA port.")
    ap.add_argument("--compare_b3_source", default=None,
                    help="a one-off comparison: the source of an earlier B3 that reads the flat "
                         "pyramid (its dpt_pyramid_sample takes the flat pyramid's offsets), built "
                         "into a library of its own and held against this B3, bit for bit and in "
                         "turns, at the smoke's and the DSLR run's inputs")
    ap.add_argument("--compare_row_extract_sources", nargs=2, default=None, metavar=("E6_CU", "E7_CU"),
                    help="a one-off comparison: the sources of an earlier E6 and E7 (the entry "
                         "points without a grid argument), built into libraries of their own and "
                         "held against the shipped kernels bit for bit at the smoke's inputs, the "
                         "four lane classes and odd rows, and timed in turns with them")
    ap.add_argument("--compare_b4a_source", default=None, metavar="CU",
                    help="a one-off comparison: the source of an earlier B4a (the entry point of "
                         "dense operands in 4096-column blocks), built into a library of its own, "
                         "held against the float64 plain version and timed in turns with the "
                         "shipped kernel at C = 2 and C = 5 on both id layouts")
    args = ap.parse_args(argv)
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
        from dataset_pipeline_tpu_torch.experiments import gather_probe, gather_probe2
        from dataset_pipeline_tpu_torch.models.lie import quat_to_matrix_np
        from dataset_pipeline_tpu_torch.io import colmap as cio
        from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
        from dataset_pipeline_tpu_torch.ops import gather, gn, hbm
        from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps
        from dataset_pipeline_tpu_torch.photometric import optimizer
        from dataset_pipeline_tpu_torch.tools import icp_bench, icp_scan_aligner, image_registrator
        from dataset_pipeline_tpu_torch.utils import synthetic
        # slice 7's modules, imported here so that check_no_jax covers them
        from dataset_pipeline_tpu_torch import editor  # noqa: F401
        from dataset_pipeline_tpu_torch.photometric import localize, pair_alignment  # noqa: F401
        from dataset_pipeline_tpu_torch.tools import dataset_inspector  # noqa: F401
        from dataset_pipeline_tpu_torch.utils import profiling, scaling_bench  # noqa: F401
        # slice 8's modules
        from dataset_pipeline_tpu_torch import refbench  # noqa: F401
        from dataset_pipeline_tpu_torch.tools import bench as bench_tool
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    check_no_jax()

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
    # an earlier B3 takes the flat pyramid and its level offsets where this one takes the row-paired copy
    flat_sampler = (load_oneoff(kernels, args.compare_b3_source, "dpt_pyramid_sample",
                                kernels.KERNELS["pyramid_sample"].argtypes)[0]
                    if args.compare_b3_source else None)
    b3 = check_b3(torch, tps, seed=4, flat_sampler=flat_sampler)
    torch.cuda.empty_cache()
    print(f"B3 checks: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        check_registrator_small(torch, image_registrator, synthetic.write_scene, cio,
                                os.path.join(root, "small"))
        print(f"small registrator scene: {time.perf_counter() - t0:.1f} s")
        reg, dslr_b3, truth, dslr_geometry, dslr_gram = run_registrator_dslr(
            torch, kernels, image_registrator, optimizer, synthetic, cio, quat_to_matrix_np,
            os.path.join(root, "dslr"))
        torch.cuda.empty_cache()
        hb_geom = check_hb_geometry(torch, optimizer.hb_geometry, dslr_geometry,
                                    "the DSLR run's first jacobian launch")
        del dslr_geometry
        torch.cuda.empty_cache()
        hb_gram = check_hb_gram(torch, optimizer, dslr_gram, "the DSLR run's first Gram call")
        del dslr_gram
        torch.cuda.empty_cache()
        reg_lens, lens_geometry, lens_gram = run_registrator_lens(torch, kernels, optimizer)
        torch.cuda.empty_cache()
        hb_geom["thin_prism_fisheye"] = check_hb_geometry(
            torch, optimizer.hb_geometry, lens_geometry, "the fisheye cell's first jacobian launch")
        del lens_geometry
        torch.cuda.empty_cache()
        hb_gram["thin_prism_fisheye"] = check_hb_gram(torch, optimizer, lens_gram,
                                                      "the fisheye cell's first Gram call")
        del lens_gram
        torch.cuda.empty_cache()

        # ground truth and rendering: no hand-written kernel on this path
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        gt_res = run_gt_dslr(torch, synthetic, os.path.join(root, "dslr"), truth)
        torch.cuda.empty_cache()
        gt_res["small_depth_pixels_differing"] = run_small_cuda_vs_cpu(
            torch, synthetic, os.path.join(root, "small"))
        torch.cuda.empty_cache()
        gt_res["cube"] = run_cube_and_sfm(torch, root)
        torch.cuda.empty_cache()
        from dataset_pipeline_tpu_torch.ops import splat

        gt_res["zbuffer_forms"] = check_zbuffer_forms(torch, splat)
        torch.cuda.empty_cache()
        if any(kernels.LAUNCHES.values()):
            fail(f"the ground-truth path launched a hand-written kernel: {dict(kernels.LAUNCHES)}")
        print(f"ground-truth phase: {time.perf_counter() - t0:.1f} s; "
              + json.dumps({"ground_truth": gt_res}))

        # slice 4: the cleaner, both caches, depth residuals, mesh occlusion, rigs
        slice4, slice4_launches, b3_slice4 = run_slice4(
            torch, kernels, image_registrator, optimizer, synthetic, cio, quat_to_matrix_np, tps,
            root, truth)
        print(json.dumps({"slice4": slice4}, default=float))

        # slice 5: joint multi-scene BA
        slice5, slice5_launches, b3_slice5 = run_slice5(torch, kernels, synthetic, cio,
                                                        quat_to_matrix_np, tps, root)
        print(json.dumps({"slice5": slice5}, default=float))

        # slice 6: the multi-device layer (reuses the DSLR cache and the small joint-BA scenes)
        slice6, slice6_launches = run_slice6(torch, kernels, image_registrator, entry,
                                             pack_group_data, gn, cio, root)
        print(json.dumps({"slice6": slice6}, default=float))

        # slice 7: the inspector (reuses the DSLR scene and the small scene), the
        # two-frame alignment, the scaling bench
        slice7, slice7_launches, cap_insp, cap_pair = run_slice7(torch, kernels, optimizer, synthetic,
                                                                 cio, gn, pack_group_data, root, truth)
        print(json.dumps({"slice7": slice7}, default=float))
    b3_slice7 = {"inspector_value": check_b3_value_at_captured(torch, tps, cap_insp,
                                                               "the DSLR inspector's first value launch"),
                 "pair_derivs": check_b3_at_captured(torch, tps, cap_pair["derivs"],
                                                     "the two-frame alignment's first derivs launch"),
                 "pair_value": check_b3_value_at_captured(torch, tps, cap_pair["value"],
                                                          "the two-frame alignment's first value launch")}
    del cap_insp, cap_pair
    b3["dslr_inputs"] = check_b3_at_captured(torch, tps, dslr_b3, "the DSLR run's first derivs launch",
                                             flat_sampler)
    del dslr_b3
    torch.cuda.empty_cache()

    # the ICP measurement path
    t0 = time.perf_counter()
    b5b = check_b5b(torch, hbm, seed=8)
    torch.cuda.empty_cache()
    read_bps = 8 * HBM_MP * 4 / (1e-3 * b5b["ms_per_further_repeat"])  # B5b's read rate in this run
    b4a = check_b4a(torch, gn, C=2, seed=5, read_bps=read_bps)
    torch.cuda.empty_cache()
    b4a["C5"] = check_b4a(torch, gn, C=5, seed=6, read_bps=read_bps)
    torch.cuda.empty_cache()
    if args.compare_b4a_source:
        b4a["earlier"] = compare_b4a(torch, gn, kernels, args.compare_b4a_source)
    variants = check_moment_variants(torch, gn, pack_group_data, seed=7)
    torch.cuda.empty_cache()
    print(f"B4a, B4b, B4c, B5a, B5b checks: {time.perf_counter() - t0:.1f} s")
    icp_res, bench = run_icp_bench(torch, kernels, icp_bench, entry)
    torch.cuda.empty_cache()

    # slice 8: the rest of bench.py, the ICP section's results handed over
    _, slice8_launches, b3_bench = run_slice8(torch, kernels, optimizer, tps, bench_tool, icp_res)
    del icp_res
    torch.cuda.empty_cache()

    # the gather-wall path
    t0 = time.perf_counter()
    probes = check_tile_probes(torch, gather, seed=9)
    torch.cuda.empty_cache()
    probes["tile_gather"] = check_tile_gather(torch, gather, seed=10)
    torch.cuda.empty_cache()
    probes.update(check_row_extracts(torch, gather, seed=11, read_bps=read_bps))
    torch.cuda.empty_cache()
    print_tap_loads(kernels, kernels.build_info["path"], "the shipped build")
    if args.compare_row_extract_sources:
        earlier = compare_row_extracts(torch, kernels, gather, args.compare_row_extract_sources, 11,
                                       read_bps)
        probes["row_extract"]["earlier"], probes["row_extract_packed"]["earlier"] = earlier["E6"], earlier["E7"]
        torch.cuda.empty_cache()
    print(f"E1-E7 checks: {time.perf_counter() - t0:.1f} s")
    _, probe_launches = run_gather_probes(torch, kernels, gather_probe, gather_probe2)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_brick_on_b3_inputs(torch, tps, gather_probe2, seed=4)
    print(f"brick path on B3's inputs: {time.perf_counter() - t0:.1f} s")

    # per kernel: the launches of each main path that runs it (by counter: B1 and
    # B3 have two launch modes), and this run's numbers
    by_path = {"icp_scan_aligner": launches, "image_registrator": reg,
               "image_registrator_lens": reg_lens, "icp_bench": bench,
               "gather_probe": probe_launches, **slice4_launches, "joint_ba": slice5_launches,
               **slice6_launches, **slice7_launches, **slice8_launches}
    measured = {"gn_fused": b1, "moment_gram": b2,
                "pyramid_sample": {**b3["derivs"],
                                   **{k: b3[k] for k in ("pair_build", "dslr_inputs", "flat_sampler") if k in b3},
                                   "slice4_inputs": b3_slice4, "joint_ba_inputs": b3_slice5,
                                   "slice7_inputs": b3_slice7, "bench_inputs": b3_bench},
                "gn_rows": b4a,
                "hbm_read_sum": b5b, **variants, **probes, "hb_geometry": hb_geom, "hb_gram": hb_gram}
    report = []
    for kname, k in kernels.KERNELS.items():
        paths = {p: {c: counts[c] for c in k.counters if c in counts} for p, counts in by_path.items()}
        paths = {p: c for p, c in paths.items() if c}
        row = {"name": kname, "route": "cuda",
               "source": f"dataset_pipeline_tpu_torch/csrc/{k.source}", "replaces": k.replaces,
               "launches": sum(sum(c.values()) for c in paths.values()),
               "launches_by_path": paths, **measured[kname]}
        # the time above the bound that the main paths spend in the kernel
        row["excess_ms"] = row["launches"] * (row["ms"] - row["bound_ms"])
        report.append(row)
    full, batch = (sum(c.get(x, 0) for c in by_path.values())
                   for x in ("gn_fused", "gn_fused_cost_batch"))
    next(r for r in report if r["name"] == "gn_fused")["excess_ms"] = (full * (b1["ms"] - b1["bound_ms"])
                              + batch * (b1["cost_batch"]["ms"] - b1["cost_batch"]["bound_ms"]))
    samples, builds = (sum(c.get(x, 0) for x in xs for c in by_path.values())
                       for xs in (("pyramid_sample_derivs", "pyramid_sample_value"), ("pyramid_pairs",)))
    pb = b3["pair_build"]
    next(r for r in report if r["name"] == "pyramid_sample")["excess_ms"] = (
        samples * (b3["derivs"]["ms"] - b3["derivs"]["bound_ms"]) + builds * (pb["ms"] - pb["bound_ms"]))
    projects, jacobians = (sum(c.get(x, 0) for c in by_path.values())
                           for x in ("hb_geometry_project", "hb_geometry_jacobian"))
    hp = hb_geom["project"]
    next(r for r in report if r["name"] == "hb_geometry")["excess_ms"] = (
        projects * (hp["ms"] - hp["bound_ms"]) + jacobians * (hb_geom["ms"] - hb_geom["bound_ms"]))
    # which kernel a later change should take up first: those that lose to their
    # library call, then by the excess; a kernel already redesigned is not taken again
    def loses(r):
        return bool(r["library_ms"] and r["ms"] > r["library_ms"])

    order = sorted(report, key=lambda r: (r["name"] in REDESIGNED, not loses(r), -r["excess_ms"]))
    print("redesign order (launches x (ms - bound ms) on the main paths; * = slower than its "
          "library call; (redesigned) = already redesigned for this card, not taken again): "
          + ", ".join(f"{r['name']}{'*' if loses(r) else ''}"
                      f"{' (redesigned)' if r['name'] in REDESIGNED else ''} {r['excess_ms']:.2f}"
                      for r in order))
    check_no_jax()  # again: the later phases import more of the port
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
