"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: they skip without a GPU. This file imports neither jax nor
the JAX package, so on a machine with the card but without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu_torch.icp import moments as tm
from dataset_pipeline_tpu_torch.icp import point_to_plane as tpp
from dataset_pipeline_tpu_torch.ops import gn

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _groups(rng, C, sizes):
    groups, pairs = [], []
    for s in range(C):
        for tg in range(C):
            if s == tg:
                continue
            m = sizes[len(pairs) % len(sizes)]
            ps = rng.randn(m, 3).astype(np.float32)
            ns = rng.randn(m, 3)
            nt = rng.randn(m, 3)
            groups.append({"ps": ps,
                           "ns": (ns / np.linalg.norm(ns, axis=1, keepdims=True)).astype(np.float32),
                           "pt": (ps + 0.05 * rng.randn(m, 3)).astype(np.float32),
                           "nt": (nt / np.linalg.norm(nt, axis=1, keepdims=True)).astype(np.float32),
                           "w": rng.rand(m).astype(np.float32)})
            pairs.append((s, tg))
    return groups, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("C,chunk", [(2, 256), (3, 1024), (5, 2048), (2, 49152)])
def test_gn_fused_kernel_matches_plain(cuda_device, C, chunk):
    rng = np.random.RandomState(50 + C)
    groups, pairs = _groups(rng, C, [3000, 700, 5100])
    data, gid = tm.pack_group_data(groups, chunk=chunk, rows=13, device=cuda_device)
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid], device=cuda_device)
    qt = [tm.se3_exp_np(0.3 * rng.randn(6)) for _ in range(C)]
    q = torch.tensor(np.stack([a for a, _ in qt]), dtype=torch.float32, device=cuda_device)
    t = torch.tensor(np.stack([b for _, b in qt]), dtype=torch.float32, device=cuda_device)
    n0 = gn.LAUNCHES["gn_fused"]
    got = [x.cpu().numpy() for x in gn.icp_hb_cost_fused(q, t, data, cp, C, chunk)]
    assert gn.LAUNCHES["gn_fused"] == n0 + 1
    again = [x.cpu().numpy() for x in gn.icp_hb_cost_fused(q, t, data, cp, C, chunk)]
    ref = [x.cpu().numpy() for x in gn.gn_fused_plain(q.double(), t.double(), data.double(), cp, C, chunk)]
    for g, a, r in zip(got, again, ref):
        np.testing.assert_array_equal(g, a)  # deterministic: no atomics
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.cuda
@pytest.mark.parametrize("C,chunk,K", [(2, 256, 10), (3, 1024, 4), (5, 2048, 10), (2, 49152, 1),
                                       (2, 128, 3)])
def test_gn_cost_batch_kernel_has_the_full_pass_bits(cuda_device, C, chunk, K):
    """B1's cost batch: one launch, within 1e-5 of the float64 plain version,
    and each element bit-equal to the full pass's cost at that candidate."""
    rng = np.random.RandomState(150 + C)
    groups, pairs = _groups(rng, C, [3000, 700, 5100])
    data, gid = tm.pack_group_data(groups, chunk=chunk, rows=13, device=cuda_device)
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid], device=cuda_device)
    cands = [[tm.se3_exp_np(0.3 * rng.randn(6)) for _ in range(C)] for _ in range(K)]
    qs = torch.tensor(np.asarray([[a for a, _ in c] for c in cands]), dtype=torch.float32,
                      device=cuda_device)
    ts = torch.tensor(np.asarray([[b for _, b in c] for c in cands]), dtype=torch.float32,
                      device=cuda_device)
    n0 = gn.LAUNCHES["gn_fused_cost_batch"]
    got = gn.icp_cost_batch_fused(qs, ts, data, cp, C, chunk)
    assert gn.LAUNCHES["gn_fused_cost_batch"] == n0 + 1
    assert torch.equal(got, gn.icp_cost_batch_fused(qs, ts, data, cp, C, chunk))
    ref = gn.gn_cost_batch_plain(qs.double(), ts.double(), data.double(), cp, C, chunk)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5)
    for k in range(K):
        assert torch.equal(got[k], gn.icp_hb_cost_fused(qs[k], ts[k], data, cp, C, chunk)[2])
    with pytest.raises(ValueError, match="K <= 10"):
        gn.icp_cost_batch_fused(qs[:1].expand(11, C, 4), ts[:1].expand(11, C, 3), data, cp, C, chunk)
    bad = cp.clone()
    bad[0, 1] = C  # no such cloud: NaN, not a read out of bounds
    assert bool(gn.icp_cost_batch_fused(qs, ts, data, bad, C, chunk).isnan().all())
    assert all(bool(x.isnan().all()) for x in gn.icp_hb_cost_fused(qs[0], ts[0], data, bad, C, chunk))


@pytest.mark.cuda
def test_gn_fused_rejects_misaligned_data_on_the_card(cuda_device):
    data = torch.zeros(13 * 512 + 1, device=cuda_device)[1:].view(13, 512)
    cp = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    q = torch.tensor([[1.0, 0, 0, 0]] * 2, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        gn.icp_hb_cost_fused(q, torch.zeros((2, 3), device=cuda_device), data, cp, 2, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [256, 512, 768, 49152])
def test_moment_gram_kernel_matches_plain(cuda_device, chunk):
    rng = np.random.RandomState(60)
    groups, _ = _groups(rng, 2, [5000, 30000])
    data, gid = tm.pack_group_data(groups, chunk=chunk, rows=13, device=cuda_device)
    n0 = gn.LAUNCHES["moment_gram"]
    parts, per_chunk = gn.moment_gram_partials(data, chunk)
    assert gn.LAUNCHES["moment_gram"] == n0 + 1
    # the 28 x 21 factored sums are scattered to both triangles: exactly symmetric,
    # and added in a fixed order: bitwise reproducible
    assert torch.equal(parts, parts.transpose(1, 2))
    assert torch.equal(parts, gn.moment_gram_partials(data, chunk)[0])
    got = parts.double().cpu().numpy().reshape(len(gid), per_chunk, 42, 42).sum(1)
    ref = gn.moment_gram_plain(data.double(), chunk).cpu().numpy()
    for k in range(len(gid)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-5 * np.abs(ref[k]).max())


@pytest.mark.cuda
def test_engine_on_cuda_matches_cpu(cuda_device):
    """Three perturbed copies of a curved surface: the CUDA engine (kernels)
    and the CPU engine (plain versions) reach the same poses."""
    rng = np.random.RandomState(11)
    base = rng.rand(4000, 3).astype(np.float32) * 2
    base[:, 2] = 0.2 * np.sin(4 * base[:, 0]) + 0.1 * np.cos(3 * base[:, 1])
    n = np.stack([-0.8 * np.cos(4 * base[:, 0]), 0.3 * np.sin(3 * base[:, 1]),
                  np.ones(len(base))], -1)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    poses = []
    gn.reset_launch_counts()
    for dev in (cuda_device, torch.device("cpu")):
        icp = tpp.PointToPlaneICP(device=dev)
        icp.add_point_cloud(base, n)
        for seed in (5, 6):
            r = np.random.RandomState(seed)
            dq, dt = tm.se3_exp_np(np.concatenate([0.02 * r.randn(3), 0.02 * r.randn(3)]))
            R = tm.quat_to_matrix_np(dq)
            icp.add_point_cloud((base @ R.T + dt).astype(np.float32), (n @ R.T).astype(np.float32))
        poses.append(icp.run(0.3, max_num_iterations=20, convergence_threshold_max_movement=1e-9).poses)
    assert gn.LAUNCHES["gn_fused"] > 0 and gn.LAUNCHES["moment_gram"] > 0
    assert gn.LAUNCHES["gn_fused_cost_batch"] > 0  # the ladders' candidates in one pass
    for a, b in zip(*poses):
        np.testing.assert_allclose(a, b, atol=1e-5)


def _b3_inputs(device, nb, H, W, L, n, seed):
    from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps

    rng = np.random.RandomState(seed)
    pyr = [torch.from_numpy((rng.rand(nb, H, W) * 255).astype(np.float32)).to(device)]
    for _ in range(1, L):
        h, w = pyr[-1].shape[1:]
        pyr.append(pyr[-1][:, : h // 2 * 2, : w // 2 * 2].reshape(nb, h // 2, 2, w // 2, 2)
                   .mean((2, 4)))
    flat, layout = tps.flatten_pyramid(pyr)
    pix = np.stack([rng.rand(nb, n) * (W + 6) - 3, rng.rand(nb, n) * (H + 6) - 3], -1)
    pix[:, : n // 5] = np.round(pix[:, : n // 5])  # integer coordinates
    scale = rng.rand(nb, n) * (L + 0.6) - 0.3
    scale[:, : n // 10] = np.round(scale[:, : n // 10])
    return (tps, flat, layout, torch.from_numpy(pix.astype(np.float32)).to(device),
            torch.from_numpy(scale.astype(np.float32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("L,with_derivs", [(1, True), (5, True), (5, False), (3, True), (1, False),
                                           (3, False)])
def test_pyramid_sample_kernel_matches_plain(cuda_device, L, with_derivs):
    tps, flat, layout, pix, scale = _b3_inputs(cuda_device, 3, 257, 383, L, 20000, 70 + L)
    key = "pyramid_sample_derivs" if with_derivs else "pyramid_sample_value"
    n0, p0 = gn.LAUNCHES[key], gn.LAUNCHES["pyramid_pairs"]
    got = tps.pyramid_sample(flat, layout, pix, scale, with_derivs)  # builds the paired copy
    assert gn.LAUNCHES[key] == n0 + 1 and gn.LAUNCHES["pyramid_pairs"] == p0 + 1
    pairs = tps.pair_rows(flat, layout)  # as the registrator: once per image chunk
    again = tps.pyramid_sample(flat, layout, pix, scale, with_derivs, pairs)
    assert gn.LAUNCHES["pyramid_pairs"] == p0 + 2
    ref = tps.sample_plain(flat, layout, pix, scale, with_derivs)
    ok = ref[-1]
    assert torch.equal(got[-1], ok)  # ok bit-equal, integer coordinates included
    assert torch.equal(again[-1], ok)
    for g, a, r in zip(got[:-1], again[:-1], ref[:-1]):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g[ok].cpu().numpy(), r[ok].cpu().numpy(), rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [[(257, 383), (128, 191), (64, 95)], [(5, 2)], [(6, 7), (3, 3)]])
def test_pyramid_pairs_kernel_matches_plain(cuda_device, shapes):
    """The row-paired copy B3 reads: bit for bit its plain version, padding
    of odd widths included, and every level 16-byte aligned."""
    from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps

    rng = np.random.RandomState(len(shapes))
    pyr = [torch.from_numpy(rng.randn(3, h, w).astype(np.float32)).to(cuda_device) for h, w in shapes]
    flat, layout = tps.flatten_pyramid(pyr)
    n0 = gn.LAUNCHES["pyramid_pairs"]
    pairs = tps.pair_rows(flat, layout)
    assert gn.LAUNCHES["pyramid_pairs"] == n0 + 1
    assert pairs.data_ptr() % 16 == 0 and all(o % 4 == 0 for o in layout.pair_offs)
    assert torch.equal(pairs, tps.pair_rows_plain(flat, layout))
    with pytest.raises(ValueError, match="row-paired copy"):
        tps.pyramid_sample(flat, layout, torch.zeros((3, 4, 2), device=cuda_device),
                           torch.zeros((3, 4), device=cuda_device), True, pairs[:, 4:])


@pytest.mark.cuda
def test_pyramid_sample_rejects_non_float32(cuda_device):
    tps, flat, layout, pix, scale = _b3_inputs(cuda_device, 1, 40, 50, 2, 100, 1)
    with pytest.raises(ValueError, match="float32"):
        tps.pyramid_sample(flat.double(), layout, pix, scale)


# ---------------------------------------------------------------------------
# B4a, B4b, B4c, B5a, B5b
# ---------------------------------------------------------------------------


def _packed_cuda(device, chunk, sizes, seed, rows=13):
    groups, _ = _groups(np.random.RandomState(seed), 2, sizes)
    return tm.pack_group_data(groups, chunk=chunk, rows=rows, device=device)[0]


def _rows_ids(rng, C, M, ids):
    """Per-row cloud ids: "random" in range; "sorted" in groups of one ordered
    pair (the engine's layout; at C = 2 the ICP bench's (0, 1), (1, 0));
    "unknown" drawn from [-2, C + 2), so that rows have both, one or no id
    outside [0, C)."""
    if ids == "random":
        sid = rng.randint(0, C, M)
        return sid, (sid + rng.randint(0, C, M)) % C
    if ids == "unknown":
        return rng.randint(-2, C + 2, M), rng.randint(-2, C + 2, M)
    pairs = [(s, t) for s in range(C) for t in range(C) if s != t]
    sizes = np.diff(np.linspace(0, M, len(pairs) + 1).astype(int))
    return tuple(np.repeat(np.asarray(col), sizes) for col in zip(*pairs))


@pytest.mark.cuda
@pytest.mark.parametrize("C,M,ids", [(1, 900, "random"), (2, 100_000, "random"), (3, 4096, "random"),
                                     (5, 70_001, "random"), (14, 9000, "random"), (21, 20_000, "random"),
                                     (2, 100_000, "sorted"), (5, 70_001, "sorted"),
                                     (2, 50_001, "unknown"), (5, 50_001, "unknown")])
def test_gn_rows_kernel_matches_plain(cuda_device, C, M, ids):
    rng = np.random.RandomState(80 + C)
    j1, j2 = (torch.from_numpy(rng.randn(6, M).astype(np.float32)).to(cuda_device) for _ in range(2))
    r1, r2 = (torch.from_numpy((0.1 * rng.randn(M)).astype(np.float32)).to(cuda_device)
              for _ in range(2))
    sid, tid = (torch.from_numpy(x.astype(np.int32)).to(cuda_device) for x in _rows_ids(rng, C, M, ids))
    w = torch.from_numpy(np.where(rng.rand(M) < 0.5, rng.rand(M) > 0.2, rng.rand(M))
                         .astype(np.float32)).to(cuda_device)
    n0 = gn.LAUNCHES["gn_rows"]
    got = [x.cpu().numpy() for x in gn.gn_rows(j1, j2, r1, r2, sid, tid, w, C)]
    assert gn.LAUNCHES["gn_rows"] == n0 + 1
    again = [x.cpu().numpy() for x in gn.gn_rows(j1, j2, r1, r2, sid, tid, w, C)]
    ref = [x.cpu().numpy() for x in gn.gn_rows_plain(j1.double(), j2.double(), r1.double(),
                                                     r2.double(), sid, tid, w.double(), C)]
    np.testing.assert_array_equal(got[0], got[0].T)
    for g, a, r in zip(got, again, ref):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * max(np.abs(r).max(), 1e-30))
    with pytest.raises(ValueError, match="num_clouds"):
        gn.gn_rows(j1, j2, r1, r2, sid, tid, w, 22)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [128, 384, 16384])
def test_moment_gram48_kernel_matches_plain(cuda_device, chunk):
    data = _packed_cuda(cuda_device, chunk, [5000, 30000], 61, rows=16)
    n0 = gn.LAUNCHES["moment_gram48"]
    got = gn.moment_gram48(data, chunk)
    assert gn.LAUNCHES["moment_gram48"] == n0 + 1
    assert torch.equal(got, gn.moment_gram48(data, chunk))
    assert not got[:, 42:, :].any() and not got[:, :, 42:].any()
    ref = gn.moment_gram48_plain(data.double(), chunk).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0, atol=2e-5 * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,rows", [(384, 13), (768, 16), (24576, 13), (49152, 13)])
def test_moment_gram_thirds_kernel_matches_plain(cuda_device, chunk, rows):
    data = _packed_cuda(cuda_device, chunk, [5000, 60000], 62, rows=rows)
    n0 = gn.LAUNCHES["moment_gram_thirds"]
    got = gn.moment_gram_thirds(data, chunk)
    assert gn.LAUNCHES["moment_gram_thirds"] == n0 + 1
    assert torch.equal(got, gn.moment_gram_thirds(data, chunk))
    ref = gn.moment_gram_thirds_plain(data.double(), chunk).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    whole = gn.moment_gram_plain(data.double(), chunk).cpu().numpy()
    np.testing.assert_allclose(gn.moment_tri_extract(got.double()).cpu().numpy(), whole, rtol=0,
                               atol=2e-5 * np.abs(whole).max())


@pytest.mark.cuda
@pytest.mark.parametrize("repeats", [1, 2, 5])
def test_moment_gram_repeat_kernel_matches_plain(cuda_device, repeats):
    chunk = 2048
    data2 = torch.stack([_packed_cuda(cuda_device, chunk, [5000, 30000], s) for s in (63, 64)])
    n0 = gn.LAUNCHES["moment_gram_repeat"]
    got, per_chunk = gn.moment_gram_repeat(data2, chunk, repeats)
    assert gn.LAUNCHES["moment_gram_repeat"] == n0 + 1
    assert torch.equal(got, gn.moment_gram_repeat(data2, chunk, repeats)[0])
    got = got.double().reshape(-1, per_chunk, 42, 42).sum(1).cpu().numpy()
    ref = gn.moment_gram_repeat_plain(data2.double(), chunk, repeats).cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    if repeats == 1:  # one repeat is the B2 kernel, bit for bit
        assert torch.equal(gn.moment_gram_repeat(data2, chunk, 1)[0],
                           gn.moment_gram_partials(data2[0], chunk)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mp,repeats", [(4, 1), (5000, 3), (1 << 20, 1), (1 << 20, 4)])
def test_hbm_read_sum_kernel_matches_plain(cuda_device, mp, repeats):
    from dataset_pipeline_tpu_torch import kernels
    from dataset_pipeline_tpu_torch.ops import hbm

    data2 = torch.from_numpy(np.random.RandomState(65).randn(2, 8, mp).astype(np.float32)).to(cuda_device)
    n0 = kernels.LAUNCHES["hbm_read_sum"]
    got = hbm.hbm_read_sum(data2, repeats)
    assert kernels.LAUNCHES["hbm_read_sum"] == n0 + 1
    # one kernel per repeat, the last one making the final sum: one in all at R = 1
    assert hbm.last_call_kernel_launches == repeats
    assert torch.equal(got, hbm.hbm_read_sum(data2, repeats))
    ref = hbm.hbm_read_sum_plain(data2.double(), repeats).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0,
                               atol=1e-5 * float(data2.abs().sum(2).max()))
    with pytest.raises(ValueError, match="multiple of 4"):
        hbm.hbm_read_sum(data2[:, :, : mp - 1].contiguous(), 1)


# ---------------------------------------------------------------------------
# E1-E7 and the brick path
# ---------------------------------------------------------------------------


def _count(name):
    from dataset_pipeline_tpu_torch import kernels

    return kernels.LAUNCHES[name]


def _cu(rng, device, hi=None, shape=None):
    """A float32 N(0,1) tensor, or int32 indices below ``hi``, on the card."""
    a = rng.randn(*shape).astype(np.float32) if hi is None else rng.randint(0, hi, shape).astype(np.int32)
    return torch.from_numpy(a).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(1, 64, 128), (37, 64, 128), (5, 8, 36)])
def test_tile_gathers_match_plain(cuda_device, B, S, W):
    """E1-E4 are pure moves: exactly the plain versions; one launch each."""
    from dataset_pipeline_tpu_torch.ops import gather

    rng = np.random.RandomState(B)
    rows = _cu(rng, cuda_device, shape=(B, S, W))
    K = min(S, 8)
    cases = [
        ("take_along_lanes", gather.take_along_lanes, gather.take_along_lanes_plain,
         (rows, _cu(rng, cuda_device, W, (B, S, W)))),
        ("take_along_sublanes", gather.take_along_sublanes, gather.take_along_sublanes_plain,
         (rows, _cu(rng, cuda_device, S, (B, K, W)))),
        ("take_rows", gather.take_rows, gather.take_rows_plain,
         (rows, _cu(rng, cuda_device, S, (B, 19)))),
        ("advanced_2d", gather.advanced_2d, gather.advanced_2d_plain,
         (rows, _cu(rng, cuda_device, S, (B, K, W)), _cu(rng, cuda_device, W, (B, K, W)))),
    ]
    for name, fn, plain, args in cases:
        n0 = _count(name)
        got = fn(*args)
        assert _count(name) == n0 + 1
        assert torch.equal(got, plain(*args)), name
    with pytest.raises(ValueError, match="must lie in"):
        gather.take_along_lanes(rows, torch.full((B, S, W), W, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        gather.take_along_lanes(rows.double(), cases[0][3][1])
    with pytest.raises(ValueError, match="int32"):
        gather.take_along_lanes(rows, cases[0][3][1].long())


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles,cap", [(1, 512), (300, 512), (7, 100)])
def test_tile_gather_kernel_matches_plain(cuda_device, n_tiles, cap):
    from dataset_pipeline_tpu_torch.ops import gather

    rng = np.random.RandomState(cap + n_tiles)
    tiles = _cu(rng, cuda_device, shape=(n_tiles, 8, 128))
    iy, ix = _cu(rng, cuda_device, 7, (n_tiles, cap)), _cu(rng, cuda_device, 127, (n_tiles, cap))
    fy, fx = (torch.from_numpy(rng.rand(n_tiles, cap).astype(np.float32)).to(cuda_device)
              for _ in range(2))
    n0 = _count("tile_gather")
    got = gather.tile_gather(tiles, iy, ix, fy, fx)
    assert _count("tile_gather") == n0 + 1
    ref = gather.tile_gather_plain(tiles.double(), iy, ix, fy.double(), fx.double())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=2e-6)
    # no FMA in the kernel: the float32 plain version's bits
    assert torch.equal(got, gather.tile_gather_plain(tiles, iy, ix, fy, fx))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 100_001])
def test_row_extract_kernels_match_plain(cuda_device, n):
    from dataset_pipeline_tpu_torch.ops import gather

    rng = np.random.RandomState(n)
    ra, rb = _cu(rng, cuda_device, shape=(n, 128)), _cu(rng, cuda_device, shape=(n, 128))
    fr = [torch.from_numpy(rng.rand(n, 1).astype(np.float32)).to(cuda_device) for _ in range(5)]
    lane = _cu(rng, cuda_device, 127, (n, 1))
    n0 = _count("row_extract")
    got = gather.row_extract(ra, rb, lane, fr[0], fr[1])
    assert _count("row_extract") == n0 + 1
    assert torch.equal(got, gather.row_extract_plain(ra, rb, lane, fr[0], fr[1]))
    la, lb = _cu(rng, cuda_device, 95, (n, 1)), _cu(rng, cuda_device, 95, (n, 1))
    n0 = _count("row_extract_packed")
    got = gather.row_extract_packed(ra, rb, la, lb, *fr)
    assert _count("row_extract_packed") == n0 + 1
    assert torch.equal(got, gather.row_extract_packed_plain(ra, rb, la, lb, *fr))
    with pytest.raises(ValueError, match="lane must lie in"):
        gather.row_extract(ra, rb, lane + 127, fr[0], fr[1])
    if n > 1:  # a single row is contiguous either way
        with pytest.raises(ValueError, match="contiguous"):
            gather.row_extract(ra.T.contiguous().T, rb, lane, fr[0], fr[1])


@pytest.mark.cuda
@pytest.mark.parametrize("W,bx,offset", [(127, 9, 1), (127, 32, 1), (128, 32, 1), (127, 32, 0)])
def test_row_extract_kernels_on_unaligned_rows(cuda_device, W, bx, offset):
    """E6 and E7 at the probes' n = 1,998,848 on rows of odd width and rows
    that start 4 bytes past a 16-byte boundary: the tap loads are chosen from
    the address, and a vector load whose address test were wrong would fault
    here (never in the host emulation). Bit-equal to the float32 plain
    versions, two launches bit-identical, one launch per call."""
    from dataset_pipeline_tpu_torch.ops import gather

    n = 1_998_848
    g = torch.Generator(device=cuda_device).manual_seed(W + bx + offset)
    ra, rb = (torch.randn(n * W + 4, generator=g, device=cuda_device)[offset:offset + n * W].view(n, W)
              for _ in range(2))
    assert ra.is_contiguous() and ra.data_ptr() % 16 == 4 * offset
    fr = [torch.rand((n, 1), generator=g, device=cuda_device) for _ in range(5)]
    lane = torch.randint(0, W - 1, (n, 1), generator=g, device=cuda_device, dtype=torch.int32)
    la, lb = (torch.randint(0, W - bx - 1, (n, 1), generator=g, device=cuda_device, dtype=torch.int32)
              for _ in range(2))
    for name, fn, plain, args, kw in (
            ("row_extract", gather.row_extract, gather.row_extract_plain, (ra, rb, lane, fr[0], fr[1]), {}),
            ("row_extract_packed", gather.row_extract_packed, gather.row_extract_packed_plain,
             (ra, rb, la, lb, *fr), {"bx": bx})):
        n0 = _count(name)
        got = fn(*args, **kw)
        assert _count(name) == n0 + 1
        assert torch.equal(got, fn(*args, **kw)), name
        assert torch.equal(got, plain(*args, **kw)), name


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 5])
def test_brick_path_matches_flat_sampler_on_the_card(cuda_device, L):
    from dataset_pipeline_tpu_torch.ops import brick

    tps, flat, layout, pix, scale = _b3_inputs(cuda_device, 2, 257, 383, L, 20000, 90 + L)
    ref = tps.pyramid_sample(flat, layout, pix, scale, True)
    for b in range(2):
        pyr = [flat[b, o:o + h * w].reshape(h, w)
               for h, w, o in zip(layout.hs, layout.ws, layout.offs)]
        n0 = _count("row_extract_packed")
        got = brick.brick_sample_with_derivs(brick.build_brick_pyramid(pyr), L, pix[b], scale[b])
        assert _count("row_extract_packed") == n0 + 1
        ok = ref[-1][b]
        assert torch.equal(got[-1], ok)
        for g, r in zip(got[:-1], ref[:-1]):
            np.testing.assert_allclose(g[ok].cpu().numpy(), r[b][ok].cpu().numpy(), rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# Slice 3 (ground truth and rendering): no hand-written kernel, plain torch on
# the card held against the same functions on the CPU, bit for bit (one op
# per kernel, the fused forms written as addcmul; a min, an OR or a
# last-writer key do not depend on the order of writes).
# ---------------------------------------------------------------------------


def _both(fn, *args):
    """fn on the card and on the CPU; tensors in ``args`` go to each device."""
    def on(dev):
        out = fn(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
        return tuple(o.cpu() for o in out) if isinstance(out, tuple) else out.cpu()
    return on("cuda"), on("cpu")


def _assert_same(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.cuda
def test_zbuffer_and_point_renders_match_cpu(cuda_device):
    from dataset_pipeline_tpu_torch.ops import splat

    rng = np.random.RandomState(60)
    n_px, n = 50_000, 400_000
    flat = torch.from_numpy(rng.randint(-100, n_px + 100, n))
    z = torch.from_numpy(rng.randint(0, 50, n).astype(np.float32))  # z-ties
    aux = torch.from_numpy(rng.randint(0, 1 << 24, n).astype(np.int32))
    _assert_same(*_both(lambda f, zz, a: splat.zbuffer_min(f, zz, n_px, aux=a), flat, z, aux))
    xy = rng.uniform(-1.2, 1.2, (2, 300_000, 2))
    zc = rng.uniform(-0.2, 3.0, (2, 300_000, 1))
    pts = torch.from_numpy(np.concatenate([xy * np.abs(zc), zc], -1).astype(np.float32))
    cols = torch.from_numpy(rng.randint(0, 256, (300_000, 3)).astype(np.uint8))
    _assert_same(*_both(lambda p, c: splat.render_points_depth_color(p, c, 320, 240, 150.0, 151.0,
                                                                     160, 119.5), pts, cols))


@pytest.mark.cuda
def test_fills_match_cpu(cuda_device):
    from dataset_pipeline_tpu_torch.ops import splat

    rng = np.random.RandomState(61)
    depth = rng.uniform(1.0, 5.0, (3, 200, 260)).astype(np.float32)
    depth[rng.rand(3, 200, 260) < np.linspace(0.1, 0.97, 200)[:, None]] = np.inf
    depth[2] = np.inf  # no seed
    color = rng.randint(0, 256, (3, 200, 260, 3)).astype(np.uint8)
    d, c = torch.from_numpy(depth), torch.from_numpy(color)
    _assert_same(*_both(splat.fill_depth_holes, d))
    filled = _both(splat.fill_color_from_depth, d, c)
    _assert_same(*filled)
    _assert_same(*_both(splat.flood_fill_colors, *filled[1]))


def _mesh_scene():
    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.utils import synthetic

    cam = cm.make_camera("PINHOLE", 320, 240, [260.0, 260.0, 159.5, 119.5], device="cpu")
    verts, faces = synthetic.surface_mesh(3.0, 2.3, 0.05, 5.0, hole=(-0.5, 0.3, -0.4, 0.2))
    # a foreground patch for silhouettes and an edge of large triangles (32-px tier)
    fg, ff = synthetic.surface_mesh(0.4, 0.3, 0.1, 3.5)
    big, bf = synthetic.surface_mesh(1.5, 1.0, 0.5, 4.0)
    v = np.concatenate([verts, fg, big])
    f = np.concatenate([faces, ff + len(verts), bf + len(verts) + len(fg)])
    return cam, v, f


@pytest.mark.cuda
def test_mesh_occlusion_depth_with_edge_splats_matches_cpu(cuda_device):
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.ops import mesh_raster as mr

    cam, v, f = _mesh_scene()
    q = torch.tensor([0.9999, 0.01, -0.008, 0.005])
    pose = SE3(q / torch.linalg.vector_norm(q), torch.tensor([0.03, -0.02, 0.1]))
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = mr.build_occlusion_mesh(v, f, device=dev)
        out[dev] = mr.render_occlusion_mesh_depth(cam.to(dev), SE3(pose.q.to(dev), pose.t.to(dev)),
                                                  mesh, splat_radius=0.03).cpu()
    np.testing.assert_array_equal(out["cuda"].numpy(), out["cpu"].numpy())
    assert (out["cpu"] == -1).sum() > 100 and (out["cpu"] > 0).float().mean() > 0.5


@pytest.mark.cuda
def test_mesh_color_with_duplicate_faces_matches_cpu(cuda_device):
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.ops import mesh_raster as mr

    cam, v, f = _mesh_scene()
    v3 = np.concatenate([v, v, v])
    f3 = np.concatenate([f, f + len(v), f + 2 * len(v)])  # coplanar duplicates
    cols = np.random.RandomState(62).uniform(0, 255, (len(v3), 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = mr.build_occlusion_mesh(v3, f3, device=dev)
        out[dev] = tuple(x.cpu() for x in mr.render_mesh_depth_color(
            cam.to(dev), SE3.identity(device=dev), mesh, torch.from_numpy(cols).to(dev)))
    _assert_same(out["cuda"], out["cpu"])


@pytest.mark.cuda
def test_min_dist_sq_within_matches_cpu(cuda_device):
    from dataset_pipeline_tpu_torch.ops import tridist
    from dataset_pipeline_tpu_torch.utils import synthetic

    verts, faces = synthetic.surface_mesh(1.0, 1.0, 0.02, 5.0, hole=(-0.3, 0.3, -0.3, 0.3))
    rng = np.random.RandomState(63)
    q = np.concatenate([rng.uniform(-1.1, 1.1, (200_000, 2)), rng.uniform(4.9, 5.1, (200_000, 1))],
                       1).astype(np.float32)
    out = {}
    for dev, chunk in (("cuda", 1 << 17), ("cpu", 8192)):
        grid = tridist.build_triangle_grid(verts, faces, 0.03, device=dev)
        out[dev] = tridist.min_dist_sq_within(grid, torch.from_numpy(q).to(dev), chunk=chunk).cpu()
    np.testing.assert_array_equal(out["cuda"].numpy(), out["cpu"].numpy())
    assert torch.isinf(out["cpu"]).any() and torch.isfinite(out["cpu"]).float().mean() > 0.3


@pytest.mark.cuda
def test_ground_truth_creator_matches_cpu(cuda_device, tmp_path):
    from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
    from dataset_pipeline_tpu_torch.tools import ground_truth_creator as gt
    from dataset_pipeline_tpu_torch.utils import synthetic

    root = str(tmp_path)
    tq, tt = synthetic.write_scene(root, 160, 120, 140.0, 3, 40_000, seed=4, device="cpu")
    synthetic.write_state(f"{root}/state_true", tq, tt)
    hw, hh = synthetic.scan_extent(160, 120, 140.0, 3, synthetic.DEPTH, 0.15)
    verts, faces = synthetic.surface_mesh(hw, hh, 0.05, synthetic.DEPTH)
    write_ply(f"{root}/mesh.ply", PointCloud(verts, faces=faces))
    for extra in ([], ["--occlusion_mesh_path", f"{root}/mesh.ply"]):
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = f"{root}/out_{dev}_{len(extra)}"
            assert gt.main(["--scan_alignment_path", f"{root}/scene.mlp", "--state_path",
                            f"{root}/state_true", "--output_folder_path", outs[dev],
                            "--write_occlusion_depth", "1", "--device", dev, *extra]) == 0
        for sub in ("ground_truth_depth", "occlusion_depth"):
            for name in ("img000.pgm", "img001.pgm", "img002.pgm"):
                a = np.fromfile(f"{outs['cuda']}/{sub}/{name}", np.float32)
                b = np.fromfile(f"{outs['cpu']}/{sub}/{name}", np.float32)
                np.testing.assert_array_equal(a, b)
        with open(f"{outs['cuda']}/scan_alignment.mlp") as a, open(f"{outs['cpu']}/scan_alignment.mlp") as b:
            assert a.read() == b.read()


# ---------------------------------------------------------------------------
# Slice 4: the cleaner's kNN and filter, a small rig scene
# ---------------------------------------------------------------------------


def _slab(n, seed):
    rng = np.random.RandomState(seed)
    s = np.sqrt(12.0 / n)
    return np.concatenate([rng.rand(n, 3) * np.asarray([4.0, 3.0, 0.002]),
                           rng.rand(n // 100, 3) * np.asarray([4.0, 3.0, 8 * s])
                           + np.asarray([0, 0, 4 * s])]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 271])
def test_knn_adaptive_on_the_card_matches_cpu(cuda_device, k):
    """The adaptive kNN keeps a CUDA tensor on the card and returns the CPU
    run's indices (the grid pass, repairs and brute force included)."""
    from dataset_pipeline_tpu_torch.ops import knn

    pts = torch.from_numpy(_slab(60_000, 1))
    q = pts[::7]
    stats = {}
    d_gpu, i_gpu = knn.knn_adaptive(pts.to(cuda_device), q.to(cuda_device), k, stats=stats)
    assert d_gpu.is_cuda and i_gpu.is_cuda
    d_cpu, i_cpu = knn.knn_adaptive(pts, q, k)
    assert stats["grid_cells"] < 2 ** 31
    same = (i_gpu.cpu() == i_cpu).all(1)
    # a row may differ only where two candidates tie within float32 rounding
    assert float(same.double().mean()) >= 0.999
    np.testing.assert_allclose(d_gpu.cpu().numpy(), d_cpu.numpy(), rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_cleaner_mask_on_the_card_matches_cpu(cuda_device, tmp_path):
    """``remove_outliers`` (device brute force below the switch) and the
    adaptive filter: the CUDA masks equal the CPU masks but for threshold
    ulps, and the cleaner CLI writes the same PLYs on both devices."""
    from dataset_pipeline_tpu_torch.io.ply import PointCloud, write_ply
    from dataset_pipeline_tpu_torch.ops import outlier
    from dataset_pipeline_tpu_torch.tools import point_cloud_cleaner

    pts = _slab(40_000, 2)
    filters = [(30, 1.15), (20, 1.15)]
    m_gpu = outlier.remove_outliers(pts, filters, device=cuda_device)
    m_cpu = outlier.remove_outliers(pts, filters, device="cpu")
    assert (m_gpu != m_cpu).sum() <= 4
    a_gpu = outlier._outliers_from_adaptive_knn(torch.from_numpy(pts).to(cuda_device), 30, 1.15)
    a_cpu = outlier._outliers_from_adaptive_knn(torch.from_numpy(pts), 30, 1.15)
    assert int((a_gpu.cpu() != a_cpu).sum()) <= 4
    for dev in ("cuda", "cpu"):
        write_ply(str(tmp_path / f"{dev}.ply"), PointCloud(pts))
        assert point_cloud_cleaner.main(["--in", str(tmp_path / f"{dev}.ply"), "--filter", "30,1.15",
                                         "--device", dev]) == 0
    diff = sum(open(tmp_path / f"cuda.{s}.ply", "rb").read() != open(tmp_path / f"cpu.{s}.ply",
                                                                      "rb").read()
               for s in ("inliers", "outliers"))
    assert diff == 0 or (m_gpu != m_cpu).any()


@pytest.mark.cuda
def test_rig_scene_on_the_card_matches_cpu(cuda_device, tmp_path):
    """A small rig scene (two sets of a two-camera rig, 480x320) through the
    registrator CLI with the observations cache, on CUDA and on the CPU: the
    states agree within 5e-7 per qvec / tvec entry; B3 ran on the card."""
    from dataset_pipeline_tpu_torch import kernels
    from dataset_pipeline_tpu_torch.io import colmap as cio
    from dataset_pipeline_tpu_torch.tools import image_registrator
    from dataset_pipeline_tpu_torch.utils import synthetic

    root = tmp_path / "rig"
    synthetic.write_scene(str(root), 480, 320, 2800.0 * 480 / 3072, 4, 6000, seed=7,
                          device="cpu", rig=[-0.15, 0.0, 0.0, 0.0, 0.004, 0.0])
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        assert image_registrator.main([
            "--scan_alignment_path", str(root / "scene.mlp"), "--image_base_path",
            str(root / "images"), "--state_path", str(root / "state"), "--output_folder_path",
            str(root / dev), "--max_iterations", "2", "--cache_observations", "--device", dev]) == 0
        if dev == "cuda":
            assert kernels.LAUNCHES["pyramid_sample_derivs"] > 0
    for d in sorted(x for x in (root / "cpu").iterdir() if x.name.startswith("scale_")):
        a, b = cio.read_model(str(d)), cio.read_model(str(root / "cuda" / d.name))
        for i in a.images:
            np.testing.assert_allclose(b.images[i].qvec, a.images[i].qvec, rtol=0, atol=5e-7)
            np.testing.assert_allclose(b.images[i].tvec, a.images[i].tvec, rtol=0, atol=5e-7)


# ---------------------------------------------------------------------------
# Slice 5: joint multi-scene BA
# ---------------------------------------------------------------------------


def _joint_ba_both(root, rig):
    """The joint-BA CLI on CUDA and on the CPU over small two-scan scenes
    (two plain scenes, or one scene of a two-camera rig); returns the two
    output dirs and the card run's B3 launches."""
    from dataset_pipeline_tpu_torch import kernels
    from dataset_pipeline_tpu_torch.tools import joint_ba
    from dataset_pipeline_tpu_torch.utils import synthetic

    args = []
    for si in range(1 if rig else 2):
        d = root / f"scene{si}"
        synthetic.write_scene(str(d), 320, 240, 2800.0 * 320 / 3072, 4 if rig else 2, 6000,
                              seed=9 + 10 * si, device="cpu", n_scans=2,
                              rig=[-0.06, 0.0, 0.0, 0.0, 0.004, 0.0] if rig else None)
        args += ["--scene", f"{d}/scene.mlp,{d}/state,{d}/images"]
    launches = None
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        assert joint_ba.main(args + ["--output_folder_path", str(root / dev), "--max_iterations",
                                     "2", "--device", dev]) == 0
        if dev == "cuda":
            launches = dict(kernels.LAUNCHES)
    return root / "cuda", root / "cpu", launches, len(args) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("rig", [False, True])
def test_joint_ba_on_the_card_matches_cpu(cuda_device, tmp_path, rig):
    """A small joint-BA run on CUDA and on the CPU: the .mlp entries, qvec
    and tvec within 5e-7, intrinsics within 1e-3 px, the cost trace within
    1e-4 relative (the registrator's limits); B3 ran on the card in both
    modes."""
    from dataset_pipeline_tpu_torch.io import colmap as cio
    from dataset_pipeline_tpu_torch.io.meshlab import read_meshlab_project

    a_dir, b_dir, launches, n = _joint_ba_both(tmp_path, rig)
    assert launches["pyramid_sample_derivs"] > 0 and launches["pyramid_sample_value"] > 0
    for si in range(n):
        a, b = a_dir / f"scene_{si}", b_dir / f"scene_{si}"
        for x, y in zip(read_meshlab_project(str(a / "scan_alignment.mlp")),
                        read_meshlab_project(str(b / "scan_alignment.mlp"))):
            np.testing.assert_allclose(x.global_T_mesh, y.global_T_mesh, rtol=0, atol=5e-7)
        ma, mb = cio.read_model(str(a)), cio.read_model(str(b))
        for i in ma.images:
            np.testing.assert_allclose(ma.images[i].qvec, mb.images[i].qvec, rtol=0, atol=5e-7)
            np.testing.assert_allclose(ma.images[i].tvec, mb.images[i].tvec, rtol=0, atol=5e-7)
        for c in ma.cameras:
            np.testing.assert_allclose(ma.cameras[c].params, mb.cameras[c].params, rtol=0,
                                       atol=1e-3)
        ca, cb = (np.asarray(open(x / "metadata.txt").read().splitlines()[2].split()[1:], float)
                  for x in (a, b))
        np.testing.assert_allclose(ca, cb, rtol=1e-4)


SHARDED_ROWS, SHARDED_CLOUDS = 8_000_000, 2  # bench.py's headline size; the engine's chunk


def _sharded_rank(seed: int):
    """A rank of the card tests: its share of the rows through the sharded
    ICP H, b (B4a) and the sharded moment Gram (B2)."""
    from dataset_pipeline_tpu_torch.entry import sharded_icp_problem
    from dataset_pipeline_tpu_torch.parallel import mesh as tmesh
    from dataset_pipeline_tpu_torch.parallel.normal_equations import (
        sharded_icp_hb,
        sharded_moment_gram,
    )

    tmesh.initialize_distributed(device="cuda")
    mesh = tmesh.make_data_mesh(device="cuda")
    q, t, *rows = sharded_icp_problem(SHARDED_ROWS, SHARDED_CLOUDS, seed)
    rows = [tmesh.shard_rows(mesh, x) for x in rows]
    H, b, cost = sharded_icp_hb(mesh, tmesh.replicated(mesh, q), tmesh.replicated(mesh, t), *rows,
                                SHARDED_CLOUDS)
    P = sharded_moment_gram(mesh, *rows[:4], rows[6])
    return mesh.backend, H.cpu().numpy(), b.cpu().numpy(), float(cost), P.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_icp_hb_and_moment_gram_match_one_process(cuda_device, world, backend):
    """World 1 over NCCL and world 2 sharing the card over Gloo: every rank's
    summed H, b, cost and moment Gram against the one-process kernels' at 8M
    correspondences, within the JAX tests' bounds (tests/test_parallel.py:
    H, b rtol 1e-4 / atol 1e-3, the cost 1e-5; the Gram rtol 1e-5 / atol 1e-5
    max|P|); B4a and B2 ran in the ranks."""
    from dataset_pipeline_tpu_torch import kernels
    from dataset_pipeline_tpu_torch.entry import sharded_icp_problem
    from dataset_pipeline_tpu_torch.parallel import mesh as tmesh

    q, t, *rows = (torch.as_tensor(x, device=cuda_device)
                   for x in sharded_icp_problem(SHARDED_ROWS, SHARDED_CLOUDS, 5))
    H1, b1, c1 = (x.cpu().numpy() for x in gn.icp_hb_cost_rows(q, t, *rows, SHARDED_CLOUDS))
    data, _ = tm.pack_group_data([dict(ps=rows[0], ns=rows[1], pt=rows[2], nt=rows[3],
                                       w=rows[6])], 49152, rows=13)
    P1 = gn.moment_gram_partials(data, 49152)[0].sum(0, dtype=torch.float64).cpu().numpy()
    del q, t, rows, data
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    results = tmesh.launch(_sharded_rank, world, (5,), "cuda")
    assert kernels.LAUNCHES["gn_rows"] == world and kernels.LAUNCHES["moment_gram"] == world
    for (got_backend, H, b, cost, P), _ in results:
        assert got_backend == backend
        np.testing.assert_allclose(H, H1, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(b, b1, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(cost, float(c1), rtol=1e-5)
        np.testing.assert_allclose(P, P1, rtol=1e-5, atol=1e-5 * np.abs(P1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("vmin,vmax", [(np.float64(4.87), np.float64(5.31)), (0.0, 20.0),
                                       (0.0, np.float64(37.5))])
def test_inspector_colormap_on_the_card_matches_cpu(cuda_device, vmin, vmax):
    """The inspector's colormap byte for byte on the card and on the CPU (the
    depth, occlusion and cost displays' dtypes), on values that fill every
    float32 rounding case of the division."""
    from dataset_pipeline_tpu_torch.tools.dataset_inspector import _colormap

    rng = np.random.RandomState(2)
    v = (rng.rand(1024, 1024) * (vmax - vmin) * 1.2 + vmin).astype(np.float32)
    v[rng.rand(1024, 1024) < 0.1] = np.inf
    got = _colormap(torch.from_numpy(v).to(cuda_device), vmin, vmax)
    assert np.array_equal(got, _colormap(torch.from_numpy(v), vmin, vmax))


@pytest.mark.cuda
def test_dataset_inspector_on_the_card_matches_cpu(cuda_device, tmp_path):
    """The inspector's CLI on the card and on the CPU, one small scene: image 1
    localized (the poses within 5e-7), then from one common state every mode
    and a transferred mask (the depth, overlay, occlusion and scan PNGs and
    the mask equal, the points and cost PNGs agree in 99.9 % of their pixels
    within 2 levels)."""
    import os
    import shutil

    from PIL import Image

    from dataset_pipeline_tpu_torch.io import colmap as cio
    from dataset_pipeline_tpu_torch.io.ply import read_ply
    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.models.lie import quat_to_matrix_np
    from dataset_pipeline_tpu_torch.photometric.masks import (
        MASK_OBS, draw_mask_polygons, image_mask_path, load_mask, save_mask)
    from dataset_pipeline_tpu_torch.tools import dataset_inspector
    from dataset_pipeline_tpu_torch.utils import synthetic

    W, H, F = 320, 240, 2800.0 * 320 / 3072
    root = str(tmp_path)
    tq, tt = synthetic.write_scene(root, W, H, F, 2, 20_000, seed=3, device="cpu")
    names = [m.name for _, m in sorted(cio.read_model(os.path.join(root, "state")).images.items())]
    save_mask(image_mask_path(os.path.join(root, "images"), names[0]),
              draw_mask_polygons((H, W), [(np.asarray([[40, 30], [200, 40], [230, 180]]),
                                           MASK_OBS)]))
    pts = read_ply(os.path.join(root, "scan.ply")).positions
    # 200 points: the float32 bearing residuals leave the optimum ~1e-7 m apart between two
    # devices' roundings, and more points average that down
    sel = np.random.RandomState(5).choice(len(pts), 200, replace=False)
    cam = cm.make_camera("PINHOLE", W, H, [F, F, (W - 1) / 2, (H - 1) / 2], device="cpu")
    pix, ok = cm.project(cam, torch.as_tensor(pts[sel] @ quat_to_matrix_np(tq[1]).T + tt[1],
                                              dtype=torch.float32))
    ok = (ok & cm.in_image(cam, pix)).numpy()
    np.savetxt(os.path.join(root, "corr.txt"), np.concatenate([pix.numpy()[ok], pts[sel][ok]], 1))
    modes = "depth,overlay,occlusion,scan,cost,cost_variable,cost_combined,points"

    def run(dev, state, images, out, extra):
        assert dataset_inspector.main([
            "--scan_alignment_path", os.path.join(root, "scene.mlp"), "--state_path", state,
            "--image_base_path", images, "--output_folder_path", out, "--device", dev, *extra]) == 0

    located = {}
    for dev in ("cuda", "cpu"):  # localize, each from the perturbed start
        state = shutil.copytree(os.path.join(root, "state"), os.path.join(root, f"loc_{dev}"))
        run(dev, state, os.path.join(root, "images"), os.path.join(root, f"lo_{dev}"),
            ["--modes", "", "--localize_image", names[1],
             "--correspondences", os.path.join(root, "corr.txt")])
        located[dev] = cio.read_model(state)
    outs = {}
    for dev in ("cuda", "cpu"):  # every mode and the transfer, from one common state
        state = shutil.copytree(os.path.join(root, "loc_cuda"), os.path.join(root, f"state_{dev}"))
        images = shutil.copytree(os.path.join(root, "images"), os.path.join(root, f"img_{dev}"))
        run(dev, state, images, os.path.join(root, f"out_{dev}"),
            ["--modes", modes, "--transfer_source", names[0], "--transfer_target", names[1]])
        outs[dev] = (os.path.join(root, f"out_{dev}"), load_mask(image_mask_path(images, names[1])))
    sa, sb = located["cuda"], located["cpu"]
    for i in sa.images:
        assert np.abs(sa.images[i].qvec - sb.images[i].qvec).max() <= 5e-7
        assert np.abs(sa.images[i].tvec - sb.images[i].tvec).max() <= 5e-7
    (oa, ma), (ob, mb) = outs["cuda"], outs["cpu"]
    assert np.array_equal(ma, mb) and (ma == MASK_OBS).sum() > 1000
    for f in sorted(os.listdir(oa)):
        a, b = (np.asarray(Image.open(os.path.join(d, f))).astype(int) for d in (oa, ob))
        if f.split(".")[1] in ("depth", "overlay", "occlusion", "scan"):
            assert np.array_equal(a, b), f
        else:
            assert (np.abs(a - b) <= 2).all(-1).mean() >= 0.999, f


@pytest.mark.cuda
def test_align_pair_on_the_card_matches_cpu(cuda_device, tmp_path):
    """The two-frame harness on a generated 320x240 pair, B3 in both modes on
    the card: the poses within 5e-7 of the CPU run's after 5 iterations."""
    from dataset_pipeline_tpu_torch.photometric import pair_alignment as pa
    from dataset_pipeline_tpu_torch.utils import synthetic

    path = synthetic.write_rgbd_pair(str(tmp_path), 320, 240, 2800.0 * 320 / 3072,
                                     [0.005, -0.005, 0.02, 0.002, -0.002, 0.017], device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        fx = pa.load_pair_fixture(path, device=dev)
        pts, cols = pa.cloud_from_depth(fx.camera, fx.depth_a, fx.depth_factor, fx.image_a)
        init = np.eye(4, dtype=np.float32)
        n0 = gn.LAUNCHES["pyramid_sample_derivs"]
        poses, _ = pa.align_pair(fx.camera, pts, cols, fx.image_a, fx.image_b, init, init,
                                 max_iterations_per_scale=5, device=dev)
        if dev == "cuda":
            assert gn.LAUNCHES["pyramid_sample_derivs"] > n0
        out[dev] = (poses.q.cpu().numpy(), poses.t.cpu().numpy())
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= 5e-7
    assert np.abs(out["cuda"][1] - out["cpu"][1]).max() <= 5e-7


# ---------------------------------------------------------------------------
# tools/bench.py's sections at toy sizes: the card against the CPU
# ---------------------------------------------------------------------------

BENCH_COST_RTOL, BENCH_Q_TOL = 1e-4, 5e-7  # the registrator's limits (test_torch_image_registrator.py)


@pytest.mark.cuda
def test_bench_photometric_hb_on_the_card_matches_cpu(cuda_device):
    """``_hb_batch`` on the photometric_hb inputs (B3 in derivs mode): equal
    counts, H and b within 1e-4 of their largest entry, the cost 1e-4."""
    from dataset_pipeline_tpu_torch.tools import bench

    x = bench.photometric_hb_inputs(**{k: v for k, v in bench.TOY["photometric_hb"].items()
                                       if k != "reps"})
    W, H = bench.TOY["photometric_hb"]["W"], bench.TOY["photometric_hb"]["H"]
    got, want = ([t.double().cpu().numpy() for t in bench.photometric_hb_call(x, W, H, d)()]
                 for d in (cuda_device, torch.device("cpu")))
    assert int(got[3]) == int(want[3]) > 0
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(got[2], want[2], rtol=BENCH_COST_RTOL)


@pytest.mark.cuda
def test_bench_gather_sums_on_the_card_match_cpu(cuda_device):
    """The gather section's two functions: within 1e-5 of the CPU's sums,
    relative to the sum of the magnitudes added."""
    from dataset_pipeline_tpu_torch.tools import bench

    J, idx, xs, table, ridx = bench.gather_inputs(n=20_000, nb=2, reps=1, table_mb=1, n_rows=50_000)
    J, idx, xs, table, ridx = (torch.from_numpy(a) for a in (J, idx, xs[0], table, ridx[0]))
    idx, ridx = idx.long(), ridx.long()
    got = bench.gather_micro(J.to(cuda_device), idx.to(cuda_device), xs.to(cuda_device)).cpu()
    want = bench.gather_micro(J, idx, xs)
    scale = bench.gather_micro(J.abs(), idx, xs.abs())
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    got = float(bench.gather_rows(table.to(cuda_device), ridx.to(cuda_device)))
    want = float(bench.gather_rows(table, ridx))
    assert abs(got - want) <= 1e-5 * float(table[ridx].abs().sum())


@pytest.mark.cuda
def test_bench_cube_faces_on_the_card_match_cpu(cuda_device):
    """The cube faces of a toy cloud: no pixel uncoloured, depths and
    colours equal at >= 99.99 % of pixels (equal depths may pick other
    winners in another order)."""
    from dataset_pipeline_tpu_torch.tools import bench
    from dataset_pipeline_tpu_torch.tools.cube_map_renderer import render_faces

    pos, cols = bench._cube_cloud(20_000)
    out = []
    for d in (cuda_device, torch.device("cpu")):
        stats = {}
        depth, color = render_faces(torch.from_numpy(pos).to(d), torch.from_numpy(cols).to(d), 64,
                                    stats=stats)
        assert stats["flood_fill_unfilled"] == 0
        out.append((depth.cpu().numpy(), color.cpu().numpy()))
    (dc, cc), (dh, ch) = out
    assert np.mean(dc == dh) >= 0.9999
    assert np.mean(np.all(cc == ch, -1)) >= 0.9999


@pytest.mark.cuda
def test_bench_registrator_e2e_on_the_card_matches_cpu(cuda_device):
    """The two-frame scene at 2 iterations: per-iteration costs within 1e-4,
    poses within 5e-7."""
    from dataset_pipeline_tpu_torch.photometric.optimizer import PhotometricOptimizer
    from dataset_pipeline_tpu_torch.tools import bench

    res = []
    for d in (cuda_device, torch.device("cpu")):
        opt = PhotometricOptimizer(bench.registrator_e2e_problem(d)())
        costs = []
        opt.current_scale = 0
        opt.run_on_current_scale(max_iterations=2, iteration_costs=costs)
        g = opt.p.groups[0]
        res.append((costs, g.poses.q.cpu().numpy(), g.poses.t.cpu().numpy()))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=BENCH_COST_RTOL)
    for a, b in zip(res[0][1:], res[1][1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=BENCH_Q_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("section", ["registrator_dslr", "joint_ba", "joint_ba_dense"])
def test_bench_section_on_the_card_matches_cpu(cuda_device, section):
    """A section at its toy size: equal observation and row counts, costs
    within 1e-4."""
    from dataset_pipeline_tpu_torch.tools import bench

    fn = {"registrator_dslr": bench.bench_registrator_dslr, "joint_ba": bench.bench_joint_ba_system,
          "joint_ba_dense": bench.bench_joint_ba_dense}[section]
    keys = {"registrator_dslr": (("registrator_dslr_obs_per_iter", "registrator_dslr_points"),
                                 ("registrator_dslr_cost_first", "registrator_dslr_cost_optimum")),
            "joint_ba": (("joint_ba_rows", "joint_ba_images"), ("joint_ba_cost0", "joint_ba_cost_final")),
            "joint_ba_dense": (("joint_ba_dense_rows",), ("joint_ba_dense_cost",))}[section]
    before = gn.LAUNCHES["pyramid_sample_derivs"]
    got = fn(cuda_device, **bench.TOY[section])
    assert gn.LAUNCHES["pyramid_sample_derivs"] > before
    want = fn(torch.device("cpu"), **bench.TOY[section])
    for k in keys[0]:
        assert got[k] == want[k] > 0, k
    for k in keys[1]:
        np.testing.assert_allclose(got[k], want[k], rtol=BENCH_COST_RTOL, err_msg=k)


@pytest.mark.cuda
def test_spans_time_by_events_read_when_their_stage_ends(cuda_device):
    """``utils/timing.py``: a span on the card records a pair of CUDA events
    and adds nothing until its stage's closing synchronisation; its host
    seconds (the enqueue) are less than the events' time of queued work."""
    from dataset_pipeline_tpu_torch.utils.timing import span, stage

    x = torch.randn(2048, 2048, device=cuda_device)
    t = {}
    with stage(t, "outer", cuda_device):
        with span(t, "outer.a", cuda_device, host=True):
            for _ in range(20):
                y = x @ x
        with span(t, "outer.b", cuda_device):
            y.sum()
        assert "outer.a" not in t and "outer.b" not in t
    assert set(t) == {"outer", "outer.a", "outer.a.host", "outer.b"}
    assert 0 < t["outer.a"] and 0 < t["outer.b"] and t["outer.a"] + t["outer.b"] <= t["outer"]
    assert t["outer.a.host"] < t["outer.a"]


# ---------------------------------------------------------------------------
# The H,b geometry kernel (csrc/hb_geometry.cu) against its plain version
# ---------------------------------------------------------------------------

HB_PARAMS = {"PINHOLE": [150.0, 156.0, 79.5, 59.5], "SIMPLE_PINHOLE": [150.0, 79.5, 59.5],
             "OPENCV": [150.0, 156.0, 79.5, 59.5, 0.01, -0.002, 1e-4, -2e-4],
             "THIN_PRISM_FISHEYE": [150.0, 156.0, 79.5, 59.5, 0.28, 0.09, 2e-4, -3e-4, 2e-3, 1e-3,
                                    4e-4, -2e-4]}


def _hb_scene(device, model, per_image, nb=3, M=6000, seed=0, hidden=True):
    """A camera of 160x120 with a radius cutoff of 1 (``|p.xy / z|^2``), the
    chunk's poses near the identity and points (M,3) or (nb,M,3) 2 to 5 from
    the camera plane, in view; with ``hidden`` a sixth of them behind the
    camera and a sixth spread beyond the cutoff."""
    import dataclasses

    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.models.lie import SE3

    rng = np.random.RandomState(seed + 10 * per_image)
    cam = cm.make_camera(model, 160, 120, HB_PARAMS[model], cutoff=False, device=device)
    cam = dataclasses.replace(cam, radius_cutoff_sq=torch.tensor(1.0, device=device))
    shape = (nb, M) if per_image else (M,)
    z = rng.uniform(2.0, 5.0, shape)
    n = rng.uniform(-0.5, 0.5, shape + (2,)) * np.array([1.0, 0.7])
    if hidden:
        z[..., : M // 6] = -z[..., : M // 6]
        n[..., M // 6: M // 3, :] *= 4.0
    pts = np.concatenate([n * np.abs(z)[..., None], z[..., None]], -1).astype(np.float32)
    pose = SE3.exp(torch.from_numpy((0.02 * rng.randn(nb, 6)).astype(np.float32)))
    derivs = [torch.from_numpy(rng.randn(nb, M).astype(np.float32)).to(device) for _ in range(3)]
    return (cam, pose.q.to(device), pose.t.to(device), torch.from_numpy(pts).to(device), derivs)


def _pix_tolerance(cam, q, t, pts):
    """Float32 rounding of the projection, per row: the camera-frame point
    is good to an ulp or two of the largest coordinate that made it, and the
    pixel is f (p.xy / z): an error e in p moves it by f e (1 + |n|) / |z|."""
    from dataset_pipeline_tpu_torch.models.lie import SE3

    p = SE3(q[:, None].double(), t[:, None].double()).apply(pts.double())
    big = torch.maximum(pts.double().abs().amax(-1), t.double().abs().amax(-1)[:, None])
    f = cam.params[0].double()
    n = (p[..., :2] / p[..., 2:]).abs().amax(-1)
    tol = (8 * 2.0 ** -24 * f * big * (1 + n) / p[..., 2].abs())[..., None]
    if cam.spec.fisheye:  # the lens's slope (< 2 here) and a few ulps of its own arithmetic
        tol = 2 * tol + 16 * 2.0 ** -24 * f * (1 + n)[..., None]
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["PINHOLE", "SIMPLE_PINHOLE", "THIN_PRISM_FISHEYE"])
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("dynamic_scale", [False, True])
@pytest.mark.parametrize("optimize_intrinsics", [False, True])
def test_hb_geometry_kernel_matches_plain(cuda_device, model, per_image, dynamic_scale,
                                          optimize_intrinsics):
    """``project``: valid equal, pix within float32 rounding of the
    projection; ``jacobian``: J within 1e-3 of the jvp's on valid rows,
    relative to the entry plus a thousandth of its column's largest (the
    jvp's footprint tangent is a difference of nearly equal terms, good to
    ~1e-4). THIN_PRISM_FISHEYE's J is held to the plain version in float64,
    as the kernel takes the lens in double. One launch of each mode."""
    from dataset_pipeline_tpu_torch.ops import hb_geometry as hg

    cam, q, t, pts, (dpx, dpy, dvds) = _hb_scene(cuda_device, model, per_image)
    assert hg.uses_kernel(cam, pts)
    n0 = dict(gn.LAUNCHES)
    pix, valid = hg.project(cam, cam.params, q, t, pts)
    J = hg.jacobian(cam, cam.params, q, t, pts, 0.004, dpx, dpy, dvds, optimize_intrinsics,
                    dynamic_scale)
    assert gn.LAUNCHES["hb_geometry_project"] == n0["hb_geometry_project"] + 1
    assert gn.LAUNCHES["hb_geometry_jacobian"] == n0["hb_geometry_jacobian"] + 1
    pix_p, valid_p = hg.project_plain(cam, cam.params, q, t, pts)
    if cam.spec.fisheye:
        import dataclasses

        c64 = dataclasses.replace(cam, params=cam.params.double())
        J_p = hg.jacobian_plain(c64, c64.params, q.double(), t.double(), pts.double(), 0.004,
                                dpx.double(), dpy.double(), dvds.double(), optimize_intrinsics,
                                dynamic_scale)
    else:
        J_p = hg.jacobian_plain(cam, cam.params, q, t, pts, 0.004, dpx, dpy, dvds,
                                optimize_intrinsics, dynamic_scale)
    assert gn.LAUNCHES == {**n0, "hb_geometry_project": n0["hb_geometry_project"] + 1,
                           "hb_geometry_jacobian": n0["hb_geometry_jacobian"] + 1}
    assert torch.equal(valid, valid_p)
    M = pts.shape[-2]
    assert 0.4 * M < int(valid_p.sum()) / q.shape[0] < 0.8 * M  # behind and beyond cut off
    tol = _pix_tolerance(cam, q, t, pts)
    assert bool(((pix.double() - pix_p.double()).abs() <= tol).all())
    assert J.shape == J_p.shape == (q.shape[0], M, (cam.params.shape[0] if optimize_intrinsics
                                                     else 0) + 6)
    Jv, Jpv = J[valid_p].double(), J_p[valid_p].double()
    assert bool(torch.isfinite(Jv).all())
    scale = Jpv.abs() + 1e-3 * Jpv.abs().amax(0)
    assert bool(((Jv - Jpv).abs() <= 1e-3 * scale).all()), float(((Jv - Jpv).abs() / scale).max())


@pytest.mark.cuda
def test_hb_geometry_kernel_reads_the_cutoff_on_the_card(cuda_device):
    """The radius cutoff as a tensor on the card is read there, and gives
    what the same number gives as a host scalar."""
    import dataclasses

    from dataset_pipeline_tpu_torch.ops import hb_geometry as hg

    cam, q, t, pts, _ = _hb_scene(cuda_device, "PINHOLE", False)
    host = dataclasses.replace(cam, radius_cutoff_sq=torch.tensor(1.0))
    for a, b in zip(hg.project(cam, cam.params, q, t, pts),
                    hg.project(host, cam.params, q, t, pts)):
        assert torch.equal(a, b)


def _hb_batch_inputs(device, model, per_image, seed=5):
    """``_hb_batch``'s arguments for a chunk of 3 images of 160x120 (4
    levels), K = 4 neighbours, the points of :func:`_hb_scene` in view."""
    from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps

    cam, q, t, pts, _ = _hb_scene(device, model, per_image, nb=3, M=4000, seed=seed, hidden=False)
    rng = np.random.RandomState(seed)
    nb, M = q.shape[0], pts.shape[-2]
    pyr = [torch.from_numpy((rng.rand(nb, 120, 160) * 255).astype(np.float32)).to(device)]
    for _ in range(3):
        h, w = pyr[-1].shape[1:]
        pyr.append(pyr[-1].reshape(nb, h // 2, 2, w // 2, 2).mean((2, 4)))
    flat, layout = tps.flatten_pyramid(pyr)
    shape = (nb, M) if per_image else (M,)
    nbr = torch.from_numpy(rng.randint(0, M, shape + (4,))).to(device)
    desc = torch.from_numpy(rng.randn(*shape, 4).astype(np.float32)).to(device)
    scale = torch.from_numpy(rng.uniform(0.1, 1.9, (nb, M)).astype(np.float32)).to(device)
    contrib = torch.from_numpy(rng.rand(nb, M) < 0.9).to(device)
    return (cam, cam.params, q, t, pts, nbr, desc, flat, layout, scale, contrib, 0.004)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["PINHOLE", "SIMPLE_PINHOLE", "OPENCV", "THIN_PRISM_FISHEYE"])
@pytest.mark.parametrize("per_image", [False, True])
def test_hb_batch_on_the_card_matches_cpu(cuda_device, model, per_image):
    """``_hb_batch`` (intrinsics and the footprint row optimised): equal
    counts, H and b within 1e-4 of their largest entry, the cost 1e-4 (the
    limits of the bench's photometric_hb test). The kernel models count one
    launch of each mode and ``geometry_kernel_rows`` nb x M; OPENCV takes the
    jvp on the card: no launch, no count. Every model's residuals and Gram
    products take the Gram kernel on the card: one ``hb_gram`` launch and
    ``gram_kernel_rows`` nb x M."""
    from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
    from dataset_pipeline_tpu_torch.utils.timing import stage

    out, counts = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        args = _hb_batch_inputs(dev, model, per_image)
        n0 = dict(gn.LAUNCHES)
        t = {}
        with stage(t, "hb_accumulate", dev):
            res = tpo._hb_batch(*args, True, True, timings=t)
            out[dev.type] = [x.double().cpu().numpy() for x in res]
        counts[dev.type] = (t.get("hb_accumulate.geometry_kernel_rows"),
                            t.get("hb_accumulate.gram_kernel_rows"),
                            {k: gn.LAUNCHES[k] - n0[k] for k in n0 if gn.LAUNCHES[k] != n0[k]})
    nb, M = args[2].shape[0], args[4].shape[-2]
    if model == "OPENCV":
        assert counts["cuda"] == (None, nb * M, {"pyramid_pairs": 1, "pyramid_sample_derivs": 1,
                                                 "hb_gram": 1})
    else:
        assert counts["cuda"] == (nb * M, nb * M, {"pyramid_pairs": 1, "pyramid_sample_derivs": 1,
                                                   "hb_geometry_project": 1,
                                                   "hb_geometry_jacobian": 1, "hb_gram": 1})
    assert counts["cpu"] == (None, None, {})
    got, want = out["cuda"], out["cpu"]
    assert int(got[3]) == int(want[3]) > nb * M // 2
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(got[2], want[2], rtol=BENCH_COST_RTOL)


def _gram_chunk(device, nb, M, V, K=5, per_image=False, seed=3):
    """Inputs of ``hb_gram.gram_assemble`` at a registrator chunk's shape: J
    (nb, M, V) at random with NaN in the 5 % of rows that are invalid,
    intensities about 100, descriptors that make about half the residual
    norms Huber inliers, neighbours among the 64 rows around each point (as a
    level's, drawn from a point's surroundings), 2 % of the rows not
    contributing."""
    g = torch.Generator(device=device).manual_seed(seed)
    J = torch.randn((nb, M, V), generator=g, device=device)
    ok = torch.rand((nb, M), generator=g, device=device) > 0.05
    J[~ok] = float("nan")
    inten = 100.0 + 20.0 * torch.randn((nb, M), generator=g, device=device)
    shape = (nb, M, K) if per_image else (M, K)
    near = torch.randint(-32, 33, shape, generator=g, device=device)
    rows = torch.arange(M, device=device).view((1,) * (len(shape) - 2) + (M, 1))
    nbr = (rows + near).clamp(0, M - 1)
    desc = 5.0 * torch.randn(shape, generator=g, device=device)
    contrib = torch.rand((nb, M), generator=g, device=device) > 0.02
    return J, inten, ok, nbr, desc, contrib


@pytest.mark.cuda
@pytest.mark.parametrize("nb,M,V,per_image", [(8, 1_579_653, 10, False), (8, 6_317_932, 18, False),
                                              (3, 40_000, 6, True), (3, 40_000, 16, True),
                                              (4, 400_000, 24, False), (3, 40_000, 20, True)])
def test_hb_gram_kernel_matches_plain(cuda_device, nb, M, V, per_image):
    """The Gram kernel against ``gram_assemble_plain`` with J in float64, image by
    image (``hb_gram.oracle``), at the DSLR chunk's shape (8 images x level
    0's 1,579,653 points, PINHOLE with intrinsics: V = 10), at the fisheye
    chunk's (6,317,932 points, THIN_PRISM_FISHEYE with intrinsics: V = 18),
    at a rig's widest rows (12 intrinsics and 6 + 6 pose dofs: V = 24), and
    with per-image neighbours at V = 6, 16 and 20: the count equal, H within
    1e-4 of sqrt(H_ii H_jj) (the registrator's ``close_gram`` limit), b
    within 1e-4 of its largest entry on that scale, the cost within 1e-5
    (``hb_gram.gaps``); invalid rows hold NaN in J and H stays finite. One
    launch, counted."""
    from dataset_pipeline_tpu_torch.ops import hb_gram

    J, inten, ok, nbr, desc, contrib = _gram_chunk(cuda_device, nb, M, V, per_image=per_image)
    assert hb_gram.uses_kernel(J)
    n0 = dict(gn.LAUNCHES)
    out = hb_gram.gram_assemble(J, inten, ok, nbr, desc, contrib)
    assert gn.LAUNCHES == {**n0, "hb_gram": n0["hb_gram"] + 1}
    assert out[0].shape == (nb, V, V) and out[1].shape == (nb, V)
    assert out[2].dtype == torch.float32 and out[3].dtype == torch.int64
    ref = hb_gram.oracle(J, inten, ok, nbr, desc, contrib)
    assert int(out[3]) == ref[3] > 0.5 * nb * M
    assert bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all())
    assert torch.equal(out[0], out[0].mT)
    H_gap, b_gap, cost_gap = hb_gram.gaps(out, ref)
    assert H_gap < 1e-4 and b_gap < 1e-4 and cost_gap < 1e-5, (H_gap, b_gap, cost_gap)


@pytest.mark.cuda
@pytest.mark.parametrize("model,V", [("OPENCV", 20), ("THIN_PRISM_FISHEYE", 24)])
def test_hb_rig_batch_on_the_card_takes_the_gram_kernel(cuda_device, model, V):
    """``_hb_rig_batch`` with intrinsics (P + 12 variables: 20 under
    OPENCV, 24 under THIN_PRISM_FISHEYE) on the card: one ``hb_gram``
    launch, ``gram_kernel_rows`` nb x M, and H, b, cost and count as on the
    CPU within the limits of ``test_hb_batch_on_the_card_matches_cpu``."""
    from dataset_pipeline_tpu_torch.models.lie import SE3
    from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
    from dataset_pipeline_tpu_torch.utils.timing import stage

    out, counts = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        cam, params, q, t, *rest = _hb_batch_inputs(dev, model, False)
        extr = SE3.exp(torch.tensor([0.01, -0.02, 0.005, 0.002, 0.001, -0.003], device=dev))
        n0 = dict(gn.LAUNCHES)
        t_ = {}
        with stage(t_, "hb_accumulate", dev):
            res = tpo._hb_rig_batch(cam, params, extr.q, extr.t, q, t, *rest, True, True, timings=t_)
        out[dev.type] = [x.double().cpu().numpy() for x in res]
        counts[dev.type] = (t_.get("hb_accumulate.gram_kernel_rows"),
                            gn.LAUNCHES["hb_gram"] - n0["hb_gram"])
    nb, M = q.shape[0], rest[0].shape[-2]
    assert counts == {"cuda": (nb * M, 1), "cpu": (None, 0)}
    got, want = out["cuda"], out["cpu"]
    assert got[0].shape == (nb, V, V) and int(got[3]) == int(want[3]) > nb * M // 2
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(got[2], want[2], rtol=BENCH_COST_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [10, 18])
def test_hb_gram_kernel_is_deterministic(cuda_device, V):
    """Two launches on the same inputs give bit-equal H, b, cost and count:
    no float atomics, the records summed in a fixed order."""
    from dataset_pipeline_tpu_torch.ops import hb_gram

    args = _gram_chunk(cuda_device, 8, 400_000, V, seed=V)
    first = [x.clone() for x in hb_gram.gram_assemble(*args)]
    for a, b in zip(first, hb_gram.gram_assemble(*args)):
        assert torch.equal(a, b)
