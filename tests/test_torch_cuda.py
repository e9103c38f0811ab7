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
@pytest.mark.parametrize("chunk", [256, 768, 49152])
def test_moment_gram_kernel_matches_plain(cuda_device, chunk):
    rng = np.random.RandomState(60)
    groups, _ = _groups(rng, 2, [5000, 30000])
    data, gid = tm.pack_group_data(groups, chunk=chunk, rows=13, device=cuda_device)
    n0 = gn.LAUNCHES["moment_gram"]
    parts, per_chunk = gn.moment_gram_partials(data, chunk)
    assert gn.LAUNCHES["moment_gram"] == n0 + 1
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
@pytest.mark.parametrize("L,with_derivs", [(1, True), (5, True), (5, False), (3, True)])
def test_pyramid_sample_kernel_matches_plain(cuda_device, L, with_derivs):
    tps, flat, layout, pix, scale = _b3_inputs(cuda_device, 3, 257, 383, L, 20000, 70 + L)
    key = "pyramid_sample_derivs" if with_derivs else "pyramid_sample_value"
    n0 = gn.LAUNCHES[key]
    got = tps.pyramid_sample(flat, layout, pix, scale, with_derivs)
    assert gn.LAUNCHES[key] == n0 + 1
    again = tps.pyramid_sample(flat, layout, pix, scale, with_derivs)
    ref = tps.sample_plain(flat, layout, pix, scale, with_derivs)
    ok = ref[-1]
    assert torch.equal(got[-1], ok)  # ok bit-equal, integer coordinates included
    for g, a, r in zip(got[:-1], again[:-1], ref[:-1]):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g[ok].cpu().numpy(), r[ok].cpu().numpy(), rtol=0, atol=1e-3)


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


@pytest.mark.cuda
@pytest.mark.parametrize("C,M", [(1, 900), (2, 100_000), (3, 4096), (5, 70_001), (14, 9000)])
def test_gn_rows_kernel_matches_plain(cuda_device, C, M):
    rng = np.random.RandomState(80 + C)
    j1, j2 = (torch.from_numpy(rng.randn(6, M).astype(np.float32)).to(cuda_device) for _ in range(2))
    r1, r2 = (torch.from_numpy((0.1 * rng.randn(M)).astype(np.float32)).to(cuda_device)
              for _ in range(2))
    sid = rng.randint(0, C, M).astype(np.int32)
    tid = torch.from_numpy(((sid + rng.randint(0, C, M)) % C).astype(np.int32)).to(cuda_device)
    sid = torch.from_numpy(sid).to(cuda_device)
    w = torch.from_numpy(np.where(rng.rand(M) < 0.5, rng.rand(M) > 0.2, rng.rand(M))
                         .astype(np.float32)).to(cuda_device)
    n0 = gn.LAUNCHES["gn_rows"]
    got = [x.cpu().numpy() for x in gn.gn_rows(j1, j2, r1, r2, sid, tid, w, C)]
    assert gn.LAUNCHES["gn_rows"] == n0 + 1
    again = [x.cpu().numpy() for x in gn.gn_rows(j1, j2, r1, r2, sid, tid, w, C)]
    ref = [x.cpu().numpy() for x in gn.gn_rows_plain(j1.double(), j2.double(), r1.double(),
                                                     r2.double(), sid, tid, w.double(), C)]
    for g, a, r in zip(got, again, ref):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * max(np.abs(r).max(), 1e-30))
    with pytest.raises(ValueError, match="num_clouds"):
        gn.gn_rows(j1, j2, r1, r2, sid, tid, w, 15)


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
    assert torch.equal(got, hbm.hbm_read_sum(data2, repeats))
    ref = hbm.hbm_read_sum_plain(data2.double(), repeats).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0,
                               atol=1e-5 * float(data2.abs().sum(2).max()))
    with pytest.raises(ValueError, match="multiple of 4"):
        hbm.hbm_read_sum(data2[:, :, : mp - 1].contiguous(), 1)
