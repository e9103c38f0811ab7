"""The port's CUDA kernel sources, compiled with g++ against a host emulation
of the CUDA runtime (``tests/cuda_emu/cuda_runtime.h``) and run on the CPU.

This checks the kernels' own indexing, reductions and assembly against
their plain PyTorch versions without a GPU; timing, the real compiler and
the memory model are only checked on the card (``chip_smoke.py`` and the
tests marked ``cuda``). Skips when no C++20 ``g++`` is available.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu_torch import kernels
from dataset_pipeline_tpu_torch.icp import moments as tm
from dataset_pipeline_tpu_torch.ops import gn
from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps

torch.set_num_threads(2)
CSRC = Path(gn.__file__).resolve().parent.parent / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"
_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<([^,]+),\s*([^,]+),\s*0,\s*([^>]+)>>>\(")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    srcs = []
    for cuh in CSRC.glob("*.cuh"):  # found by the sources' quoted includes
        (out / cuh.name).write_text(cuh.read_text())
    for cu in sorted(CSRC.glob("*.cu")):
        cpp = out / (cu.stem + ".cpp")
        cpp.write_text(_LAUNCH.sub(r"emu_launch(\1, \2, \3, ", cu.read_text()))
        srcs.append(str(cpp))
    lib = out / "libemu.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{EMU}",
                           "-o", str(lib), *srcs, "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("g++ lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    so = ctypes.CDLL(str(lib))
    for k in kernels.KERNELS.values():  # the argument types the port itself binds
        fn = getattr(so, k.entry)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    return so


def _packed(C, sizes, chunk, seed):
    rng = np.random.RandomState(seed)
    groups, pairs = [], []
    for s in range(C):
        for tg in range(C):
            if s != tg:
                m = sizes[len(pairs) % len(sizes)]
                ns = rng.randn(m, 3)
                nt = rng.randn(m, 3)
                ps = rng.randn(m, 3)
                groups.append({"ps": ps.astype(np.float32),
                               "ns": (ns / np.linalg.norm(ns, axis=1, keepdims=True)).astype(np.float32),
                               "pt": (ps + 0.05 * rng.randn(m, 3)).astype(np.float32),
                               "nt": (nt / np.linalg.norm(nt, axis=1, keepdims=True)).astype(np.float32),
                               "w": rng.rand(m).astype(np.float32)})
                pairs.append((s, tg))
    data, gid = tm.pack_group_data(groups, chunk, rows=13, device="cpu")
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid])
    qt = [tm.se3_exp_np(0.3 * rng.randn(6)) for _ in range(C)]
    q = torch.tensor(np.stack([a for a, _ in qt]), dtype=torch.float32)
    t = torch.tensor(np.stack([b for _, b in qt]), dtype=torch.float32)
    return data, cp, q, t


def _gn_emulated(emu, data, cp, q, t, C, chunk, block_rows):
    Mp = data.shape[1]
    nblocks = Mp // block_rows
    qt = torch.cat([q, t], 1).contiguous()
    partials = torch.zeros((nblocks, 28))
    G = torch.zeros((6 * C + 1, 6 * C + 1), dtype=torch.float64)
    err = emu.dpt_gn_fused(data.data_ptr(), data.shape[0], Mp, cp.data_ptr(), qt.data_ptr(), C,
                           chunk, block_rows, partials.data_ptr(), nblocks, G.data_ptr(), None)
    assert err == 0
    return G.numpy()


@pytest.mark.parametrize("C,block_rows", [(2, 256), (3, 512)])
def test_gn_fused_kernel_emulated(emu, C, block_rows):
    chunk = 512
    data, cp, q, t = _packed(C, [700, 300], chunk, seed=C)
    G = _gn_emulated(emu, data, cp, q, t, C, chunk, block_rows)
    n = 6 * C
    H, b, c = (x.numpy() for x in gn.gn_fused_plain(q.double(), t.double(), data.double(), cp, C, chunk))
    np.testing.assert_allclose(G[:n, :n], H, rtol=0, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(G[:n, n], b, rtol=0, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(G[n, :n], b, rtol=0, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(G[n, n], c, rtol=1e-6)


def test_gn_fused_kernel_emulated_poisons_invalid_pairs(emu):
    data, cp, q, t = _packed(2, [300], 256, seed=9)
    cp[1, 0] = 7  # no such cloud
    assert np.isnan(_gn_emulated(emu, data, cp, q, t, 2, 256, 256)).all()


@pytest.mark.parametrize("rows_per_block", [256, 512])
def test_moment_gram_kernel_emulated(emu, rows_per_block):
    chunk = 1024
    data, *_ = _packed(2, [1500, 600], chunk, seed=4)
    Mp = data.shape[1]
    nblocks = Mp // rows_per_block
    parts = torch.zeros((nblocks, 42, 42))
    assert emu.dpt_moment_gram(data.data_ptr(), 13, Mp, rows_per_block, parts.data_ptr(),
                               nblocks, None) == 0
    per_chunk = parts.double().reshape(Mp // chunk, chunk // rows_per_block, 42, 42).sum(1).numpy()
    ref = gn.moment_gram_plain(data.double(), chunk).numpy()
    np.testing.assert_array_equal(parts.numpy(), parts.transpose(1, 2).numpy())
    for k in range(len(ref)):
        np.testing.assert_allclose(per_chunk[k], ref[k], rtol=0, atol=1e-6 * np.abs(ref[k]).max())


def test_entry_points_reject_bad_arguments(emu):
    data = torch.zeros((13, 512))
    parts = torch.zeros((2, 42, 42))
    assert emu.dpt_moment_gram(data.data_ptr(), 12, 512, 256, parts.data_ptr(), 2, None) != 0
    assert emu.dpt_moment_gram(data.data_ptr(), 13, 512, 100, parts.data_ptr(), 2, None) != 0
    assert emu.dpt_gn_fused(data.data_ptr(), 13, 512, None, None, 2, 512, 384,
                            None, 1, None, None) != 0  # chunk not a multiple of block_rows


def _pyramid_emulated(emu, flat, layout, pix, scale, with_derivs):
    nb, n = scale.shape
    L = layout.levels
    outs = [torch.full((nb, n), float("nan")) for _ in range(4)]
    ok = torch.zeros((nb, n), dtype=torch.bool)
    ptrs = [o.data_ptr() for o in outs[1:]] if with_derivs else [None] * 3
    err = emu.dpt_pyramid_sample(
        flat.data_ptr(), layout.total, nb, (ctypes.c_int * L)(*layout.hs),
        (ctypes.c_int * L)(*layout.ws), (ctypes.c_longlong * L)(*layout.offs), L,
        pix.data_ptr(), scale.data_ptr(), n, int(with_derivs), outs[0].data_ptr(), *ptrs,
        ok.data_ptr(), None)
    assert err == 0
    return (outs[0], *outs[1:], ok) if with_derivs else (outs[0], ok)


@pytest.mark.parametrize("L,with_derivs", [(1, True), (4, True), (4, False), (3, True)])
def test_pyramid_sample_kernel_emulated(emu, L, with_derivs):
    """Both modes against the plain version: ``ok`` bit-equal, including
    observations exactly on integer pixel coordinates and integer scales."""
    rng = np.random.RandomState(20 + L)
    nb, H, W, n = 2, 37, 53, 1500
    pyr = [torch.from_numpy((rng.rand(nb, H, W) * 255).astype(np.float32))]
    for _ in range(1, L):
        h, w = pyr[-1].shape[1:]
        pyr.append(pyr[-1][:, : h // 2 * 2, : w // 2 * 2].reshape(nb, h // 2, 2, w // 2, 2)
                   .mean((2, 4)))
    flat, layout = tps.flatten_pyramid(pyr)
    pix = np.stack([rng.rand(nb, n) * (W + 6) - 3, rng.rand(nb, n) * (H + 6) - 3], -1)
    pix[:, :300] = np.round(pix[:, :300])  # on integer boundaries at level 0
    pix[:, 300:400] = np.round(pix[:, 300:400] * 2) / 2 - 0.5  # ... and at level 1
    scale = rng.rand(nb, n) * (L + 0.6) - 0.3
    scale[:, :200] = np.round(scale[:, :200])  # integer scales
    scale[0, 0], scale[1, 1] = np.nan, np.inf
    pix_t = torch.from_numpy(pix.astype(np.float32)).contiguous()
    scale_t = torch.from_numpy(scale.astype(np.float32)).contiguous()
    got = _pyramid_emulated(emu, flat, layout, pix_t, scale_t, with_derivs)
    ref = tps.sample_plain(flat, layout, pix_t, scale_t, with_derivs)
    ok = ref[-1]
    np.testing.assert_array_equal(got[-1].numpy(), ok.numpy())
    assert ok.float().mean() > 0.3
    for a, b in zip(got[:-1], ref[:-1]):
        np.testing.assert_allclose(a[ok].numpy(), b[ok].numpy(), rtol=1e-6, atol=1e-4)


def test_pyramid_sample_entry_point_rejects_bad_arguments(emu):
    flat = torch.zeros((1, 80))
    hs, ws = (ctypes.c_int * 2)(8, 4), (ctypes.c_int * 2)(8, 4)
    offs = (ctypes.c_longlong * 2)(0, 64)
    v = torch.zeros(4)
    ok = torch.zeros(4, dtype=torch.bool)
    pix, sc = torch.zeros(8), torch.zeros(4)
    args = (pix.data_ptr(), sc.data_ptr(), 4, 0, v.data_ptr(), None, None, None, ok.data_ptr(),
            None)
    assert emu.dpt_pyramid_sample(flat.data_ptr(), 80, 1, hs, ws, offs, 2, *args) == 0
    assert emu.dpt_pyramid_sample(flat.data_ptr(), 70, 1, hs, ws, offs, 2, *args) != 0
    assert emu.dpt_pyramid_sample(flat.data_ptr(), 80, 1, hs, ws, offs, 0, *args) != 0
    derivs = args[:3] + (1,) + args[4:]  # derivatives requested without buffers
    assert emu.dpt_pyramid_sample(flat.data_ptr(), 80, 1, hs, ws, offs, 2, *derivs) != 0


# ---------------------------------------------------------------------------
# B4a, B4b, B4c, B5a, B5b
# ---------------------------------------------------------------------------


def _rows_inputs(C, M, seed):
    """Precomputed rows with per-row cloud ids: ids that change from row to
    row, some rows with equal ids, weights of 0, 1 and in between."""
    rng = np.random.RandomState(seed)
    j1, j2 = (torch.from_numpy(rng.randn(6, M).astype(np.float32)) for _ in range(2))
    r1, r2 = (torch.from_numpy((0.1 * rng.randn(M)).astype(np.float32)) for _ in range(2))
    sid = rng.randint(0, C, M).astype(np.int32)
    tid = ((sid + rng.randint(0, C, M)) % C).astype(np.int32)  # equal to sid 1 time in C
    w = np.where(rng.rand(M) < 0.5, (rng.rand(M) > 0.2).astype(np.float32),
                 rng.rand(M).astype(np.float32)).astype(np.float32)
    return j1, j2, r1, r2, torch.from_numpy(sid), torch.from_numpy(tid), torch.from_numpy(w)


@pytest.mark.parametrize("C,M,cols_per_block,tile_cols", [(1, 333, 192, 64), (2, 1500, 512, 256),
                                                          (3, 700, 256, 96)])
def test_gn_rows_kernel_emulated(emu, C, M, cols_per_block, tile_cols):
    args = _rows_inputs(C, M, seed=C)
    S = 6 * C + 1
    nt = (S + 3) // 4
    nblocks = -(-M // cols_per_block)
    partials = torch.zeros((nblocks, nt * (nt + 1) // 2 * 16))
    G = torch.zeros((S, S), dtype=torch.float64)
    assert emu.dpt_gn_rows(*[a.data_ptr() for a in args], M, C, cols_per_block, tile_cols,
                           partials.data_ptr(), nblocks, G.data_ptr(), None) == 0
    G = G.numpy()
    np.testing.assert_array_equal(G, G.T)
    H, b, c = (x.numpy() for x in gn.gn_rows_plain(*[a.double() if a.is_floating_point() else a
                                                     for a in args], C))
    n = 6 * C
    np.testing.assert_allclose(G[:n, :n], H, rtol=0, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(G[:n, n], b, rtol=0, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(G[n, n], c, rtol=1e-6)


@pytest.mark.parametrize("chunk", [512, 384])
def test_moment_gram48_kernel_emulated(emu, chunk):
    """One zero-padded (48,48) part per chunk; 384 is no multiple of the
    256-row staging tile, so the last tile of a chunk is partly masked."""
    data, *_ = _packed(2, [900, 500], chunk, seed=5)
    n = data.shape[1] // chunk
    parts = torch.full((n, 48, 48), float("nan"))
    assert emu.dpt_moment_gram48(data.data_ptr(), 13, data.shape[1], chunk, parts.data_ptr(),
                                 n, None) == 0
    ref = gn.moment_gram48_plain(data.double(), chunk).numpy()
    got = parts.numpy()
    assert (got[:, 42:, :] == 0).all() and (got[:, :, 42:] == 0).all()
    for k in range(n):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6 * np.abs(ref[k]).max())


@pytest.mark.parametrize("chunk", [768, 384])
def test_moment_gram_thirds_kernel_emulated(emu, chunk):
    data, *_ = _packed(2, [1000, 700], chunk, seed=6)
    n = data.shape[1] // chunk
    parts = torch.full((n, 3, 42, 42), float("nan"))
    assert emu.dpt_moment_gram_thirds(data.data_ptr(), 13, data.shape[1], chunk,
                                      parts.data_ptr(), n, None) == 0
    ref = gn.moment_gram_thirds_plain(data.double(), chunk).numpy()
    np.testing.assert_allclose(parts.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    whole = gn.moment_gram_plain(data.double(), chunk).numpy()
    np.testing.assert_allclose(gn.moment_tri_extract(parts.double()).numpy(), whole, rtol=0,
                               atol=1e-6 * np.abs(whole).max())


@pytest.mark.parametrize("repeats", [1, 2, 5])
def test_moment_gram_repeat_kernel_emulated(emu, repeats):
    """Two DIFFERENT copies: repeat r adds the Gram of copy r % 2."""
    chunk = 512
    a, *_ = _packed(2, [600, 300], chunk, seed=7)
    b, *_ = _packed(2, [600, 300], chunk, seed=8)
    data2 = torch.stack([a, b]).contiguous()
    Mp = a.shape[1]
    parts = torch.full((Mp // 256, 42, 42), float("nan"))
    assert emu.dpt_moment_gram_repeat(data2.data_ptr(), 13, Mp, 256, parts.data_ptr(), Mp // 256,
                                      repeats, None) == 0
    ref = gn.moment_gram_repeat_plain(data2.double(), 256, repeats).numpy()
    np.testing.assert_allclose(parts.numpy(), ref, rtol=0, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("repeats", [1, 3])
def test_hbm_read_sum_kernel_emulated(emu, repeats):
    from dataset_pipeline_tpu_torch.ops import hbm

    mp, cols_per_block = 5000, 1024  # the last block is partly filled
    data2 = torch.from_numpy(np.random.RandomState(9).randn(2, 8, mp).astype(np.float32))
    nblocks = -(-mp // cols_per_block)
    partials = torch.full((nblocks, 8), float("nan"))
    out = torch.full((8,), float("nan"))
    assert emu.dpt_hbm_read_sum(data2.data_ptr(), mp, cols_per_block, repeats,
                                partials.data_ptr(), nblocks, out.data_ptr(), None) == 0
    ref = hbm.hbm_read_sum_plain(data2.double(), repeats).numpy()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * float(data2.abs().sum(2).max()))


def test_new_entry_points_reject_bad_arguments(emu):
    data = torch.zeros((2, 13, 768))
    parts = torch.zeros((6, 48, 48))
    p, d = parts.data_ptr(), data.data_ptr()
    assert emu.dpt_moment_gram48(d, 13, 768, 500, p, 1, None) != 0  # chunks do not cover Mp
    assert emu.dpt_moment_gram_thirds(d, 13, 768, 256, p, 3, None) != 0  # chunk % 3
    assert emu.dpt_moment_gram_thirds(d, 12, 768, 384, p, 2, None) != 0  # too few rows
    assert emu.dpt_moment_gram_repeat(d, 13, 768, 256, p, 3, 0, None) != 0  # no repeat
    assert emu.dpt_moment_gram_repeat(d, 13, 768, 256, p, 2, 1, None) != 0  # blocks do not cover
    assert emu.dpt_hbm_read_sum(d, 770, 256, 1, p, 4, p, None) != 0  # mp % 4
    assert emu.dpt_hbm_read_sum(d, 768, 256, 1, p, 2, p, None) != 0  # blocks do not cover
    z = [d] * 7
    assert emu.dpt_gn_rows(*z, 100, 15, 256, 32, p, 1, p, None) != 0  # more tiles than threads
    assert emu.dpt_gn_rows(*z, 100, 5, 256, 256, p, 1, p, None) != 0  # staging exceeds shared memory
    assert emu.dpt_gn_rows(*z, 1000, 2, 256, 256, p, 1, p, None) != 0  # blocks do not cover M
