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
_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(")
_DYNAMIC_SMEM = re.compile(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];")


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
        src = _DYNAMIC_SMEM.sub(r"\1* \2 = emu_dynamic_smem<\1>();", cu.read_text())
        cpp.write_text(_LAUNCH.sub(r"emu_launch(\1, \2, \3, \4, ", src))
        srcs.append(str(cpp))
    srcs += [str(EMU / "emu_counters.cpp"), str(EMU / "emu_selftest.cpp")]
    lib = out / "libemu.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{EMU}",
                           "-o", str(lib), *srcs, "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("g++ lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    lib = kernels.bind(ctypes.CDLL(str(lib)))  # the argument types the port itself binds
    for name in ("emu_misaligned_loads", "emu_vector_load_count"):
        getattr(lib, name).restype = ctypes.c_longlong
    return lib


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


def _gn_scratch(nblocks, G, record_floats):
    """Records, tags and the ticket as the wrapper hands them over; garbage in
    the records and tags, since the kernels must write every slot they read."""
    slots = nblocks + G
    return (torch.full((slots * record_floats,), float("nan")),
            torch.full((2 * slots,), 12345, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))


def _gn_emulated(emu, data, cp, q, t, C, chunk, nblocks):
    Mp = data.shape[1]
    records, tags, _ = _gn_scratch(nblocks, Mp // chunk, 28)
    G = torch.full((6 * C + 1, 6 * C + 1), float("nan"), dtype=torch.float64)
    err = emu.dpt_gn_fused(data.data_ptr(), data.shape[0], Mp, cp.data_ptr(), q.data_ptr(),
                           t.data_ptr(), C, chunk, nblocks, records.data_ptr(), tags.data_ptr(),
                           G.data_ptr(), None)
    assert err == 0
    return G.numpy()


def _cost_batch_emulated(emu, data, cp, qs, ts, C, chunk, nblocks):
    Mp = data.shape[1]
    records, tags, ticket = _gn_scratch(nblocks, Mp // chunk, gn.GN_MAX_CANDIDATES)
    out = torch.full((qs.shape[0],), float("nan"), dtype=torch.float64)
    err = emu.dpt_gn_cost_batch(data.data_ptr(), data.shape[0], Mp, cp.data_ptr(), qs.data_ptr(),
                                ts.data_ptr(), qs.shape[0], C, chunk, nblocks, records.data_ptr(),
                                tags.data_ptr(), ticket.data_ptr(), out.data_ptr(), None)
    assert err == 0
    assert int(ticket) == 0  # the last block leaves the ticket ready for the next call
    return out.numpy()


# grids of 1, 2 and 3 blocks over several chunks with two (C = 2) and six
# (C = 3) cloud pairs: runs that end inside a chunk and on a chunk border,
# a block with several segments, and (7 blocks over 4 units) blocks without work
_GN_CASES = [(2, 512, 1), (2, 512, 2), (3, 512, 3), (3, 256, 2), (2, 128, 7), (3, 384, 3)]


@pytest.mark.parametrize("C,chunk,nblocks", _GN_CASES)
def test_gn_fused_kernel_emulated(emu, C, chunk, nblocks):
    data, cp, q, t = _packed(C, [700, 300] if chunk > 128 else [200, 90], chunk, seed=C)
    G = _gn_emulated(emu, data, cp, q, t, C, chunk, nblocks)
    n = 6 * C
    H, b, c = (x.numpy() for x in gn.gn_fused_plain(q.double(), t.double(), data.double(), cp, C, chunk))
    np.testing.assert_allclose(G[:n, :n], H, rtol=0, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(G[:n, n], b, rtol=0, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(G[n, :n], b, rtol=0, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(G[n, n], c, rtol=1e-6)


@pytest.mark.parametrize("C,chunk,nblocks", _GN_CASES[:4])
def test_gn_cost_batch_kernel_emulated(emu, C, chunk, nblocks):
    """K candidates in one pass: each element has the bits of the full pass's
    cost at that candidate on the same grid, and agrees with the plain version."""
    data, cp, q, t = _packed(C, [700, 300], chunk, seed=10 + C)
    rng = np.random.RandomState(C)
    K = 3 if C == 2 else gn.GN_MAX_CANDIDATES
    cands = [[tm.se3_exp_np(0.3 * rng.randn(6)) for _ in range(C)] for _ in range(K)]
    qs = torch.tensor(np.asarray([[a for a, _ in c] for c in cands]), dtype=torch.float32)
    ts = torch.tensor(np.asarray([[b for _, b in c] for c in cands]), dtype=torch.float32)
    got = _cost_batch_emulated(emu, data, cp, qs, ts, C, chunk, nblocks)
    ref = gn.gn_cost_batch_plain(qs.double(), ts.double(), data.double(), cp, C, chunk).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    for k in (0, K - 1):
        full = _gn_emulated(emu, data, cp, qs[k].contiguous(), ts[k].contiguous(), C, chunk, nblocks)
        assert got[k] == full[6 * C, 6 * C]


def test_gn_fused_kernel_emulated_poisons_invalid_pairs(emu):
    data, cp, q, t = _packed(2, [300], 256, seed=9)
    cp[1, 0] = 7  # no such cloud
    assert np.isnan(_gn_emulated(emu, data, cp, q, t, 2, 256, 2)).all()
    qs, ts = torch.stack([q, q]), torch.stack([t, t])
    assert np.isnan(_cost_batch_emulated(emu, data, cp, qs, ts, 2, 256, 2)).all()


def test_persistent_grid_queries_emulated(emu):
    """The grid comes from the runtime's SM count and occupancy (the
    emulation reports 2 SMs with one resident block each; the read-and-sum
    kernel rounds to a multiple of 8 blocks, one per row, and takes 8 at least)."""
    assert emu.dpt_gn_grid() == 2
    assert emu.dpt_hbm_read_sum_grid() == 8
    assert emu.dpt_moment_gram_grid() == 2
    assert emu.dpt_gn_rows_grid(5) == 2 and emu.dpt_gn_rows_grid(21) == 2
    assert emu.dpt_gn_rows_grid(22) < 0 and emu.dpt_gn_rows_grid(0) < 0


@pytest.mark.parametrize("rows_per_block,chunk", [(256, 1024), (512, 1024), (2048, 2048)])
def test_moment_gram_kernel_emulated(emu, rows_per_block, chunk):
    """2048 rows are eight tiles: the ring of four raw tiles wraps twice."""
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
    d = data.data_ptr()
    assert emu.dpt_gn_fused(d, 13, 512, d, d, d, 2, 192, 1, d, d, d, None) != 0  # chunk % 128
    assert emu.dpt_gn_fused(d, 13, 512, d, d, d, 2, 384, 1, d, d, d, None) != 0  # Mp % chunk
    assert emu.dpt_gn_fused(d, 12, 512, d, d, d, 2, 256, 1, d, d, d, None) != 0  # too few rows
    assert emu.dpt_gn_fused(d, 13, 512, d, d, d, 65, 256, 1, d, d, d, None) != 0  # too many clouds
    assert emu.dpt_gn_fused(d, 13, 512, d, d, d, 2, 256, 0, d, d, d, None) != 0  # no block
    assert emu.dpt_gn_cost_batch(d, 13, 512, d, d, d, 11, 2, 256, 1, d, d, d, d, None) != 0  # K > 10
    assert emu.dpt_gn_cost_batch(d, 13, 512, d, d, d, 0, 2, 256, 1, d, d, d, d, None) != 0  # K = 0


def _pairs_emulated(emu, flat, layout):
    """The row-paired copy by the kernel; NaN where it writes nothing."""
    nb, L = flat.shape[0], layout.levels
    pairs = torch.full((nb, layout.pair_total), float("nan"))
    assert emu.dpt_pyramid_pairs(
        flat.data_ptr(), layout.total, pairs.data_ptr(), layout.pair_total, nb,
        (ctypes.c_int * L)(*layout.hs), (ctypes.c_int * L)(*layout.ws),
        (ctypes.c_longlong * L)(*layout.offs), (ctypes.c_longlong * L)(*layout.pair_offs), L,
        None) == 0
    return pairs


def _pyramid_emulated(emu, flat, layout, pix, scale, with_derivs):
    nb, n = scale.shape
    L = layout.levels
    pairs = _pairs_emulated(emu, flat, layout)
    outs = [torch.full((nb, n), float("nan")) for _ in range(4)]
    ok = torch.zeros((nb, n), dtype=torch.bool)
    ptrs = [o.data_ptr() for o in outs[1:]] if with_derivs else [None] * 3
    err = emu.dpt_pyramid_sample(
        pairs.data_ptr(), layout.pair_total, nb, (ctypes.c_int * L)(*layout.hs),
        (ctypes.c_int * L)(*layout.ws), (ctypes.c_longlong * L)(*layout.pair_offs), L,
        pix.data_ptr(), scale.data_ptr(), n, int(with_derivs), outs[0].data_ptr(), *ptrs,
        ok.data_ptr(), None)
    assert err == 0
    return (outs[0], *outs[1:], ok) if with_derivs else (outs[0], ok)


@pytest.mark.parametrize("L,with_derivs", [(1, True), (4, True), (4, False), (3, True), (1, False),
                                           (3, False)])
def test_pyramid_sample_kernel_emulated(emu, L, with_derivs):
    """Both modes against the plain version: ``ok`` bit-equal, including
    observations exactly on integer pixel coordinates and integer scales;
    the taps come from the row-paired copy (odd level widths pad its rows)."""
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


@pytest.mark.parametrize("shapes", [[(37, 53), (18, 26), (9, 13), (4, 6)], [(5, 2)], [(6, 7), (3, 3)]])
def test_pyramid_pairs_kernel_emulated(emu, shapes):
    """The row-paired copy by the kernel equals its plain version bit for
    bit, padding included: odd widths, the narrowest level (W = 2) and a
    single level."""
    rng = np.random.RandomState(len(shapes))
    pyr = [torch.from_numpy(rng.randn(3, h, w).astype(np.float32)) for h, w in shapes]
    flat, layout = tps.flatten_pyramid(pyr)
    assert torch.equal(_pairs_emulated(emu, flat, layout), tps.pair_rows_plain(flat, layout))


def test_pyramid_sample_entry_point_rejects_bad_arguments(emu):
    # levels 8x8 and 4x4: pair rows of 16 and 8 floats at 0 and 112, 136 in all
    pairs = torch.zeros((1, 136))
    hs, ws = (ctypes.c_int * 2)(8, 4), (ctypes.c_int * 2)(8, 4)
    offs = (ctypes.c_longlong * 2)(0, 112)
    v = torch.zeros(4)
    ok = torch.zeros(4, dtype=torch.bool)
    pix, sc = torch.zeros(8), torch.zeros(4)
    args = (pix.data_ptr(), sc.data_ptr(), 4, 0, v.data_ptr(), None, None, None, ok.data_ptr(),
            None)
    p = pairs.data_ptr()
    assert emu.dpt_pyramid_sample(p, 136, 1, hs, ws, offs, 2, *args) == 0
    assert emu.dpt_pyramid_sample(p, 132, 1, hs, ws, offs, 2, *args) != 0  # level 1 overruns
    assert emu.dpt_pyramid_sample(p, 138, 1, hs, ws, offs, 2, *args) != 0  # stride % 4
    assert emu.dpt_pyramid_sample(p + 8, 136, 1, hs, ws, offs, 2, *args) != 0  # not 16-byte aligned
    assert emu.dpt_pyramid_sample(p, 136, 1, hs, ws, (ctypes.c_longlong * 2)(0, 110), 2, *args) != 0
    assert emu.dpt_pyramid_sample(p, 136, 1, hs, ws, offs, 0, *args) != 0
    derivs = args[:3] + (1,) + args[4:]  # derivatives requested without buffers
    assert emu.dpt_pyramid_sample(p, 136, 1, hs, ws, offs, 2, *derivs) != 0
    flat = torch.zeros((1, 80))
    poffs = (ctypes.c_longlong * 2)(0, 112)
    flat_offs = (ctypes.c_longlong * 2)(0, 64)
    assert emu.dpt_pyramid_pairs(flat.data_ptr(), 80, p, 136, 1, hs, ws, flat_offs, poffs, 2,
                                 None) == 0
    assert emu.dpt_pyramid_pairs(flat.data_ptr(), 70, p, 136, 1, hs, ws, flat_offs, poffs, 2,
                                 None) != 0  # flat level 1 overruns
    assert emu.dpt_pyramid_pairs(flat.data_ptr(), 80, p, 132, 1, hs, ws, flat_offs, poffs, 2,
                                 None) != 0  # paired level 1 overruns


# ---------------------------------------------------------------------------
# B4a, B4b, B4c, B5a, B5b
# ---------------------------------------------------------------------------


def _rows_inputs(C, M, seed, ids="random"):
    """Precomputed rows with per-row cloud ids, weights of 0, 1 and in
    between. ``ids``: "random" (in range, equal 1 time in C), "unknown" (drawn
    from [-2, C + 2): rows with both, one (negative and >= C) or no id
    outside [0, C), and equal ids), or "sorted" (the engine's layout: groups of
    one ordered pair each, of uneven sizes, so that runs of one class end
    inside units and blocks)."""
    rng = np.random.RandomState(seed)
    j1, j2 = (torch.from_numpy(rng.randn(6, M).astype(np.float32)) for _ in range(2))
    r1, r2 = (torch.from_numpy((0.1 * rng.randn(M)).astype(np.float32)) for _ in range(2))
    if ids == "random":
        sid = rng.randint(0, C, M)
        tid = (sid + rng.randint(0, C, M)) % C
    elif ids == "unknown":
        sid, tid = rng.randint(-2, C + 2, M), rng.randint(-2, C + 2, M)
        sid[:4], tid[:4] = [7, 0, -1, C], [0, -1, 0, 0]
    else:
        pairs = [(s, t) for s in range(C) for t in range(C) if s != t] or [(0, 1)]
        cuts = np.sort(rng.choice(np.arange(1, M), len(pairs) - 1, replace=False))
        sizes = np.diff(np.concatenate([[0], cuts, [M]]))
        sid, tid = (np.repeat(np.asarray(col), sizes) for col in zip(*pairs))
    w = np.where(rng.rand(M) < 0.5, (rng.rand(M) > 0.2).astype(np.float32),
                 rng.rand(M).astype(np.float32)).astype(np.float32)
    return (j1, j2, r1, r2, torch.from_numpy(sid.astype(np.int32)),
            torch.from_numpy(tid.astype(np.int32)), torch.from_numpy(w))


def _gn_rows_emulated(emu, args, C, nblocks):
    M = args[0].shape[1]
    sums = C * (C + 1) // 2 * 28
    scratch = torch.full(((nblocks + 2) * sums,), float("nan"))
    ticket = torch.zeros(1, dtype=torch.int32)
    G = torch.full((6 * C + 1, 6 * C + 1), float("nan"), dtype=torch.float64)
    assert emu.dpt_gn_rows(*[a.data_ptr() for a in args], M, C, nblocks,
                           scratch.data_ptr(), ticket.data_ptr(), G.data_ptr(), None) == 0
    assert int(ticket) == 0  # the last block leaves the ticket ready for the next call
    return G.numpy()


# C from 1 to 14 (C = 14: 94 KB of class tables, above the 48 KB default);
# ragged last units (M no multiple of 128), grids of 1 to 4 blocks and one
# (M = 5) with blocks that get no unit; 32, 16, 8, 4, 2 and 1 class tables a
# warp (C <= 3, 4, 5, 7, 10 and >= 11)
_ROWS_CASES = [(1, 333, 2, "unknown"), (2, 1500, 3, "random"), (2, 1500, 2, "unknown"),
               (3, 700, 2, "random"), (4, 700, 1, "unknown"), (5, 2000, 3, "unknown"),
               (5, 2000, 2, "random"), (2, 3000, 3, "sorted"), (5, 3000, 4, "sorted"),
               (7, 1200, 2, "unknown"), (10, 1200, 1, "random"), (14, 3000, 2, "sorted"),
               (14, 1200, 2, "unknown"), (21, 700, 2, "random"), (2, 5, 3, "unknown")]


@pytest.mark.parametrize("C,M,nblocks,ids", _ROWS_CASES)
def test_gn_rows_kernel_emulated(emu, C, M, nblocks, ids):
    """Against the float64 plain version; G exactly symmetric; two launches
    bit-equal."""
    args = _rows_inputs(C, M, seed=C + M, ids=ids)
    G = _gn_rows_emulated(emu, args, C, nblocks)
    np.testing.assert_array_equal(G, G.T)
    np.testing.assert_array_equal(G, _gn_rows_emulated(emu, args, C, nblocks))
    H, b, c = (x.numpy() for x in gn.gn_rows_plain(*[a.double() if a.is_floating_point() else a
                                                     for a in args], C))
    n = 6 * C
    assert np.abs(H).max() > 0 and np.abs(b).max() > 0
    np.testing.assert_allclose(G[:n, :n], H, rtol=0, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(G[:n, n], b, rtol=0, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(G[n, n], c, rtol=1e-6)


def test_gn_rows_kernel_emulated_one_unknown_id(emu):
    """Rows with exactly one id outside [0, C) add to H and b at the other
    id's block: C = 2, every row sid = 7, tid = 0 or sid = 1, tid = -1."""
    args = list(_rows_inputs(2, 700, seed=3))
    args[4] = torch.from_numpy(np.where(np.arange(700) % 3 == 0, 7, 1).astype(np.int32))
    args[5] = torch.from_numpy(np.where(np.arange(700) % 3 == 0, 0, -1).astype(np.int32))
    G = _gn_rows_emulated(emu, args, 2, 2)
    H, b, c = (x.numpy() for x in gn.gn_rows_plain(*[a.double() if a.is_floating_point() else a
                                                     for a in args], 2))
    assert np.abs(H[:6, :6]).max() > 0 and np.abs(H[6:, 6:]).max() > 0 and not H[:6, 6:].any()
    np.testing.assert_allclose(G[:12, :12], H, rtol=0, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(G[:12, 12], b, rtol=0, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(G[12, 12], c, rtol=1e-6)


def test_emulated_warp_intrinsics(emu):
    """``__shfl_sync``, ``__ballot_sync``, ``__match_any_sync`` and ``__ffs``
    of the emulation, per warp of a block of 72 threads (the last warp has 8)."""
    n = 72
    rng = np.random.RandomState(0)
    vals = rng.randint(0, 4, n).astype(np.int32)
    src = rng.randint(0, 64, n).astype(np.int32)  # lanes above 31 wrap, as on the card
    src[64:] %= 8  # ... within the last warp's lanes
    outs = [np.full(n, -1, np.int32), np.zeros(n, np.uint32), np.zeros(n, np.uint32),
            np.full(n, -1, np.int32)]
    fn = emu.emu_warp_ops
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    assert fn(vals.ctypes.data, src.ctypes.data, *[o.ctypes.data for o in outs], n) == 0
    shfl, ballot, match, first = outs
    for t in range(n):
        w0 = t // 32 * 32
        lanes = vals[w0:w0 + 32]
        assert shfl[t] == vals[w0 + src[t] % 32]
        assert ballot[t] == sum(1 << l for l in range(len(lanes)) if lanes[l] & 1)
        assert match[t] == sum(1 << l for l in range(len(lanes)) if lanes[l] == vals[t])
        assert first[t] == int(np.flatnonzero(lanes == vals[t])[0])


@pytest.mark.parametrize("nbytes,allow,ok", [(16384, -1, True), (65536, -1, False),
                                             (65536, 65536, True), (131072, 65536, False),
                                             (232448, 232448, True), (240000, 240000, False)])
def test_emulated_dynamic_smem_limit(emu, nbytes, allow, ok):
    """As on the card: more than 48 KB of dynamic shared memory only after
    ``cudaFuncSetAttribute`` raised the kernel's limit, and never above 227 KB."""
    out = np.full(1, np.nan, np.float32)
    fn = emu.emu_dynamic_smem_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    err = fn(nbytes, allow, out.ctypes.data)
    assert (err == 0) == ok
    if ok:
        assert out[0] == nbytes // 4 - 1


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


@pytest.mark.parametrize("chunk", [768, 384, 3300])
def test_moment_gram_thirds_kernel_emulated(emu, chunk):
    """A third of 3300 is 1100 rows: five tiles, the last partly masked."""
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


@pytest.mark.parametrize("repeats,nblocks,mp", [(1, 8, 5000), (1, 24, 5000), (3, 16, 5000),
                                                (2, 24, 5000), (1, 16, 4), (1, 8, 20000)])
def test_hbm_read_sum_kernel_emulated(emu, repeats, nblocks, mp):
    """A grid of 1, 2 and 3 shares per row (8 blocks each, one per row) whose
    shares are no multiple of a block's trip, are empty (mp = 4) or take
    several trips (mp = 20000); one kernel per repeat, the last one making the
    final sum; two calls in a row, so that the ticket is shown to come back
    to 0."""
    from dataset_pipeline_tpu_torch.ops import hbm

    data2 = torch.from_numpy(np.random.RandomState(9).randn(2, 8, mp).astype(np.float32))
    partials = torch.full((nblocks,), float("nan"))
    ticket = torch.zeros(1, dtype=torch.int32)
    ref = hbm.hbm_read_sum_plain(data2.double(), repeats).numpy()
    for _ in range(2):
        out = torch.full((8,), float("nan"))
        launched = ctypes.c_int(-1)
        assert emu.dpt_hbm_read_sum(data2.data_ptr(), mp, repeats, partials.data_ptr(), nblocks,
                                    ticket.data_ptr(), out.data_ptr(), ctypes.byref(launched),
                                    None) == 0
        assert launched.value == repeats and int(ticket) == 0
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-5 * float(data2.abs().sum(2).max()))


def test_new_entry_points_reject_bad_arguments(emu):
    data = torch.zeros((2, 13, 768))
    parts = torch.zeros((6, 48, 48))
    p, d = parts.data_ptr(), data.data_ptr()
    assert emu.dpt_moment_gram48(d, 13, 768, 500, p, 1, None) != 0  # chunks do not cover Mp
    assert emu.dpt_moment_gram_thirds(d, 13, 768, 256, p, 3, None) != 0  # chunk % 3
    assert emu.dpt_moment_gram_thirds(d, 12, 768, 384, p, 2, None) != 0  # too few rows
    assert emu.dpt_moment_gram_repeat(d, 13, 768, 256, p, 3, 0, None) != 0  # no repeat
    assert emu.dpt_moment_gram_repeat(d, 13, 768, 256, p, 2, 1, None) != 0  # blocks do not cover
    assert emu.dpt_hbm_read_sum(d, 770, 1, p, 8, p, p, None, None) != 0  # mp % 4
    assert emu.dpt_hbm_read_sum(d, 768, 1, p, 12, p, p, None, None) != 0  # blocks: no multiple of 8
    assert emu.dpt_hbm_read_sum(d, 768, 0, p, 8, p, p, None, None) != 0  # no repeat
    assert emu.dpt_hbm_read_sum(d, 768, 1, p, 0, p, p, None, None) != 0  # no block
    z = [d] * 7
    assert emu.dpt_gn_rows(*z, 100, 22, 1, p, p, p, None) != 0  # class tables exceed shared memory
    assert emu.dpt_gn_rows(*z, 100, 0, 1, p, p, p, None) != 0  # no cloud
    assert emu.dpt_gn_rows(*z, 0, 2, 1, p, p, p, None) != 0  # no row
    assert emu.dpt_gn_rows(*z, 100, 2, 0, p, p, p, None) != 0  # no block


# ---------------------------------------------------------------------------
# E1-E7: the gather probes' kernels
# ---------------------------------------------------------------------------


def _i32(rng, hi, shape):
    return torch.from_numpy(rng.randint(0, hi, shape).astype(np.int32))


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("B,S,W", [(1, 64, 128), (3, 8, 128), (2, 5, 36)])
def test_tile_gather_probes_emulated(emu, B, S, W):
    """E1-E4 against their plain versions, exactly: whole tiles, a tile
    smaller than one pass of the block's threads, and a width that is no
    multiple of 32."""
    from dataset_pipeline_tpu_torch.ops import gather

    rng = np.random.RandomState(B * 100 + S)
    rows = _f32(rng.randn(B, S, W))
    K = min(S, 3)
    nan = float("nan")

    idx = _i32(rng, W, (B, S, W))
    out = torch.full((B, S, W), nan)
    assert emu.dpt_take_along_lanes(rows.data_ptr(), idx.data_ptr(), out.data_ptr(), B, S, W, None) == 0
    assert torch.equal(out, gather.take_along_lanes_plain(rows, idx))

    idx = _i32(rng, S, (B, K, W))
    out = torch.full((B, K, W), nan)
    assert emu.dpt_take_along_sublanes(rows.data_ptr(), idx.data_ptr(), out.data_ptr(), B, S, K, W,
                                       None) == 0
    assert torch.equal(out, gather.take_along_sublanes_plain(rows, idx))

    idx = _i32(rng, S, (B, 7))
    out = torch.full((B, 7, W), nan)
    assert emu.dpt_take_rows(rows.data_ptr(), idx.data_ptr(), out.data_ptr(), B, S, 7, W, None) == 0
    assert torch.equal(out, gather.take_rows_plain(rows, idx))

    iy, ix = _i32(rng, S, (B, K, W)), _i32(rng, W, (B, K, W))
    out = torch.full((B, K, W), nan)
    assert emu.dpt_advanced_2d(rows.data_ptr(), iy.data_ptr(), ix.data_ptr(), out.data_ptr(), B, S, K,
                               W, None) == 0
    assert torch.equal(out, gather.advanced_2d_plain(rows, iy, ix))


@pytest.mark.parametrize("n_tiles,TH,TW,cap", [(3, 8, 128, 512), (2, 8, 128, 100), (2, 5, 12, 300)])
def test_tile_gather_kernel_emulated(emu, n_tiles, TH, TW, cap):
    """E5 bit for bit against its plain version (no FMA on either side):
    ``cap`` above, below and no multiple of the block's 256 threads."""
    from dataset_pipeline_tpu_torch.ops import gather

    rng = np.random.RandomState(cap)
    tiles = _f32(rng.randn(n_tiles, TH, TW))
    iy, ix = _i32(rng, TH - 1, (n_tiles, cap)), _i32(rng, TW - 1, (n_tiles, cap))
    iy[0, :2], ix[0, :2] = TH - 2, TW - 2  # the last footprint of the tile
    fy, fx = _f32(rng.rand(n_tiles, cap)), _f32(rng.rand(n_tiles, cap))
    out = torch.full((n_tiles, 4, cap), float("nan"))
    assert emu.dpt_tile_gather(tiles.data_ptr(), iy.data_ptr(), ix.data_ptr(), fy.data_ptr(),
                               fx.data_ptr(), out.data_ptr(), n_tiles, TH, TW, cap, None) == 0
    assert torch.equal(out, gather.tile_gather_plain(tiles, iy, ix, fy, fx))


def _e6_emulated(emu, r0, r1, lane, fx, fy):
    n, W = r0.shape
    out = torch.full((n, 8), float("nan"))
    assert emu.dpt_row_extract(r0.data_ptr(), r1.data_ptr(), lane.data_ptr(), fx.data_ptr(),
                               fy.data_ptr(), out.data_ptr(), n, W, None) == 0
    return out


def _e7_emulated(emu, ra, rb, la, lb, fr, bx, nblocks=2):
    n, W = ra.shape
    out = torch.full((n, 8), float("nan"))
    assert emu.dpt_row_extract_packed(ra.data_ptr(), rb.data_ptr(), la.data_ptr(), lb.data_ptr(),
                                      *[f.data_ptr() for f in fr], out.data_ptr(), n, W, bx,
                                      nblocks, None) == 0
    return out


def _offset_rows(rng, n, W, offset):
    """(n, W) float32 rows whose base lies ``offset`` floats past a 16-byte
    boundary (a contiguous view into a larger buffer, as a slice makes)."""
    buf = _f32(rng.randn(n * W + 4))
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + n * W].view(n, W)


@pytest.mark.parametrize("n,W", [(1, 128), (255, 128), (256, 128), (700, 128), (300, 40)])
def test_row_extract_kernels_emulated(emu, n, W):
    """E6 and E7 bit for bit against their plain versions, ragged tails
    (n below, at and above one block of 256) and the lanes' extremes."""
    from dataset_pipeline_tpu_torch.ops import gather

    rng = np.random.RandomState(n)
    ra, rb = _f32(rng.randn(n, W)), _f32(rng.randn(n, W))
    fr = [_f32(rng.rand(n, 1)) for _ in range(5)]
    lane = _i32(rng, W - 1, (n, 1))
    lane[0, 0] = W - 2
    out = _e6_emulated(emu, ra, rb, lane, fr[0], fr[1])
    assert torch.equal(out, gather.row_extract_plain(ra, rb, lane, fr[0], fr[1]))

    bx = 32 if W == 128 else 9
    la, lb = _i32(rng, W - bx - 1, (n, 1)), _i32(rng, W - bx - 1, (n, 1))
    la[0, 0], lb[0, 0] = W - bx - 2, 0
    out = _e7_emulated(emu, ra, rb, la, lb, fr, bx)
    assert torch.equal(out, gather.row_extract_packed_plain(ra, rb, la, lb, *fr, bx=bx))


@pytest.mark.parametrize("residue", range(16))
def test_row_extract_lane_classes_emulated(emu, residue):
    """Every lane class mod 16 (whether a pair takes one 8-byte or two 4-byte
    tap loads, and whether it straddles a sector or a 64-byte chunk), with the
    last lane each kernel allows: bit for bit, no misaligned load, and vector
    loads wherever the class allows them."""
    from dataset_pipeline_tpu_torch.ops import gather

    n, W, bx = 300, 128, 32
    rng = np.random.RandomState(60 + residue)
    ra, rb = _f32(rng.randn(n, W)), _f32(rng.randn(n, W))
    fr = [_f32(rng.rand(n, 1)) for _ in range(5)]
    lane = _i32(rng, (W - 2 - residue) // 16 + 1, (n, 1)) * 16 + residue
    lane[0, 0] = W - 2
    emu.emu_reset_load_counts()
    out = _e6_emulated(emu, ra, rb, lane, fr[0], fr[1])
    assert torch.equal(out, gather.row_extract_plain(ra, rb, lane, fr[0], fr[1]))
    la = _i32(rng, (W - bx - 2 - residue) // 16 + 1, (n, 1)) * 16 + residue
    la[0, 0] = W - bx - 2
    lb = la.flip(0)
    out = _e7_emulated(emu, ra, rb, la, lb, fr, bx)
    assert torch.equal(out, gather.row_extract_packed_plain(ra, rb, la, lb, *fr, bx=bx))
    assert emu.emu_misaligned_loads() == 0
    # one vector load per tap pair (E6 two, E7 four per observation) in the even classes; in
    # the odd ones (two 4-byte loads) only the pairs set to the last lanes (class 14) are
    # vectors: E6's first observation, E7's first on level A and last on level B
    assert emu.emu_vector_load_count() == (2 + 2 + 2 if residue % 2 else 2 * n + 4 * n)


@pytest.mark.parametrize("W,bx,offset", [(127, 9, 1), (127, 32, 0), (128, 32, 1), (41, 9, 1),
                                         (128, 9, 3), (40, 9, 2)])
def test_row_extract_odd_rows_emulated(emu, W, bx, offset):
    """Rows of odd width and rows that start 4, 8 or 12 bytes past a 16-byte
    boundary: the tap loads are chosen from the address, so every result is
    still the plain version's bits and no load is misaligned."""
    from dataset_pipeline_tpu_torch.ops import gather

    n = 400
    rng = np.random.RandomState(W * 10 + bx + offset)
    ra, rb = _offset_rows(rng, n, W, offset), _offset_rows(rng, n, W, offset)
    assert ra.is_contiguous() and ra.data_ptr() % 16 == 4 * offset
    fr = [_f32(rng.rand(n, 1)) for _ in range(5)]
    lane = _i32(rng, W - 1, (n, 1))
    lane[0, 0], lane[1, 0] = W - 2, 0
    la, lb = _i32(rng, W - bx - 1, (n, 1)), _i32(rng, W - bx - 1, (n, 1))
    la[0, 0], lb[0, 0], la[1, 0] = W - bx - 2, 0, 0
    emu.emu_reset_load_counts()
    out = _e6_emulated(emu, ra, rb, lane, fr[0], fr[1])
    assert torch.equal(out, gather.row_extract_plain(ra, rb, lane, fr[0], fr[1]))
    out = _e7_emulated(emu, ra, rb, la, lb, fr, bx)
    assert torch.equal(out, gather.row_extract_packed_plain(ra, rb, la, lb, *fr, bx=bx))
    assert emu.emu_misaligned_loads() == 0
    assert emu.emu_vector_load_count() > n  # some taps went as vectors


@pytest.mark.parametrize("n,nblocks", [(0, 2), (1, 2), (256, 1), (257, 2), (1024, 1), (1025, 2),
                                       (5000, 2), (4133, 3)])
def test_row_extract_sizes_emulated(emu, n, nblocks):
    """Zero and one observation, one block's threads and one more, one trip of
    an E7 block (4 observations a thread) and one more, and E7 grid-stride
    walks on ``nblocks`` blocks whose last trip is ragged: every row written
    once, bit for bit."""
    from dataset_pipeline_tpu_torch.ops import gather

    W, bx = 128, 32
    rng = np.random.RandomState(n + nblocks)
    ra, rb = _f32(rng.randn(n, W)), _f32(rng.randn(n, W))
    fr = [_f32(rng.rand(n, 1)) for _ in range(5)]
    lane = _i32(rng, W - 1, (n, 1))
    out = _e6_emulated(emu, ra, rb, lane, fr[0], fr[1])
    assert torch.equal(out, gather.row_extract_plain(ra, rb, lane, fr[0], fr[1]))
    la, lb = _i32(rng, W - bx - 1, (n, 1)), _i32(rng, W - bx - 1, (n, 1))
    out = _e7_emulated(emu, ra, rb, la, lb, fr, bx, nblocks)
    assert torch.equal(out, gather.row_extract_packed_plain(ra, rb, la, lb, *fr, bx=bx))


def test_row_extract_packed_grid_query_emulated(emu):
    """E7 sizes its grid from the resident blocks (the emulation's 2 SMs with
    one block each)."""
    assert emu.dpt_row_extract_packed_grid() == 2


def test_gather_entry_points_reject_bad_arguments(emu):
    z = torch.zeros(16384)
    d = z.data_ptr()
    assert emu.dpt_take_along_lanes(d, d, d, 1, 65, 128, None) != 0  # tile above 8192 floats
    assert emu.dpt_take_along_lanes(d, d, d, 0, 8, 128, None) != 0  # no tile
    assert emu.dpt_take_along_sublanes(d, d, d, 1, 3, 1, 5, None) != 0  # 15 floats: no float4
    assert emu.dpt_take_along_sublanes(d, d, d, 1, 8, 0, 128, None) != 0  # K = 0
    assert emu.dpt_take_rows(d, d, d, 1, 8, 2, 6, None) != 0  # W % 4
    assert emu.dpt_advanced_2d(d, d, d, d, 1, 128, 1, 128, None) != 0  # tile above 8192
    assert emu.dpt_tile_gather(d, d, d, d, d, d, 1, 1, 128, 4, None) != 0  # no second row
    assert emu.dpt_tile_gather(d, d, d, d, d, d, 1, 8, 128, 0, None) != 0  # no task
    assert emu.dpt_row_extract(d, d, d, d, d, d, -1, 128, None) != 0
    assert emu.dpt_row_extract(d, d, d, d, d, d, 4, 1, None) != 0  # no second lane
    assert emu.dpt_row_extract(d, d, d, d, d, d, 0, 128, None) == 0  # nothing to do
    assert emu.dpt_row_extract_packed(*[d] * 10, 4, 33, 32, 2, None) != 0  # bx + 2 > W
    assert emu.dpt_row_extract_packed(*[d] * 10, 4, 128, 0, 2, None) != 0
    assert emu.dpt_row_extract_packed(*[d] * 10, 4, 128, 32, 0, None) != 0  # no block
    assert emu.dpt_row_extract_packed(*[d] * 10, 0, 128, 32, 2, None) == 0


# ---------------------------------------------------------------------------
# The H,b geometry kernel (csrc/hb_geometry.cu): both launch modes
# ---------------------------------------------------------------------------

HB_PARAMS = {"PINHOLE": [150.0, 156.0, 79.5, 59.5], "SIMPLE_PINHOLE": [150.0, 79.5, 59.5],
             "THIN_PRISM_FISHEYE": [150.0, 156.0, 79.5, 59.5, 0.28, 0.09, 2e-4, -3e-4, 2e-3, 1e-3,
                                    4e-4, -2e-4]}


def _hb_inputs(model, per_image, nb=2, M=700):
    """A 160x120 camera with a radius cutoff of 1, poses near the identity,
    points (M,3) or (nb,M,3) 2 to 5 from the camera plane: a sixth behind it,
    a sixth spread beyond the cutoff; B3's derivatives at random."""
    import dataclasses

    from dataset_pipeline_tpu_torch.models import cameras as cm
    from dataset_pipeline_tpu_torch.models.lie import SE3

    rng = np.random.RandomState(3 + per_image)
    cam = cm.make_camera(model, 160, 120, HB_PARAMS[model], cutoff=False, device="cpu")
    cam = dataclasses.replace(cam, radius_cutoff_sq=torch.tensor(1.0))
    shape = (nb, M) if per_image else (M,)
    z = rng.uniform(2.0, 5.0, shape)
    z[..., : M // 6] *= -1.0
    n = rng.uniform(-0.5, 0.5, shape + (2,))
    n[..., M // 6: M // 3, :] *= 4.0
    pts = torch.from_numpy(np.concatenate([n * np.abs(z)[..., None], z[..., None]], -1)
                           .astype(np.float32))
    pose = SE3.exp(torch.from_numpy((0.02 * rng.randn(nb, 6)).astype(np.float32)))
    derivs = [torch.from_numpy(rng.randn(nb, M).astype(np.float32)) for _ in range(3)]
    return cam, pose.q.contiguous(), pose.t.contiguous(), pts, derivs


def _jacobian_oracle(hg, cam, q, t, pts, derivs, optimize_intrinsics, dynamic_scale):
    """The plain version's J: in float32, or under a fisheye lens in float64
    (the kernel takes the lens in double)."""
    import dataclasses

    if cam.spec.fisheye:
        cam = dataclasses.replace(cam, params=cam.params.double())
        q, t, pts = q.double(), t.double(), pts.double()
        derivs = [d.double() for d in derivs]
    return hg.jacobian_plain(cam, cam.params, q, t, pts, 0.004, *derivs, optimize_intrinsics,
                             dynamic_scale)


@pytest.mark.parametrize("model", sorted(HB_PARAMS))
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("dynamic_scale,optimize_intrinsics", [(False, False), (True, True),
                                                               (True, False), (False, True)])
def test_hb_geometry_kernel_emulated(emu, model, per_image, dynamic_scale, optimize_intrinsics):
    """``project``: valid bit-equal and pix within 1e-6 of the plain
    version, relatively (a few float32 ulps: the norm of the quaternion and
    the rotation round in another order); ``jacobian``: the layout
    [P intrinsics | 6 pose], and J within 1e-3 of the jvp on valid rows,
    relative to the entry plus a thousandth of its column's largest (the
    footprint's tangent is a difference of nearly equal terms). Under
    THIN_PRISM_FISHEYE pix is held within 4e-5 px: the pre-warp's atan rounds
    an ulp or two apart in the C library and in torch. M = 700 leaves a
    partial last block. The lens's J is held to the plain version in
    float64: in float32 its footprint tangent, a difference of two lens
    evaluations 1e-3 apart, is itself good to only ~1e-3."""
    from dataset_pipeline_tpu_torch.ops import hb_geometry as hg

    cam, q, t, pts, (dpx, dpy, dvds) = _hb_inputs(model, per_image)
    nb, M = q.shape[0], pts.shape[-2]
    uf = hg._MODEL_IDS[model]
    pix = torch.full((nb, M, 2), float("nan"))
    valid = torch.zeros((nb, M), dtype=torch.bool)
    cut = cam.radius_cutoff_sq
    assert emu.dpt_hb_geometry_project(q.data_ptr(), t.data_ptr(), cam.params.data_ptr(), uf,
                                       cut.data_ptr(), 0.0, pts.data_ptr(), int(per_image), M, nb,
                                       pix.data_ptr(), valid.data_ptr(), None) == 0
    V = (cam.params.shape[0] if optimize_intrinsics else 0) + 6
    J = torch.full((nb, M, V), float("nan"))
    assert emu.dpt_hb_geometry_jacobian(q.data_ptr(), t.data_ptr(), cam.params.data_ptr(), uf,
                                        pts.data_ptr(), int(per_image), M, nb, dpx.data_ptr(),
                                        dpy.data_ptr(), dvds.data_ptr(), 0.004,
                                        int(dynamic_scale), int(optimize_intrinsics),
                                        J.data_ptr(), None) == 0
    pix_p, valid_p = hg.project_plain(cam, cam.params, q, t, pts)
    J_p = _jacobian_oracle(hg, cam, q, t, pts, (dpx, dpy, dvds), optimize_intrinsics,
                           dynamic_scale)
    assert torch.equal(valid, valid_p) and 0.4 < valid_p.float().mean() < 0.8
    np.testing.assert_allclose(pix.numpy(), pix_p.numpy(), rtol=1e-6,
                               atol=4e-5 if cam.spec.fisheye else 1e-5)
    Jv, Jpv = J[valid_p].double(), J_p[valid_p].double()
    scale = Jpv.abs() + 1e-3 * Jpv.abs().amax(0)
    assert bool(torch.isfinite(J).all())
    assert bool(((Jv - Jpv).abs() <= 1e-3 * scale).all()), float(((Jv - Jpv).abs() / scale).max())


def test_hb_geometry_entry_points_reject_bad_arguments(emu):
    z = torch.zeros(64)
    d = z.data_ptr()
    assert emu.dpt_hb_geometry_project(d, d, d, 0, None, 1.0, d, 0, 4, 0, d, d, None) != 0  # nb 0
    assert emu.dpt_hb_geometry_project(d, d, d, 0, None, 1.0, d, 0, -1, 1, d, d, None) != 0
    assert emu.dpt_hb_geometry_project(d, d, d, 0, None, 1.0, d, 0, 0, 1, d, d, None) == 0
    args = (d, 0, 4, 65536, d, d, d, 0.01, 1, 1, d, None)  # nb above the grid's y
    assert emu.dpt_hb_geometry_jacobian(d, d, d, 0, *args) != 0
    assert emu.dpt_hb_geometry_jacobian(d, d, d, 0, d, 0, 0, 1, d, d, d, 0.01, 1, 1, d,
                                        None) == 0  # nothing to do


# ---------------------------------------------------------------------------
# The H,b residuals and Gram products kernel (csrc/hb_gram.cu)
# ---------------------------------------------------------------------------


def _gram_inputs(V, K, nbr_per_image, desc_per_image, skipped_tile, nb=2, M=700, seed=11):
    """Rows of 2 images x 700 points (two full tiles of 256 and a partial
    one): intensities about 100 and descriptors that make about half the
    residual norms Huber inliers; 15 % of the rows invalid with NaN in their
    J (so rows whose neighbour is invalid abound), 10 % not contributing;
    ``skipped_tile`` makes every row of image 0's second tile invalid."""
    rng = np.random.RandomState(seed + V + K)
    J = rng.randn(nb, M, V).astype(np.float32)
    inten = (100.0 + 20.0 * rng.randn(nb, M)).astype(np.float32)
    ok = rng.rand(nb, M) > 0.15
    if skipped_tile:
        ok[0, 256:512] = False
    J[~ok] = np.nan
    nshape = (nb, M, K) if nbr_per_image else (M, K)
    nbr = rng.randint(0, M, nshape).astype(np.int64)
    desc = (5.0 * rng.randn(*((nb, M, K) if desc_per_image else (M, K)))).astype(np.float32)
    contrib = rng.rand(nb, M) > 0.1
    return [torch.from_numpy(x) for x in (J, inten, ok, nbr, desc, contrib)]


def _gram_emulated(emu, J, inten, ok, nbr, desc, contrib, blocks_per_image):
    from dataset_pipeline_tpu_torch.ops.robust import DEFAULT_COLOR_HUBER

    nb, M, V = J.shape
    K = nbr.shape[-1]
    rec = emu.dpt_hb_gram_record(V)
    partial = torch.full((nb * blocks_per_image * rec,), float("nan"), dtype=torch.float64)
    H = torch.full((nb, V, V), float("nan"))
    b = torch.full((nb, V), float("nan"))
    cost = torch.full((1,), float("nan"))
    count = torch.full((1,), -1, dtype=torch.int64)
    assert emu.dpt_hb_gram(J.data_ptr(), V, inten.data_ptr(), ok.data_ptr(), nbr.data_ptr(),
                           int(nbr.dim() == 3), desc.data_ptr(), int(desc.dim() == 3),
                           contrib.data_ptr(), M, nb, K, blocks_per_image, DEFAULT_COLOR_HUBER,
                           0.5 * DEFAULT_COLOR_HUBER, partial.data_ptr(), H.data_ptr(),
                           b.data_ptr(), cost.data_ptr(), count.data_ptr(), None) == 0
    return H, b, cost[0], count[0]


_GRAM_CASES = [  # (V, K, neighbours per image, desc per image, a skipped tile, blocks per image)
    (6, 4, False, False, False, 1), (10, 5, False, False, True, 2), (18, 5, False, False, False, 3),
    (6, 5, True, True, True, 2), (10, 4, True, True, False, 1), (18, 4, True, True, True, 2),
    (10, 5, True, False, False, 3), (9, 5, False, True, False, 2), (16, 4, True, True, False, 1),
    (24, 5, False, False, True, 2), (24, 4, True, True, False, 3), (20, 5, True, False, False, 1),
]


def _gram_jax(J, inten, ok, nbr, desc, contrib):
    """JAX's ``_gram_assemble`` (the function the kernel replaces), image
    by image on float64 J: H, b stacked, cost and count summed."""
    import jax
    import jax.numpy as jnp

    from dataset_pipeline_tpu.photometric import optimizer as jopt

    parts = []
    with jax.enable_x64(True):
        for i in range(J.shape[0]):
            one = [x[i] if x.dim() == 3 else x for x in (nbr, desc)]
            parts.append([np.asarray(o) for o in jopt._gram_assemble(
                jnp.asarray(J[i].double().numpy()), *(jnp.asarray(x.numpy()) for x in (
                    inten[i], ok[i], *one, contrib[i])))])
    return (torch.from_numpy(np.stack([p[0] for p in parts])),
            torch.from_numpy(np.stack([p[1] for p in parts])),
            sum(float(p[2]) for p in parts), sum(int(p[3]) for p in parts))


@pytest.mark.parametrize("V,K,nbr_per_image,desc_per_image,skipped_tile,blocks", _GRAM_CASES)
def test_hb_gram_kernel_emulated(emu, V, K, nbr_per_image, desc_per_image, skipped_tile, blocks):
    """H, b, cost and count against the port's ``gram_assemble_plain`` and
    against JAX's (``KERNELS['hb_gram'].replaces``), each with J in float64:
    the count equal, H within 1e-5 of sqrt(H_ii H_jj) and exactly symmetric,
    b within 1e-5 of sqrt(H_ii S) (S = sum w r^2, a bound of |b_i|), the
    cost within 1e-5. Rows that are invalid hold NaN in J and must not
    poison H; rows with an invalid neighbour or not contributing add
    nothing; a tile with no valid row is skipped. V = 9, 16 and 20 run in
    the next width up with zero columns; 24 is a rig's width under a model
    of 12 intrinsics; blocks per image 1 to 3 take the records' fixed-order
    sum."""
    from dataset_pipeline_tpu_torch.ops import hb_gram
    from dataset_pipeline_tpu_torch.ops.robust import DEFAULT_COLOR_HUBER, huber_weight

    J, inten, ok, nbr, desc, contrib = _gram_inputs(V, K, nbr_per_image, desc_per_image,
                                                    skipped_tile)
    H, b, cost, n = _gram_emulated(emu, J, inten, ok, nbr, desc, contrib, blocks)
    Hp, bp, cp, n_p = hb_gram.gram_assemble_plain(J.double(), inten, ok, nbr, desc, contrib)
    r, all_ok = hb_gram.descriptor_residuals(inten, ok, nbr, desc, contrib)
    assert int(n) == int(n_p) == int(all_ok.sum()) and 0.1 < float(all_ok.float().mean()) < 0.6
    if skipped_tile:
        assert not bool(all_ok[0, 256:512].any())
    assert bool(torch.isfinite(H).all() and torch.isfinite(b).all()) and torch.equal(H, H.mT)
    d = torch.diagonal(Hp, dim1=1, dim2=2)
    assert bool((d > 0).all())
    H_gap = ((H.double() - Hp).abs() / torch.sqrt(d[:, :, None] * d[:, None, :])).max()
    # S per image from the plain version's residuals: b_i <= sqrt(H_ii S) by Cauchy-Schwarz
    norm = torch.sqrt(torch.clamp((r.double() ** 2).sum(-1), min=1e-20))
    w = torch.where(all_ok, huber_weight(norm, DEFAULT_COLOR_HUBER), torch.zeros(()))
    S = (w * norm ** 2).sum(1)
    b_gap = ((b.double() - bp).abs() / torch.sqrt(d * S[:, None])).max()
    assert float(H_gap) < 1e-5 and float(b_gap) < 1e-5, (float(H_gap), float(b_gap))
    assert 0.3 < float((norm[all_ok] <= DEFAULT_COLOR_HUBER).double().mean()) < 0.9
    np.testing.assert_allclose(float(cost), float(cp), rtol=1e-5)
    Hj, bj, cj, nj = _gram_jax(J, inten, ok, nbr, desc, contrib)
    assert nj == int(n)
    H_gap = ((H.double() - Hj.double()).abs() / torch.sqrt(d[:, :, None] * d[:, None, :])).max()
    b_gap = ((b.double() - bj.double()).abs() / torch.sqrt(d * S[:, None])).max()
    assert float(H_gap) < 1e-5 and float(b_gap) < 1e-5, (float(H_gap), float(b_gap))
    np.testing.assert_allclose(float(cost), cj, rtol=1e-5)


def test_hb_gram_kernel_emulated_is_deterministic_and_takes_no_rows(emu):
    """Two launches on the same inputs give the same bits; with M = 0 the
    outputs are zero."""
    args = _gram_inputs(10, 5, False, False, False)
    first = _gram_emulated(emu, *args, 2)
    for a, c in zip(first, _gram_emulated(emu, *args, 2)):
        assert torch.equal(a, c)
    empty = [x[:, :0] if x.dim() > 1 and x.shape[0] == 2 else x[:0] for x in args]
    H, b, cost, n = _gram_emulated(emu, *empty, 1)
    assert H.shape == (2, 10, 10) and not bool(H.any() or b.any()) and float(cost) == 0 and int(n) == 0


def test_hb_gram_entry_points_reject_bad_arguments(emu):
    z = torch.zeros(64)
    d = z.data_ptr()
    good = dict(V=10, M=4, nb=1, K=5, G=1)

    def call(**kw):
        a = dict(good, **kw)
        return emu.dpt_hb_gram(d, a["V"], d, d, d, 0, d, 0, d, a["M"], a["nb"], a["K"], a["G"],
                               47.4, 23.7, d, d, d, d, d, None)

    for bad in (dict(V=0), dict(V=25), dict(nb=0), dict(K=0), dict(M=-1), dict(G=0),
                dict(G=65536), dict(M=2**31 // 10 + 1), dict(V=24, M=2**31 // 24 + 1),
                dict(M=2**31 // 40 + 1, K=40)):
        assert call(**bad) != 0, bad
    assert emu.dpt_hb_gram_record(25) == 0 and emu.dpt_hb_gram_record(0) == 0
    assert emu.dpt_hb_gram_grid(25) == 0 and emu.dpt_hb_gram_grid(10) == 2  # 2 SMs x 1
    assert emu.dpt_hb_gram_grid(24) == 2
    assert emu.dpt_hb_gram_record(6) < emu.dpt_hb_gram_record(9) == emu.dpt_hb_gram_record(10)
    assert emu.dpt_hb_gram_record(18) < emu.dpt_hb_gram_record(19) == emu.dpt_hb_gram_record(24)
