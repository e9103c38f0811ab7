"""Port vs JAX: the seven gather kernels' plain versions (E1-E7).

``experiments/gather_probe.py`` and ``gather_probe2.py`` run everything at
import, so they cannot be imported. Only their definitions are loaded: each
file is parsed with ``ast``, the named functions and constants are kept and
executed in a namespace whose ``pl.pallas_call`` runs in interpret mode. The
same seeded numpy inputs then go through the interpreted Pallas kernel and the
port's plain version (what a CPU tensor runs through the wrapper):

- E1-E4 are pure moves: exactly equal, at the probes' shapes, at random
  indices and over a batch of tiles;
- E5 within 1e-6 of both lane modes on N(0,1) tiles (the Pallas kernel blends
  whole rows before it picks lanes: another association);
- E6, E7 within 2e-6 on N(0,1) rows, for the same reason.
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dataset_pipeline_tpu_torch.ops import gather

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
E5_ATOL = 1e-6
E67_ATOL = 2e-6


def load_definitions(path: Path, functions, constants):
    """The named top-level functions and constant assignments of a script,
    executed without the rest of it, with Pallas in interpret mode."""
    keep = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name in functions:
            keep.append(node)
        elif isinstance(node, ast.Assign) and any(
                isinstance(n, ast.Name) and n.id in constants
                for t in node.targets for n in ast.walk(t)):
            keep.append(node)
    found = {n.name for n in keep if isinstance(n, ast.FunctionDef)}
    assert found == set(functions), set(functions) - found
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = {"jax": jax, "jnp": jnp, "np": np, "lax": lax, "pl": shim, "pltpu": pltpu,
          "partial": functools.partial}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    return types.SimpleNamespace(**ns)


@pytest.fixture(scope="module")
def probe1():
    return load_definitions(
        REPO / "experiments" / "gather_probe.py",
        {"_onehot", "_tile_gather_kernel", "tile_gather", "ref_bilinear",
         "p_take_along_lanes_full", "p_take_along_sublanes", "p_jnp_take_rows", "p_advanced_2d"},
        {"TH", "TW", "CAP"})


@pytest.fixture(scope="module")
def probe2():
    return load_definitions(
        REPO / "experiments" / "gather_probe2.py",
        {"_extract_kernel", "pallas_extract", "_extract_packed_kernel", "pallas_extract_packed"},
        {"CH"})


def _vmem(n):
    return [pl.BlockSpec(memory_space=pltpu.VMEM)] * n


def _pallas(body, out_shape, *args):
    """One whole-array Pallas call in interpret mode, as the probes make it."""
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32), in_specs=_vmem(len(args)),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(*map(jnp.asarray, args)))


@pytest.mark.parametrize("name", ["p_take_along_lanes_full", "p_take_along_sublanes",
                                  "p_jnp_take_rows", "p_advanced_2d"])
def test_jax_probes_pass_their_own_value_checks_interpreted(probe1, name):
    assert getattr(probe1, name)() == "values ok"


# the one-statement bodies of the four P1 probes, as experiments/gather_probe.py writes them
def _k_lanes(rows_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(rows_ref[:], idx_ref[:], axis=1)


def _k_sublanes(rows_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(rows_ref[:], idx_ref[:], axis=0)


def _k_rows(tbl_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take(tbl_ref[:], idx_ref[0, :], axis=0)


def _k_adv(tile_ref, iy_ref, ix_ref, out_ref):
    out_ref[:] = tile_ref[iy_ref[:], ix_ref[:]]


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_e1_take_along_lanes_equals_pallas(kind):
    rng = np.random.RandomState(1)
    if kind == "probe":
        rows = np.arange(64 * 128, dtype=np.float32).reshape(1, 64, 128)
        idx = np.broadcast_to(np.arange(128, dtype=np.int32)[::-1], (1, 64, 128)).copy()
    else:
        rows = rng.randn(3, 64, 128).astype(np.float32)
        idx = rng.randint(0, 128, (3, 64, 128)).astype(np.int32)
    got = gather.take_along_lanes(torch.from_numpy(rows), torch.from_numpy(idx)).numpy()
    for b in range(len(rows)):
        np.testing.assert_array_equal(got[b], _pallas(_k_lanes, (64, 128), rows[b], idx[b]))


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_e2_take_along_sublanes_equals_pallas(kind):
    rng = np.random.RandomState(2)
    if kind == "probe":
        rows = np.arange(64 * 128, dtype=np.float32).reshape(1, 64, 128)
        idx = np.broadcast_to(np.arange(8, dtype=np.int32)[:, None] * 7, (1, 8, 128)).copy()
    else:
        rows = rng.randn(3, 64, 128).astype(np.float32)
        idx = rng.randint(0, 64, (3, 8, 128)).astype(np.int32)
    got = gather.take_along_sublanes(torch.from_numpy(rows), torch.from_numpy(idx)).numpy()
    for b in range(len(rows)):
        np.testing.assert_array_equal(got[b], _pallas(_k_sublanes, (8, 128), rows[b], idx[b]))


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_e3_take_rows_equals_pallas(kind):
    rng = np.random.RandomState(0)
    if kind == "probe":
        table = np.arange(256 * 128, dtype=np.float32).reshape(1, 256, 128)
        idx = rng.randint(0, 256, (1, 64)).astype(np.int32)
    else:
        table = rng.randn(2, 256, 128).astype(np.float32)
        idx = rng.randint(0, 256, (2, 64)).astype(np.int32)
    got = gather.take_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    for b in range(len(table)):
        np.testing.assert_array_equal(got[b], _pallas(_k_rows, (64, 128), table[b], idx[b:b + 1]))


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_e4_advanced_2d_equals_pallas(kind):
    rng = np.random.RandomState(0)
    B = 1 if kind == "probe" else 3
    tiles = (np.arange(64 * 128, dtype=np.float32).reshape(1, 64, 128) if kind == "probe"
             else rng.randn(B, 64, 128).astype(np.float32))
    iy = rng.randint(0, 64, (B, 8, 128)).astype(np.int32)
    ix = rng.randint(0, 128, (B, 8, 128)).astype(np.int32)
    got = gather.advanced_2d(*map(torch.from_numpy, (tiles, iy, ix))).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[b], _pallas(_k_adv, (8, 128), tiles[b], iy[b], ix[b]))


@pytest.mark.parametrize("lane_mode", ["take", "onehot"])
def test_e5_tile_gather_matches_pallas_and_ref_bilinear(probe1, lane_mode):
    rng = np.random.RandomState(5)
    n_tiles, TH, TW, CAP = 6, probe1.TH, probe1.TW, probe1.CAP
    tiles = rng.randn(n_tiles, TH, TW).astype(np.float32)
    iy = rng.randint(0, TH - 1, (n_tiles, CAP)).astype(np.int32)
    ix = rng.randint(0, TW - 1, (n_tiles, CAP)).astype(np.int32)
    fy, fx = (rng.rand(n_tiles, CAP).astype(np.float32) for _ in range(2))
    ref = np.asarray(probe1.tile_gather(*map(jnp.asarray, (tiles, iy, ix, fy, fx)), lane_mode, n_tiles))
    got = gather.tile_gather(*map(torch.from_numpy, (tiles, iy, ix, fy, fx))).numpy()
    assert got.shape == ref.shape == (n_tiles, 4, CAP)
    gap = np.abs(got - ref).max()
    print(f"E5 {lane_mode}: max gap {gap:.3e}")  # measured 4.8e-7
    np.testing.assert_allclose(got, ref, rtol=0, atol=E5_ATOL)
    assert not got[:, 3].any()
    for k, r in enumerate(probe1.ref_bilinear(tiles, iy, ix, fy, fx)):
        np.testing.assert_allclose(got[:, k], r, rtol=0, atol=E5_ATOL)


def _extract_inputs(n, seed, lane_hi):
    rng = np.random.RandomState(seed)
    rows = [rng.randn(n, 128).astype(np.float32) for _ in range(2)]
    lanes = [rng.randint(0, lane_hi, (n, 1)).astype(np.int32) for _ in range(2)]
    fr = [rng.rand(n, 1).astype(np.float32) for _ in range(5)]
    return rows, lanes, fr


def test_e6_row_extract_matches_pallas(probe2):
    n = probe2.CH  # one grid step of the TPU kernel
    (r0, r1), (lane, _), (fx, fy, *_) = _extract_inputs(n, 6, 127)
    lane[:4, 0] = (0, 126, 7, 8)  # both ends, and across a 32-byte sector
    ref = np.asarray(probe2.pallas_extract(*map(jnp.asarray, (r0, r1, lane, fx, fy))))
    got = gather.row_extract(*map(torch.from_numpy, (r0, r1, lane, fx, fy))).numpy()
    assert got.shape == ref.shape == (n, 8)
    print(f"E6: max gap {np.abs(got - ref).max():.3e}")  # measured 2.4e-7
    np.testing.assert_allclose(got, ref, rtol=0, atol=E67_ATOL)
    assert not got[:, 3:].any()


def test_e7_row_extract_packed_matches_pallas(probe2):
    n = probe2.CH
    (ra, rb), (la, lb), (fxa, fya, fxb, fyb, zf) = _extract_inputs(n, 7, 95)
    la[:2, 0], lb[:2, 0] = (0, 94), (94, 0)
    args = (ra, rb, la, lb, fxa, fya, fxb, fyb, zf)
    ref = np.asarray(probe2.pallas_extract_packed(*map(jnp.asarray, args)))
    got = gather.row_extract_packed(*map(torch.from_numpy, args)).numpy()
    assert got.shape == ref.shape == (n, 8)
    print(f"E7: max gap {np.abs(got - ref).max():.3e}")  # measured 4.8e-7
    np.testing.assert_allclose(got, ref, rtol=0, atol=E67_ATOL)
    assert not got[:, 4:].any()
    assert np.isfinite(got).all()
    # float64 through the same plain version: the float32 result is its rounding
    got64 = gather.row_extract_packed(*[torch.from_numpy(a).double() if a.dtype == np.float32
                                        else torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, got64, rtol=0, atol=E67_ATOL)


def test_wrappers_reject_bad_arguments():
    rows = torch.zeros(2, 64, 128)
    idx = torch.zeros(2, 64, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        gather.take_along_lanes(torch.zeros(1, 65, 128), torch.zeros(1, 65, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        gather.take_along_lanes(rows, idx[:, :8])
    with pytest.raises(ValueError, match=r"\[0, 127\]"):
        gather.take_along_lanes(rows, idx + 128)
    with pytest.raises(ValueError, match=r"\[0, 63\]"):
        gather.take_along_sublanes(rows, idx[:, :8] - 1)
    with pytest.raises(ValueError, match="int32 or int64"):
        gather.take_along_sublanes(rows, idx[:, :8].float())
    with pytest.raises(ValueError, match="multiple of 4"):
        gather.take_rows(torch.zeros(1, 8, 6), torch.zeros(1, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[0, 7\]"):
        gather.take_rows(torch.zeros(1, 8, 8), torch.full((1, 3), 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="ix"):
        gather.advanced_2d(rows, idx[:, :8], idx[:, :8] + 128)
    tiles = torch.zeros(3, 8, 128)
    task_i, task_f = torch.zeros(3, 16, dtype=torch.int32), torch.zeros(3, 16)
    with pytest.raises(ValueError, match=r"iy must lie in \[0, 6\]"):
        gather.tile_gather(tiles, task_i + 7, task_i, task_f, task_f)
    with pytest.raises(ValueError, match=r"ix must lie in \[0, 126\]"):
        gather.tile_gather(tiles, task_i, task_i + 127, task_f, task_f)
    r, col_i, col_f = torch.zeros(5, 128), torch.zeros(5, 1, dtype=torch.int32), torch.zeros(5, 1)
    with pytest.raises(ValueError, match=r"lane must lie in \[0, 126\]"):
        gather.row_extract(r, r, col_i + 127, col_f, col_f)
    with pytest.raises(ValueError, match="shape"):
        gather.row_extract(r, r, col_i[:, 0], col_f, col_f)
    with pytest.raises(ValueError, match=r"lb must lie in \[0, 94\]"):
        gather.row_extract_packed(r, r, col_i, col_i + 95, *[col_f] * 5)
    with pytest.raises(ValueError, match="unsupported device"):
        gather.row_extract(*[t.to("meta") for t in (r, r, col_i, col_f, col_f)], check_ranges=False)
    # empty inputs are fine and skip the range check
    assert gather.row_extract(r[:0], r[:0], col_i[:0], col_f[:0], col_f[:0]).shape == (0, 8)


def test_cpu_calls_count_no_launch():
    from dataset_pipeline_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    gather.take_along_lanes(torch.zeros(1, 8, 128), torch.zeros(1, 8, 128, dtype=torch.int32))
    gather.row_extract(torch.zeros(4, 128), torch.zeros(4, 128), torch.zeros(4, 1, dtype=torch.int32),
                       torch.zeros(4, 1), torch.zeros(4, 1))
    assert kernels.LAUNCHES == before
    assert {"take_along_lanes", "take_along_sublanes", "take_rows", "advanced_2d", "tile_gather",
            "row_extract", "row_extract_packed"} <= set(kernels.LAUNCHES)
    assert len(kernels.KERNELS) == 17
    for name in ("take_along_lanes", "take_along_sublanes", "take_rows", "advanced_2d"):
        assert kernels.KERNELS[name].source == "gather_probes.cu"
