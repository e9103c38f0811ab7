"""Port vs JAX: the earlier kernel generations and the timing harnesses
(``ops/gn.py``: B4a, B4b, B4c, B5a; ``ops/hbm.py``: B5b).

Each runs here as its plain PyTorch version, which the wrappers take for CPU
tensors, against the JAX package's Pallas kernel in interpret mode on the
same seeded inputs. The CUDA kernels are compared with the plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``) and, for their
indexing, under the host emulation (``tests/test_torch_kernels_emulated.py``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.icp import moments as jm
from dataset_pipeline_tpu.ops import pallas_gn as jp
from dataset_pipeline_tpu_torch import kernels
from dataset_pipeline_tpu_torch.icp import moments as tm
from dataset_pipeline_tpu_torch.ops import gn, hbm

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _rows_problem(case):
    """The inputs of ``tests/test_icp.py``'s two Pallas tests: 1024 rows,
    identity rotations, weights in {0, 1}; and 5000 rows, random poses,
    random weights. C = 3, ids changing from row to row."""
    if case == "binary_w":
        m, C, chunk = 1024, 3, 256
        rng = np.random.RandomState(2)
        ps = rng.randn(m, 3).astype(np.float32)
        ns = rng.randn(m, 3).astype(np.float32)
        ns /= np.linalg.norm(ns, axis=1, keepdims=True)
        pt = ps + np.float32(0.01) * rng.randn(m, 3).astype(np.float32)
        nt = ns
        sid = rng.randint(0, 3, m).astype(np.int32)
        tid = ((sid + 1) % 3).astype(np.int32)
        w = (rng.rand(m) > 0.1).astype(np.float32)
        q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (3, 1))
        t = rng.randn(3, 3).astype(np.float32) * 0.01
    else:
        m, C, chunk = 5000, 3, 1024
        rng = np.random.RandomState(0)
        ps = rng.randn(m, 3).astype(np.float32)
        ns = rng.randn(m, 3).astype(np.float32)
        ns /= np.linalg.norm(ns, axis=1, keepdims=True)
        pt = ps + 0.01 * rng.randn(m, 3).astype(np.float32)
        nt = ns + 0.05 * rng.randn(m, 3).astype(np.float32)
        nt /= np.linalg.norm(nt, axis=1, keepdims=True)
        sid = rng.randint(0, C, m).astype(np.int32)
        tid = ((sid + 1) % C).astype(np.int32)
        w = rng.rand(m).astype(np.float32)
        ax = rng.randn(C, 3) * 0.1
        q = np.stack([
            np.concatenate([[np.cos(np.linalg.norm(a) / 2)],
                            np.sin(np.linalg.norm(a) / 2) * a / max(np.linalg.norm(a), 1e-9)])
            for a in ax]).astype(np.float32)
        t = (rng.randn(C, 3) * 0.2).astype(np.float32)
    return (q, t, ps, ns, pt, nt, sid, tid, w), C, chunk


@pytest.mark.parametrize("case", ["binary_w", "random_w"])
def test_b4a_plain_matches_pallas_interpret(case):
    args, C, chunk = _rows_problem(case)
    Hj, bj, cj = jp.icp_hb_cost_pallas(*[jnp.asarray(a) for a in args], num_clouds=C,
                                       chunk=chunk, interpret=True)
    H, b, c = gn.icp_hb_cost_rows(*[torch.from_numpy(a) for a in args], C)
    assert H.dtype == torch.float64 and H.shape == (6 * C, 6 * C) and b.shape == (6 * C,)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(c), float(cj), rtol=1e-5)


@pytest.mark.parametrize("case", ["binary_w", "random_w"])
def test_b4a_one_unknown_id_matches_pallas_interpret(case):
    """Rows with exactly one id outside [0, C) (sid = 7, tid = 0 and sid = 0,
    tid = -1) add to H and b at the other id's block in the JAX kernel as
    here; the prep poses an unknown id as JAX's gather does."""
    args, C, chunk = _rows_problem(case)
    sid, tid = args[6].copy(), args[7].copy()
    sid[::5], tid[::5] = 7, 0
    sid[1::5], tid[1::5] = 0, -1
    args = (*args[:6], sid, tid, args[8])
    Hj, bj, cj = jp.icp_hb_cost_pallas(*[jnp.asarray(a) for a in args], num_clouds=C,
                                       chunk=chunk, interpret=True)
    H, b, c = gn.icp_hb_cost_rows(*[torch.from_numpy(a) for a in args], C)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(c), float(cj), rtol=1e-5)
    bs, bt = sid.copy(), tid.copy()  # the same rows with both ids unknown add to the cost only
    bs[::5], bt[::5], bs[1::5], bt[1::5] = 7, 7, -1, -1
    H0 = gn.icp_hb_cost_rows(*[torch.from_numpy(a) for a in (*args[:6], bs, bt, args[8])], C)[0]
    assert not np.allclose(H.numpy(), H0.numpy(), rtol=1e-3, atol=1e-2)


def test_b4a_rows_with_equal_or_unknown_ids_add_to_the_cost_only():
    """As the JAX kernel's one-hot difference: ``sid == tid`` cancels, an id
    outside [0, C) matches no block (a padding row is ``sid=0, tid=1, w=0``)."""
    (q, t, ps, ns, pt, nt, sid, tid, w), C, _ = _rows_problem("random_w")
    targs = [torch.from_numpy(a) for a in (q, t, ps, ns, pt, nt)]
    j1, j2, r1, r2 = gn.gn_rows_prep(*targs, torch.from_numpy(sid), torch.from_numpy(tid))
    wt = torch.from_numpy(w)
    odd = sid.copy()
    odd[::2] = 7
    H, b, c = gn.gn_rows(j1, j2, r1, r2, torch.from_numpy(odd), torch.from_numpy(odd), wt, C)
    assert not H.any() and not b.any()
    np.testing.assert_allclose(float(c), float((wt * (r1 * r1 + r2 * r2)).double().sum()), rtol=1e-6)


def _groups(rng, sizes):
    groups = []
    for m in sizes:
        g = {k: rng.randn(m, 3).astype(np.float32) for k in ("ps", "ns", "pt", "nt")}
        g["w"] = rng.rand(m).astype(np.float32)
        groups.append(g)
    return groups


def _assert_gram(got, ref):
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def _gram_xla(g):
    return np.asarray(jm.moment_gram_xla(*[jnp.asarray(g[k]) for k in ("ps", "ns", "pt", "nt", "w")]),
                      np.float64)


def test_b4b_plain_matches_pallas_interpret():
    groups = _groups(np.random.RandomState(3), [100, 100])
    chunk = 128
    data, gid = jm.pack_group_data(groups, chunk=chunk)
    ref = np.asarray(jp.icp_moment_pallas(jnp.asarray(data), chunk=chunk, interpret=True),
                     np.float64)
    got = gn.moment_gram48(torch.from_numpy(data), chunk)
    assert got.shape == ref.shape == (len(gid), 48, 48)
    assert not got[:, 42:].any() and not got[:, :, 42:].any()
    got = got.double().numpy()
    for k in range(len(gid)):
        _assert_gram(got[k], ref[k])
    for gi, g in enumerate(groups):
        _assert_gram(got[gid == gi, :42, :42].sum(0), _gram_xla(g))


@pytest.mark.parametrize("rows", [13, 16])
def test_b4c_plain_matches_pallas_tri_interpret(rows):
    g = _groups(np.random.RandomState(5), [2000])[0]
    chunk = 3 * 128 * 2
    data, _ = jm.pack_group_data([g], chunk=chunk, rows=rows)
    ref = np.asarray(jp.icp_moment_pallas_tri(jnp.asarray(data), chunk=chunk, interpret=True),
                     np.float64)
    got = gn.moment_gram_thirds(torch.from_numpy(data), chunk)
    assert got.shape == (len(ref), 3, 42, 42)
    for k in range(3):  # per diagonal block of the (128, 128) MXU tile
        _assert_gram(got[:, k].double().numpy(), ref[:, 42 * k:42 * k + 42, 42 * k:42 * k + 42])
    _assert_gram(gn.moment_tri_extract(got.double().numpy()), jp.moment_tri_extract(ref))
    _assert_gram(gn.moment_tri_extract(got.double()).sum(0).numpy(), _gram_xla(g))


@pytest.mark.parametrize("repeats", [1, 4, 5])
def test_b5a_plain_matches_alternating_pallas_sum(repeats):
    """``icp_moment_pallas_tri_sub_timed`` has no ``interpret`` argument, so
    it cannot run on the CPU; what it computes is the sum over repeats of
    ``icp_moment_pallas_tri_sub`` on copy ``r % 2``, which can."""
    chunk = 768
    rng = np.random.RandomState(6)
    copies = [jm.pack_group_data(_groups(rng, [900, 400]), chunk=chunk, rows=13)[0]
              for _ in range(2)]
    per_copy = [np.asarray(jp.moment_tri_extract(np.asarray(jp.icp_moment_pallas_tri_sub(
        jnp.asarray(c), chunk=chunk, sub=128, interpret=True), np.float64))) for c in copies]
    ref = sum(per_copy[r % 2] for r in range(repeats))
    got, per_chunk = gn.moment_gram_repeat(torch.from_numpy(np.stack(copies)), chunk, repeats)
    assert per_chunk == 1
    _assert_gram(got.double().numpy(), ref)


@pytest.mark.parametrize("repeats", [1, 3])
def test_b5b_plain_matches_numpy_sum(repeats):
    d = np.random.RandomState(0).randn(2, 8, 4096).astype(np.float32)
    ref = sum(d[r % 2].astype(np.float64).sum(1) for r in range(repeats))
    got = hbm.hbm_read_sum(torch.from_numpy(d), repeats)
    assert got.shape == (8,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(d).sum(2).max())
    got64 = hbm.hbm_read_sum(torch.from_numpy(d).double(), repeats)
    np.testing.assert_allclose(got64.numpy(), ref, rtol=1e-12, atol=1e-9)


def test_cpu_wrappers_take_the_plain_versions_without_counting():
    rng = np.random.RandomState(40)
    data = tm.pack_group_data(_groups(rng, [700]), chunk=384, rows=13, device="cpu")[0]
    args, C, _ = _rows_problem("binary_w")
    rows = gn.gn_rows_prep(*[torch.from_numpy(a) for a in args[:8]])
    ids = [torch.from_numpy(a) for a in args[6:8]]
    before = dict(kernels.LAUNCHES)
    for a, b in ((gn.moment_gram48(data, 384), gn.moment_gram48_plain(data, 384)),
                 (gn.moment_gram_thirds(data, 384), gn.moment_gram_thirds_plain(data, 384)),
                 (gn.moment_gram_repeat(torch.stack([data, data]), 384, 3)[0],
                  gn.moment_gram_repeat_plain(torch.stack([data, data]), 384, 3)),
                 (hbm.hbm_read_sum(data[None, :8].repeat(2, 1, 1), 2),
                  hbm.hbm_read_sum_plain(data[None, :8].repeat(2, 1, 1), 2)),
                 *zip(gn.gn_rows(*rows, *ids, torch.from_numpy(args[8]), C),
                      gn.gn_rows_plain(*rows, *ids, torch.from_numpy(args[8]), C))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert kernels.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    data = torch.zeros((13, 768))
    with pytest.raises(ValueError):
        gn.moment_gram48(data, 500)  # Mp not a chunk multiple
    with pytest.raises(ValueError):
        gn.moment_gram_thirds(data, 256)  # chunk not a multiple of 3
    with pytest.raises(ValueError):
        gn.moment_gram_thirds(data.to("meta"), 384)  # neither CPU nor CUDA: no fallback
    with pytest.raises(ValueError):
        gn.moment_gram_repeat(data, 256, 1)  # not (2, rows, Mp)
    with pytest.raises(ValueError):
        gn.moment_gram_repeat(torch.zeros((2, 13, 768)), 256, 0)  # no repeat
    with pytest.raises(ValueError):
        hbm.hbm_read_sum(torch.zeros((2, 7, 64)), 1)  # 8 rows
    with pytest.raises(ValueError):
        hbm.hbm_read_sum(torch.zeros((2, 8, 64), device="meta"), 1)
    j = torch.zeros((6, 10))
    r = torch.zeros(10)
    i = torch.zeros(10, dtype=torch.int32)
    gn.gn_rows(j, j, r, r, i, i, r, 2)
    with pytest.raises(ValueError):
        gn.gn_rows(torch.zeros((8, 10)), j, r, r, i, i, r, 2)  # the 6 -> 8 padding is not taken
    with pytest.raises(ValueError):
        gn.gn_rows(j, j, r, r, i.long(), i, r, 2)  # id dtype
    with pytest.raises(ValueError):
        gn.gn_rows(j, j, r, r[:9], i, i, r, 2)  # lengths differ
    with pytest.raises(ValueError):
        gn.gn_rows(j.to("meta"), j.to("meta"), *[x.to("meta") for x in (r, r, i, i, r)], 2)


def test_kernel_table_names_sources_and_the_kernels_replaced():
    """One table drives the bindings, the counters and the smoke's report:
    every row's source exists, its ``replaces`` points at a ``def`` of the
    JAX kernel, and the counters are exactly the rows' counters."""
    assert len(kernels.KERNELS) == 17
    counters = [c for k in kernels.KERNELS.values() for c in k.counters]
    assert sorted(counters) == sorted(kernels.LAUNCHES) and len(set(counters)) == len(counters)
    for name, k in kernels.KERNELS.items():
        src = (kernels.CSRC / k.source).read_text()
        assert f"int {k.entry}(" in src and 'extern "C"' in src, name
        path, line = k.replaces.split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert text.lstrip().startswith("def "), (name, text)
        assert Path(path).name in src, f"{k.source} does not name the kernel it replaces"
