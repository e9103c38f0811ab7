"""Port vs JAX: the ICP Gauss-Newton kernels' plain versions (``ops/gn.py``).

B1 (fused H, b, cost) and B2 (monomial moment Gram) run here as their plain
PyTorch versions, which the wrappers take for CPU tensors, against the JAX
package's Pallas kernels in interpret mode on the same packed inputs. The
CUDA kernels themselves are compared with the plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.icp import moments as jm
from dataset_pipeline_tpu.icp.point_to_plane import _icp_cost as j_icp_cost
from dataset_pipeline_tpu.icp.point_to_plane import _icp_cost_batch as j_icp_cost_batch
from dataset_pipeline_tpu.icp.point_to_plane import _icp_hb_cost as j_icp_hb_cost
from dataset_pipeline_tpu.ops import pallas_gn as jp
from dataset_pipeline_tpu_torch.icp import moments as tm
from dataset_pipeline_tpu_torch.icp import point_to_plane as tpp
from dataset_pipeline_tpu_torch.ops import gn

torch.set_num_threads(2)


def _groups(rng, C, sizes):
    groups, pairs = [], []
    k = 0
    for s in range(C):
        for tg in range(C):
            if s == tg:
                continue
            m = sizes[k % len(sizes)]
            k += 1
            ps = rng.randn(m, 3).astype(np.float32)
            ns = rng.randn(m, 3).astype(np.float32)
            ns /= np.linalg.norm(ns, axis=1, keepdims=True)
            pt = (ps + 0.05 * rng.randn(m, 3)).astype(np.float32)
            nt = rng.randn(m, 3).astype(np.float32)
            nt /= np.linalg.norm(nt, axis=1, keepdims=True)
            groups.append({"ps": ps, "ns": ns, "pt": pt, "nt": nt,
                           "w": rng.rand(m).astype(np.float32)})
            pairs.append((s, tg))
    return groups, pairs


def _poses(rng, C):
    qt = [tm.se3_exp_np(0.3 * rng.randn(6)) for _ in range(C)]
    return (np.stack([a for a, _ in qt]).astype(np.float32),
            np.stack([b for _, b in qt]).astype(np.float32))


def test_pack_icp_inputs_layout():
    rng = np.random.RandomState(0)
    ps, ns, pt, nt = (rng.randn(700, 3).astype(np.float32) for _ in range(4))
    w = rng.rand(700).astype(np.float32)
    ref = jp.pack_icp_inputs(*[jnp.asarray(x) for x in (ps, ns, pt, nt, w)], chunk=256)
    got = gn.pack_icp_inputs(*[torch.from_numpy(x) for x in (ps, ns, pt, nt, w)], chunk=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("rows", [13, 16])
def test_pack_group_data_layout(rows):
    groups, _ = _groups(np.random.RandomState(1), 3, [100, 257, 40])
    ref, ref_gid = jm.pack_group_data(groups, chunk=128, rows=rows)
    got, gid = tm.pack_group_data(groups, chunk=128, rows=rows, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(gid, ref_gid)


@pytest.mark.parametrize("C", [2, 3])
def test_b1_plain_matches_pallas_fused_interpret(C):
    rng = np.random.RandomState(10 + C)
    groups, pairs = _groups(rng, C, [300, 520, 130])
    chunk = 256
    data16, gid = jm.pack_group_data(groups, chunk=chunk)
    pair_rows = np.repeat(np.asarray(pairs, np.int32)[gid], chunk, axis=0)
    q, t = _poses(rng, C)
    Hj, bj, cj = jp.icp_hb_cost_pallas_fused(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(data16), jnp.asarray(pair_rows[:, 0]),
        jnp.asarray(pair_rows[:, 1]), num_clouds=C, chunk=chunk, interpret=True)
    data, _ = tm.pack_group_data(groups, chunk=chunk, rows=13, device="cpu")
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid])
    H, b, c = gn.icp_hb_cost_fused(torch.from_numpy(q), torch.from_numpy(t), data, cp, C, chunk)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(float(c), float(cj), rtol=1e-5)


def test_b1_plain_matches_direct_accumulation():
    """The packed per-pair form equals the one-hot row form of
    ``_icp_hb_cost`` (JAX and port) on the same correspondences."""
    rng = np.random.RandomState(20)
    C = 3
    groups, pairs = _groups(rng, C, [211, 95])
    q, t = _poses(rng, C)
    flat = {k: np.concatenate([g[k] for g in groups]) for k in ("ps", "ns", "pt", "nt", "w")}
    sid = np.concatenate([np.full(len(g["ps"]), s, np.int32) for g, (s, _) in zip(groups, pairs)])
    tid = np.concatenate([np.full(len(g["ps"]), tg, np.int32) for g, (_, tg) in zip(groups, pairs)])
    args = [flat["ps"], flat["ns"], flat["pt"], flat["nt"], sid, tid, flat["w"]]
    Hj, bj, cj = j_icp_hb_cost(jnp.asarray(q), jnp.asarray(t), *[jnp.asarray(a) for a in args], C)
    Ht, bt, ct = tpp._icp_hb_cost(torch.from_numpy(q), torch.from_numpy(t),
                                  *[torch.from_numpy(a) for a in args], C, chunk=128)
    data, gid = tm.pack_group_data(groups, chunk=256, rows=13, device="cpu")
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid])
    H, b, c = gn.gn_fused_plain(torch.from_numpy(q), torch.from_numpy(t), data, cp, C, 256)
    for got in ((Ht, bt, ct), (H, b, c)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(Hj), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(bj), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(float(got[2]), float(cj), rtol=1e-5)
    # cost-only forms, one pose set and a batch of candidates
    np.testing.assert_allclose(
        float(tpp._icp_cost(torch.from_numpy(q), torch.from_numpy(t),
                            *[torch.from_numpy(a) for a in args])),
        float(j_icp_cost(jnp.asarray(q), jnp.asarray(t), *[jnp.asarray(a) for a in args])),
        rtol=1e-5)
    qs = np.stack([q, _poses(rng, C)[0]])
    ts = np.stack([t, _poses(rng, C)[1]])
    np.testing.assert_allclose(
        tpp._icp_cost_batch(torch.from_numpy(qs), torch.from_numpy(ts),
                            *[torch.from_numpy(a) for a in args]).numpy(),
        np.asarray(j_icp_cost_batch(jnp.asarray(qs), jnp.asarray(ts),
                                    *[jnp.asarray(a) for a in args])),
        rtol=1e-5)


def test_b2_plain_matches_pallas_tri_sub_interpret():
    rng = np.random.RandomState(30)
    groups, _ = _groups(rng, 2, [900, 400])
    chunk = 768  # three 128-column sub-tiles per third, as the Pallas kernel needs
    data16, gid = jm.pack_group_data(groups, chunk=chunk)
    ref = np.asarray(jp.moment_tri_extract(np.asarray(jp.icp_moment_pallas_tri_sub(
        jnp.asarray(data16), chunk=chunk, sub=128, interpret=True), np.float64)))
    data, _ = tm.pack_group_data(groups, chunk=chunk, rows=13, device="cpu")
    parts, per_chunk = gn.moment_gram_partials(data, chunk)
    assert per_chunk == 1 and parts.shape == (len(gid), 42, 42)
    got = parts.double().numpy()
    for k in range(len(gid)):
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-5 * np.abs(ref[k]).max())
    for gi, g in enumerate(groups):
        P_ref = np.asarray(jm.moment_gram_xla(*[jnp.asarray(g[k]) for k in ("ps", "ns", "pt", "nt", "w")]),
                           np.float64)
        P = got[gid == gi].sum(0)
        np.testing.assert_allclose(P, P_ref, rtol=2e-5, atol=2e-5 * np.abs(P_ref).max())


def test_cpu_wrappers_take_the_plain_versions_without_counting():
    rng = np.random.RandomState(40)
    groups, pairs = _groups(rng, 2, [300])
    data, gid = tm.pack_group_data(groups, chunk=256, rows=13, device="cpu")
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid])
    q, t = (torch.from_numpy(x) for x in _poses(rng, 2))
    before = dict(gn.LAUNCHES)
    got = gn.icp_hb_cost_fused(q, t, data, cp, 2, 256)
    ref = gn.gn_fused_plain(q, t, data, cp, 2, 256)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(gn.moment_gram_partials(data, 256)[0].numpy(),
                                  gn.moment_gram_plain(data, 256).numpy())
    assert gn.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    data = torch.zeros((13, 512))
    cp = torch.zeros((2, 2), dtype=torch.int32)
    q, t = torch.tensor([[1.0, 0, 0, 0]] * 2), torch.zeros((2, 3))
    with pytest.raises(ValueError):
        gn.icp_hb_cost_fused(q, t, data.double(), cp, 2, 256)  # dtype
    with pytest.raises(ValueError):
        gn.icp_hb_cost_fused(q, t, data[:12], cp, 2, 256)  # too few rows
    with pytest.raises(ValueError):
        gn.icp_hb_cost_fused(q, t, data, cp, 2, 384)  # Mp not a chunk multiple
    with pytest.raises(ValueError):
        gn.icp_hb_cost_fused(q, t, data, cp.long(), 2, 256)  # pair dtype
    with pytest.raises(ValueError):
        gn.icp_hb_cost_fused(q, t, data.T.contiguous().T, cp, 2, 256)  # not contiguous
    with pytest.raises(ValueError):
        gn.moment_gram_partials(data.to("meta"), 256)  # neither CPU nor CUDA: no fallback
