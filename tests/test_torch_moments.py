"""Port vs JAX: the moment-matrix ICP formulation (``icp/moments.py``).

The host float64 copies must be BIT-equal to the JAX package's functions on
the same inputs; the torch monomials and the B2-backed group moments agree
with the JAX Gram within rtol 2e-5, atol 2e-5 * max|P|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.icp import moments as jm
from dataset_pipeline_tpu.icp.point_to_plane import _icp_hb_cost as j_icp_hb_cost
from dataset_pipeline_tpu_torch.icp import moments as tm
from dataset_pipeline_tpu_torch.ops import gn

torch.set_num_threads(2)


def _random_groups(rng, C=3, per_group=257):
    groups, pairs = [], []
    for s in range(C):
        for tg in range(C):
            if s == tg:
                continue
            ps = rng.randn(per_group, 3).astype(np.float32)
            ns = rng.randn(per_group, 3).astype(np.float32)
            ns /= np.linalg.norm(ns, axis=1, keepdims=True)
            pt = (ps + 0.05 * rng.randn(per_group, 3)).astype(np.float32)
            nt = rng.randn(per_group, 3).astype(np.float32)
            nt /= np.linalg.norm(nt, axis=1, keepdims=True)
            groups.append({"ps": ps, "ns": ns, "pt": pt, "nt": nt,
                           "w": rng.rand(per_group).astype(np.float32)})
            pairs.append((s, tg))
    return groups, pairs


def _random_poses(rng, C):
    qt = [jm.se3_exp_np(0.3 * rng.randn(6)) for _ in range(C)]
    return np.stack([a for a, _ in qt]), np.stack([b for _, b in qt])


def _P(groups):
    return [np.asarray(jm.moment_gram_xla(*[jnp.asarray(g[k]) for k in ("ps", "ns", "pt", "nt", "w")]),
                       np.float64) for g in groups]


def _bit_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-14, 0.0])
def test_se3_exp_np_and_quat_mul_np_bit_equal(scale):
    rng = np.random.RandomState(1)
    for _ in range(8):
        x = scale * rng.randn(6)
        _bit_equal(jm.se3_exp_np(x), tm.se3_exp_np(x))
        a, b = rng.randn(4), rng.randn(4)
        _bit_equal([jm.quat_mul_np(a, b)], [tm.quat_mul_np(a, b)])


def test_group_row_maps_and_hb_cost_from_moments_bit_equal():
    rng = np.random.RandomState(2)
    C = 3
    groups, pairs = _random_groups(rng, C, 60)
    P = _P(groups)
    q, t = _random_poses(rng, C)
    R = [jm._skew(t[0])] + [np.eye(3)]  # any f64 inputs will do for the row maps
    _bit_equal(jm.group_row_maps(R[0], t[1], R[1], t[2]), tm.group_row_maps(R[0], t[1], R[1], t[2]))
    _bit_equal(jm.hb_cost_from_moments(P, pairs, q, t, C), tm.hb_cost_from_moments(P, pairs, q, t, C))


@pytest.mark.parametrize("mode", ["sequential", "batched", "centered_basis_floors"])
def test_icp_lm_from_moments_bit_equal(mode):
    rng = np.random.RandomState(3)
    C = 3
    groups, pairs = _random_groups(rng, C, 301)
    P = _P(groups)
    kw = {}
    if mode != "sequential":
        def batch(mod):
            return lambda qs, ts: np.asarray([mod.hb_cost_from_moments(P, pairs, qs[k], ts[k], C)[2]
                                              for k in range(len(qs))])
        kw_j, kw_t = {"cost_batch_fn": batch(jm)}, {"cost_batch_fn": batch(tm)}
    else:
        kw_j, kw_t = {}, {}
    if mode == "centered_basis_floors":
        V = np.linalg.qr(rng.randn(6 * (C - 1), 6 * (C - 1)))[0][:, :9]
        kw = {"center": np.asarray([0.3, -0.2, 0.1]), "basis": V,
              "cost_floor_rel": 1e-4, "cost_floor_abs": 1e-9}
    ref = jm.icp_lm_from_moments(P, pairs, C, max_iterations=12, **kw, **kw_j)
    got = tm.icp_lm_from_moments(P, pairs, C, max_iterations=12, **kw, **kw_t)
    _bit_equal(ref[:2], got[:2])
    assert ref[2] == got[2]


def test_monomials_and_moment_gram():
    rng = np.random.RandomState(4)
    g = _random_groups(rng, 2, 500)[0][0]
    args = [g[k] for k in ("ps", "ns", "pt", "nt", "w")]
    np.testing.assert_allclose(tm.monomials(*[torch.from_numpy(a) for a in args]).numpy(),
                               np.asarray(jm.monomials_xla(*[jnp.asarray(a) for a in args])),
                               rtol=1e-6, atol=1e-6)
    P_ref = _P([g])[0]
    P = tm.moment_gram(*[torch.from_numpy(a) for a in args]).double().numpy()
    np.testing.assert_allclose(P, P_ref, rtol=2e-5, atol=2e-5 * np.abs(P_ref).max())


def _kron_gram(data, chunk):
    """The factored Gram the B2 kernels compute (csrc/moment_gram.cuh): the
    dense 28 x 21 product of u = vech(a a^T), a = [1, ps, pt], and v = w
    vech(n n^T), n = [ns, nt], per chunk, then each 42x42 entry (6i+c, 6j+d)
    gathered from its sum (vech(i, j), vech(c, d))."""
    a = torch.cat([torch.ones_like(data[:1]), data[0:3], data[6:9]])
    n = torch.cat([data[3:6], data[9:12]])
    i7, i6 = torch.triu_indices(7, 7), torch.triu_indices(6, 6)
    u = (a[i7[0]] * a[i7[1]]).reshape(28, -1, chunk)
    v = (data[12] * n[i6[0]] * n[i6[1]]).reshape(21, -1, chunk)
    S = torch.einsum("pgr,qgr->gpq", u, v)
    vech = []
    for k in (7, 6):
        m = torch.zeros((k, k), dtype=torch.long)
        iu = torch.triu_indices(k, k)
        m[iu[0], iu[1]] = torch.arange(iu.shape[1])
        vech.append(torch.maximum(m, m.T))  # symmetric: (j, i) -> vech(i, j)
    k = torch.arange(42)
    p = vech[0][k[:, None] // 6, k[None, :] // 6]
    q = vech[1][k[:, None] % 6, k[None, :] % 6]
    return S[:, p, q]


@pytest.mark.parametrize("chunk,offset,seed", [(256, 0.0, 31), (1024, 0.0, 32), (512, 50.0, 33)])
def test_kronecker_factored_gram_matches_plain_and_jax(chunk, offset, seed):
    """Float64: the 28 x 21 factored product and its gather equal the plain
    42x42 Gram (moment_gram_plain) to rounding, and the JAX group Gram
    (moment_gram_xla, float32 HIGHEST) within its tolerance; also far from
    the origin, where the monomials cancel."""
    rng = np.random.RandomState(seed)
    groups, _ = _random_groups(rng, 2, 900)
    for g in groups:
        g["ps"] += np.float32(offset)
        g["pt"] += np.float32(offset)
    data, gid = tm.pack_group_data(groups, chunk, rows=13, device="cpu")
    got = _kron_gram(data.double(), chunk)
    plain = gn.moment_gram_plain(data.double(), chunk)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-13 * float(plain.abs().max()))
    for k, P_ref in enumerate(_P(groups)):
        P = got[torch.as_tensor(gid == k)].sum(0).numpy()
        np.testing.assert_array_equal(P, P.T)
        np.testing.assert_allclose(P, P_ref, rtol=2e-5, atol=2e-5 * np.abs(P_ref).max())


@pytest.mark.parametrize("chunk", [256, 49152])
def test_compute_group_moments_matches_jax(chunk):
    rng = np.random.RandomState(5)
    groups, _ = _random_groups(rng, 3, 700)
    ref = jm.compute_group_moments(groups, force_xla=True)
    got = tm.compute_group_moments(groups, chunk=chunk, device="cpu")
    for P, P_ref in zip(got, ref):
        np.testing.assert_allclose(P, P_ref, rtol=2e-5, atol=2e-5 * np.abs(P_ref).max())


def test_moments_match_direct_hb():
    """H_aug from the port's group moments equals the JAX direct row
    accumulation at arbitrary poses."""
    rng = np.random.RandomState(7)
    C = 3
    groups, pairs = _random_groups(rng, C)
    q, t = _random_poses(rng, C)
    H_m, b_m, cost_m = tm.hb_cost_from_moments(tm.compute_group_moments(groups, chunk=512, device="cpu"),
                                               pairs, q, t, C)
    flat = {k: np.concatenate([g[k] for g in groups]) for k in ("ps", "ns", "pt", "nt", "w")}
    sid = np.repeat(np.asarray([s for s, _ in pairs], np.int32), 257)
    tid = np.repeat(np.asarray([tg for _, tg in pairs], np.int32), 257)
    H_d, b_d, cost_d = j_icp_hb_cost(
        jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32),
        *[jnp.asarray(flat[k]) for k in ("ps", "ns", "pt", "nt")],
        jnp.asarray(sid), jnp.asarray(tid), jnp.asarray(flat["w"]), C)
    scale = np.abs(np.asarray(H_d)).max()
    np.testing.assert_allclose(H_m, np.asarray(H_d), atol=2e-4 * scale)
    np.testing.assert_allclose(b_m, np.asarray(b_d), atol=2e-4 * np.abs(np.asarray(b_d)).max())
    np.testing.assert_allclose(cost_m, float(cost_d), rtol=2e-5)


@pytest.mark.parametrize("C,per_group,seed", [(2, 123, 17), (6, 57, 23)])
def test_hb_cost_from_moments_torch_matches_jax_and_float64(C, per_group, seed):
    """The on-device form, batched over the groups (C = 6 gives 30), against
    the JAX function (1e-5 of scale) and the float64 host form (2e-4)."""
    rng = np.random.RandomState(seed)
    groups, pairs = _random_groups(rng, C, per_group=per_group)
    assert len(pairs) == C * (C - 1)
    q, t = _random_poses(rng, C)
    P = jm.compute_group_moments(groups, force_xla=True)
    H_np, b_np, c_np = jm.hb_cost_from_moments(P, pairs, q, t, C)
    P48 = np.stack([np.pad(p, ((0, 6), (0, 6))) for p in P]).astype(np.float32)
    H_j, b_j, c_j = (np.asarray(x) for x in jm.hb_cost_from_moments_jax(
        jnp.asarray(P48), pairs, jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32), C))
    H, b, c = (x.numpy() for x in tm.hb_cost_from_moments_torch(
        torch.from_numpy(P48), pairs, torch.from_numpy(q.astype(np.float32)),
        torch.from_numpy(t.astype(np.float32)), C))
    assert H.dtype == np.float32 and H.shape == (6 * C, 6 * C) and b.shape == (6 * C,)
    scale, bscale = np.abs(H_np).max(), max(np.abs(b_np).max(), 1e-9)
    np.testing.assert_allclose(H, H_np, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(b, b_np, rtol=0, atol=2e-4 * bscale)
    np.testing.assert_allclose(float(c), c_np, rtol=2e-4)
    np.testing.assert_allclose(H, H_j, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(b, b_j, rtol=0, atol=1e-5 * bscale)
    np.testing.assert_allclose(float(c), float(c_j), rtol=1e-5)
    # in float64 it is the host form, with (G, 42, 42) moments and a pair tensor
    H64, b64, c64 = tm.hb_cost_from_moments_torch(
        torch.from_numpy(np.stack(P)), torch.tensor(pairs), torch.from_numpy(q),
        torch.from_numpy(t), C)
    np.testing.assert_allclose(H64.numpy(), H_np, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(b64.numpy(), b_np, rtol=0, atol=1e-12 * bscale)
    np.testing.assert_allclose(float(c64), c_np, rtol=1e-12)


def test_group_moments_on_device_matches_host_sums():
    from dataset_pipeline_tpu_torch.ops import gn

    rng = np.random.RandomState(9)
    groups, _ = _random_groups(rng, 3, 700)
    data, gid = tm.pack_group_data(groups, 256, rows=13, device="cpu")
    host = tm.compute_group_moments_from_packed(data, gid, len(groups), 256)
    parts, per_chunk = gn.moment_gram_partials(data, 256)
    dev = tm.group_moments_on_device(parts, per_chunk, gid, len(groups))
    assert dev.shape == (len(groups), 42, 42) and dev.dtype == torch.float32
    for P, P_ref in zip(dev.double().numpy(), host):
        np.testing.assert_allclose(P, P_ref, rtol=0, atol=1e-6 * np.abs(P_ref).max())


def test_tf32_stays_off():
    """The moment products need strict fp32; the package's import sets it."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("Mp,chunk,slots,rows", [
    (8_060_928, 49152, 132, 12288),   # 5.0 waves; 8192 rows would take 7.5, so 8
    (1_032_192, 49152, 132, 8192),    # one wave
    (28_016_640, 49152, 132, 16384),  # 12.95 waves
    (4096, 256, 132, 256),            # a chunk below 4096 rows is one block
    (7680, 768, 2, 768),
    (171_520, 17152, 132, 256),       # 67 x 256: no divisor from 4096 to 16384
])
def test_moment_gram_blocks_follow_the_resident_slots(monkeypatch, Mp, chunk, slots, rows):
    """B2's rows per block: a divisor of the chunk from 4096 to 16384 rows
    (below 4096 only where there is none) with the fewest rows per resident block over the launch (the slots are
    the runtime's count, here given), the largest among equals."""
    from dataset_pipeline_tpu_torch import kernels

    monkeypatch.setattr(kernels, "persistent_grid", lambda query, device: slots)
    assert gn._moment_rows_per_block(chunk, Mp, "cuda") == rows
    with pytest.raises(ValueError, match="multiple of 256"):
        gn._moment_rows_per_block(chunk + 1, Mp, "cuda")
