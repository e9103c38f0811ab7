"""Port vs JAX: the ICP engine (``icp/point_to_plane.py``) on the scenes of
``tests/test_icp.py``: the same ground-truth bounds, and port poses within
1e-5 of the JAX engine's."""

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.icp.moments import se3_exp_np
from dataset_pipeline_tpu.icp.point_to_plane import PointToPlaneICP as JaxICP
from dataset_pipeline_tpu.models.lie import quat_to_matrix_np
from dataset_pipeline_tpu_torch.icp import point_to_plane as tpp

torch.set_num_threads(2)
PORT_TOL = 1e-5


def _plane_with_single_point():
    xs, ys = np.meshgrid(np.arange(50.0), np.arange(50.0))
    plane = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], -1).astype(np.float32)
    plane_n = np.tile(np.asarray([[0, 0, 1]], np.float32), (len(plane), 1))
    extra = np.asarray([[0.0, 0.0, 20.0]], np.float32)
    extra_n = np.asarray([[1.0, 0.0, 1.0]], np.float32) / np.sqrt(2.0)
    return np.concatenate([plane, extra]), np.concatenate([plane_n, extra_n])


def _run_both(setup, run_kw, **port_kw):
    out = []
    for engine in (JaxICP(), tpp.PointToPlaneICP(device="cpu", **port_kw)):
        setup(engine)
        out.append(engine.run(**run_kw))
    return out


def test_plane_with_single_point():
    """A second copy of the plane offset by one grid cell snaps to the first
    copy's pose (the off-plane point disambiguates); ill-conditioned, so the
    direct LM runs alone."""
    pts, nrm = _plane_with_single_point()

    def setup(icp):
        icp.add_point_cloud(pts, nrm, np.eye(4))
        T = np.eye(4)
        T[:3, 3] = [1.0, 0.0, 0.0]
        icp.add_point_cloud(pts, nrm, T)

    ref, got = _run_both(setup, dict(max_correspondence_distance=1.5, max_num_iterations=100,
                                     convergence_threshold_max_movement=1e-7))
    np.testing.assert_allclose(got.poses[1], got.poses[0], atol=1e-5)
    for a, b in zip(got.poses, ref.poses):
        np.testing.assert_allclose(a, b, atol=PORT_TOL)


def test_fixed_cloud_stays_fixed():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    normals = rng.randn(200, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)

    def setup(icp):
        icp.add_point_cloud(pts, normals, np.eye(4), fixed=True)
        T = np.eye(4)
        T[:3, 3] = [0.03, -0.02, 0.04]
        icp.add_point_cloud(pts, normals, T)

    ref, got = _run_both(setup, dict(max_correspondence_distance=0.3, max_num_iterations=50,
                                     convergence_threshold_max_movement=1e-7))
    np.testing.assert_allclose(got.poses[0], np.eye(4), atol=5e-4)
    np.testing.assert_allclose(got.poses[0], ref.poses[0], atol=PORT_TOL)
    assert got.num_correspondences == ref.num_correspondences


@pytest.mark.parametrize("use_moments", [True, False])
def test_three_clouds_moment_and_direct(use_moments):
    """Three perturbed copies of a curved surface: moment-accelerated and
    direct-only LM both match the JAX engine (moment path on, by default)."""
    rng = np.random.RandomState(11)
    base = rng.rand(400, 3).astype(np.float32) * 2
    base[:, 2] = 0.2 * np.sin(4 * base[:, 0]) + 0.1 * np.cos(3 * base[:, 1])
    n = np.stack([-0.8 * np.cos(4 * base[:, 0]), 0.3 * np.sin(3 * base[:, 1]),
                  np.ones(len(base))], -1)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    clouds = []
    for seed in (5, 6):
        r = np.random.RandomState(seed)
        dq, dt = se3_exp_np(np.concatenate([0.02 * r.randn(3), 0.02 * r.randn(3)]))
        R = quat_to_matrix_np(dq)
        clouds.append(((base @ R.T + dt).astype(np.float32), (n @ R.T).astype(np.float32)))

    def setup(icp):
        icp.add_point_cloud(base, n)
        for p, q in clouds:
            icp.add_point_cloud(p, q)

    ref, got = _run_both(setup, dict(max_correspondence_distance=0.3, max_num_iterations=20,
                                     convergence_threshold_max_movement=1e-9),
                         use_moments=use_moments)
    for a, b in zip(got.poses, ref.poses):
        np.testing.assert_allclose(a, b, atol=1e-4 if not use_moments else PORT_TOL)
    assert np.abs(got.poses[1][:3, 3] - got.poses[0][:3, 3]).max() < 0.05


def test_get_result_global_T_cloud_matches_jax():
    """Before ``run`` the initial pose, after it the result's, as the JAX
    engine returns them."""
    rng = np.random.RandomState(2)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    nrm = rng.randn(300, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    T = np.eye(4)
    T[:3, 3] = [0.02, -0.01, 0.03]
    engines = (JaxICP(), tpp.PointToPlaneICP(device="cpu"))
    for icp in engines:
        icp.add_point_cloud(pts, nrm, np.eye(4), fixed=True)
        assert icp.add_point_cloud(pts, nrm, T) == 0
        np.testing.assert_array_equal(icp.get_result_global_T_cloud(0), T)
    ref, got = (icp.run(0.3, max_num_iterations=30) for icp in engines)
    np.testing.assert_array_equal(engines[1].get_result_global_T_cloud(0), got.poses[0])
    np.testing.assert_allclose(engines[1].get_result_global_T_cloud(0),
                               engines[0].get_result_global_T_cloud(0), atol=PORT_TOL)


def test_single_movable_cloud_returns_early():
    """C = 1 (no fixed cloud): nothing to solve, n_var == 0."""
    icp = tpp.PointToPlaneICP(device="cpu")
    icp.add_point_cloud(np.random.RandomState(1).rand(100, 3), np.tile([[0, 0, 1.0]], (100, 1)))
    res = icp.run(0.1, max_num_iterations=3)
    np.testing.assert_array_equal(res.poses[0], np.eye(4))


def test_engine_chunk():
    assert tpp._engine_chunk([10, 300]) == 512
    assert tpp._engine_chunk([4_000_000]) == tpp.ENGINE_CHUNK
    assert tpp.ENGINE_CHUNK % 256 == 0


def _three_cloud_correspondences(seed=21, per_group=400):
    """Fixed correspondences between three perturbed copies of a wavy
    surface, every ordered pair: the (M, 3) + id layout of the JAX function
    and the groups of the port's engine."""
    rng = np.random.RandomState(seed)
    poses = [(np.asarray([1.0, 0, 0, 0]), np.zeros(3))] + [
        se3_exp_np(0.02 * rng.randn(6)) for _ in range(2)]
    groups, pairs = [], []
    for s in range(3):
        for tg in range(3):
            if s == tg:
                continue
            xy = rng.uniform(-1, 1, (per_group, 2))
            p = np.stack([xy[:, 0], xy[:, 1], 0.3 * np.sin(2 * xy[:, 0]) * np.cos(1.7 * xy[:, 1])], -1)
            n = np.stack([-0.6 * np.cos(2 * xy[:, 0]) * np.cos(1.7 * xy[:, 1]),
                          0.51 * np.sin(2 * xy[:, 0]) * np.sin(1.7 * xy[:, 1]),
                          np.ones(per_group)], -1)
            n /= np.linalg.norm(n, axis=1, keepdims=True)
            Rs, Rt = quat_to_matrix_np(poses[s][0]), quat_to_matrix_np(poses[tg][0])
            groups.append({"ps": (p @ Rs.T + poses[s][1]).astype(np.float32),
                           "ns": (n @ Rs.T).astype(np.float32),
                           "pt": (p @ Rt.T + poses[tg][1] + 1e-3 * rng.randn(per_group, 3)).astype(np.float32),
                           "nt": (n @ Rt.T).astype(np.float32)})
            pairs.append((s, tg))
    return groups, pairs


def test_inner_lm_device_matches_jax():
    """The whole inner LM on the device: the same trajectory as the JAX
    function (q, t within 1e-5, the same number of iterations)."""
    import jax.numpy as jnp

    from dataset_pipeline_tpu.icp.point_to_plane import _icp_inner_lm_device as j_lm
    from dataset_pipeline_tpu_torch.icp.moments import pack_group_data

    groups, pairs = _three_cloud_correspondences()
    C, chunk = 3, 512
    flat = {k: np.concatenate([g[k] for g in groups]) for k in ("ps", "ns", "pt", "nt")}
    sid = np.repeat(np.asarray([s for s, _ in pairs], np.int32), [len(g["ps"]) for g in groups])
    tid = np.repeat(np.asarray([tg for _, tg in pairs], np.int32), [len(g["ps"]) for g in groups])
    q0 = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (C, 1))
    t0 = np.zeros((C, 3), np.float32)
    qj, tj, itj = j_lm(jnp.asarray(q0), jnp.asarray(t0), *[jnp.asarray(flat[k]) for k in ("ps", "ns", "pt", "nt")],
                       jnp.asarray(sid), jnp.asarray(tid), jnp.ones(len(sid), jnp.float32), C, 20, 1e-7)
    data, gid = pack_group_data(groups, chunk, rows=13, device="cpu")
    cp = torch.as_tensor(np.asarray(pairs, np.int32)[gid])
    q, t, it = tpp._icp_inner_lm_device(torch.from_numpy(q0), torch.from_numpy(t0), data, cp, C,
                                        chunk, 20, 1e-7)
    assert it == int(itj) and 2 <= it < 20
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=0, atol=PORT_TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=0, atol=PORT_TOL)
    assert np.abs(t.numpy()).max() > 1e-3  # it moved the clouds
    # through the engine: the flag takes this path and ends where the
    # host-solved direct LM ends
    tg = [{k: torch.from_numpy(v) for k, v in g.items()} for g in groups]
    timings = {}
    qd, td, cd = tpp.PointToPlaneICP(use_device_lm=True, device="cpu", timings=timings)._inner_lm(
        tg, pairs, C, 20, 1e-7)
    assert "device_lm" in timings and "direct_lm" not in timings
    np.testing.assert_array_equal(qd, q.numpy())
    qh, th, ch = tpp.PointToPlaneICP(use_moments=False, device="cpu")._inner_lm(tg, pairs, C, 20, 1e-7)
    np.testing.assert_allclose(qd, qh, rtol=0, atol=PORT_TOL)
    np.testing.assert_allclose(td, th, rtol=0, atol=PORT_TOL)
    np.testing.assert_allclose(cd, ch, rtol=1e-5)


def test_use_device_lm_engine_matches_jax():
    """``use_device_lm=True`` through ``run`` on both sides."""
    rng = np.random.RandomState(11)
    base = rng.rand(400, 3).astype(np.float32) * 2
    base[:, 2] = 0.2 * np.sin(4 * base[:, 0]) + 0.1 * np.cos(3 * base[:, 1])
    n = np.stack([-0.8 * np.cos(4 * base[:, 0]), 0.3 * np.sin(3 * base[:, 1]),
                  np.ones(len(base))], -1)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    dq, dt = se3_exp_np(np.concatenate([0.02 * rng.randn(3), 0.02 * rng.randn(3)]))
    R = quat_to_matrix_np(dq)
    moved = ((base @ R.T + dt).astype(np.float32), (n @ R.T).astype(np.float32))
    out = []
    for engine in (JaxICP(use_device_lm=True), tpp.PointToPlaneICP(use_device_lm=True, device="cpu")):
        engine.add_point_cloud(base, n)
        engine.add_point_cloud(*moved)
        out.append(engine.run(0.3, max_num_iterations=10, convergence_threshold_max_movement=1e-9))
    for a, b in zip(out[1].poses, out[0].poses):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert out[1].num_correspondences == out[0].num_correspondences


def test_engine_defaults_to_the_card(monkeypatch):
    """No device named: the engine runs on the card, and says so when there
    is none instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpp.PointToPlaneICP()
    assert tpp.PointToPlaneICP(device="cpu").device.type == "cpu"
