"""Port vs JAX: Lie-group math (``models/lie.py``), atol 1e-6 in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.models import lie as jl
from dataset_pipeline_tpu_torch.models import lie as tl

torch.set_num_threads(2)
ATOL = 1e-6


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _tangents(rng, n, scale):
    return (scale * rng.randn(n, 6)).astype(np.float32)


# large, moderate, and below the 1e-8 small-angle switch of so3_exp / _apply_V
SCALES = [1.0, 1e-2, 1e-5]


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol)


def test_quat_rotate_and_matrix():
    rng = np.random.RandomState(0)
    q, v = _quats(rng, 64), rng.randn(64, 3).astype(np.float32)
    _close(jl.quat_rotate(jnp.asarray(q), jnp.asarray(v)),
           tl.quat_rotate(torch.from_numpy(q), torch.from_numpy(v)))
    _close(jl.quat_to_matrix(jnp.asarray(q)), tl.quat_to_matrix(torch.from_numpy(q)))
    np.testing.assert_array_equal(jl.quat_to_matrix_np(q[0].astype(np.float64)),
                                  tl.quat_to_matrix_np(q[0].astype(np.float64)))


def test_quat_multiply():
    rng = np.random.RandomState(1)
    a, b = _quats(rng, 32), _quats(rng, 32)
    _close(jl.quat_multiply(jnp.asarray(a), jnp.asarray(b)),
           tl.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("scale", SCALES)
def test_se3_exp(scale):
    rng = np.random.RandomState(2)
    x = _tangents(rng, 64, scale)
    ej, et = jl.SE3.exp(jnp.asarray(x)), tl.SE3.exp(torch.from_numpy(x))
    _close(ej.q, et.q)
    _close(ej.t, et.t)
    _close(jl.so3_exp_quat(jnp.asarray(x[:, 3:])), tl.so3_exp_quat(torch.from_numpy(x[:, 3:])))
    _close(jl._apply_V(jnp.asarray(x[:, 3:]), jnp.asarray(x[:, :3])),
           tl._apply_V(torch.from_numpy(x[:, 3:]), torch.from_numpy(x[:, :3])))


@pytest.mark.parametrize("scale", SCALES)
def test_se3_compose_apply_matrix(scale):
    rng = np.random.RandomState(3)
    a, b = _tangents(rng, 16, scale), _tangents(rng, 16, 0.5)
    p = rng.randn(16, 3).astype(np.float32)
    A, B = jl.SE3.exp(jnp.asarray(a)), jl.SE3.exp(jnp.asarray(b))
    At, Bt = tl.SE3.exp(torch.from_numpy(a)), tl.SE3.exp(torch.from_numpy(b))
    AB, ABt = A.compose(B), At.compose(Bt)
    _close(AB.q, ABt.q)
    _close(AB.t, ABt.t)
    _close(AB.apply(jnp.asarray(p)), ABt.apply(torch.from_numpy(p)), atol=2e-6)
    _close(AB.matrix(), ABt.matrix())
    back = tl.SE3.from_matrix(ABt.matrix())
    ref = jl.SE3.from_matrix(AB.matrix())
    # from_matrix picks the sign of q like the JAX function does
    _close(ref.q, back.q, atol=2e-6)
    _close(ref.t, back.t)


def test_compose_broadcasts_a_batch_of_candidates():
    """The engine composes (K, C) candidates with one (C,) current pose."""
    rng = np.random.RandomState(4)
    d = _tangents(rng, 10 * 3, 1e-3).reshape(10, 3, 6)
    cur = _tangents(rng, 3, 0.1)
    ref = [jl.SE3.exp(jnp.asarray(d[k])).compose(jl.SE3.exp(jnp.asarray(cur))) for k in range(10)]
    got = tl.SE3.exp(torch.from_numpy(d)).compose(tl.SE3.exp(torch.from_numpy(cur)))
    for k in range(10):
        _close(ref[k].q, got.q[k])
        _close(ref[k].t, got.t[k])


@pytest.mark.parametrize("scale", SCALES)
def test_se3_log_and_so3_log(scale):
    """``SE3.log``, ``so3_log`` and ``_apply_V_inv`` against JAX (atol 1e-6),
    and the round trips of ``tests/test_lie.py``."""
    rng = np.random.RandomState(5)
    x = _tangents(rng, 64, scale)
    ej, et = jl.SE3.exp(jnp.asarray(x)), tl.SE3.exp(torch.from_numpy(x))
    _close(ej.log(), et.log())
    _close(jl.so3_log(ej.q), tl.so3_log(et.q))
    _close(jl._apply_V_inv(jnp.asarray(x[:, 3:]), jnp.asarray(x[:, :3])),
           tl._apply_V_inv(torch.from_numpy(x[:, 3:]), torch.from_numpy(x[:, :3])))
    atol = 3e-3 if scale == 1.0 else 1e-5  # float32 rounding at large angles, as test_lie.py
    np.testing.assert_allclose(et.log().numpy(), x, atol=atol)
    # the w < 0 branch of so3_log
    _close(jl.so3_log(-ej.q), tl.so3_log(-et.q))


def test_skew_rotate_cast_from_rt():
    rng = np.random.RandomState(6)
    w = rng.randn(8, 3).astype(np.float32)
    v = rng.randn(8, 3).astype(np.float32)
    _close(jl.skew(jnp.asarray(w)), tl.skew(torch.from_numpy(w)))
    np.testing.assert_allclose((tl.skew(torch.from_numpy(w)) @ torch.from_numpy(v)[..., None])[..., 0]
                               .numpy(), np.cross(w, v), atol=1e-5)
    x = _tangents(rng, 8, 0.5)
    ej, et = jl.SE3.exp(jnp.asarray(x)), tl.SE3.exp(torch.from_numpy(x))
    _close(ej.rotate(jnp.asarray(v)), et.rotate(torch.from_numpy(v)))
    assert et.cast(torch.float64).q.dtype == torch.float64
    R = tl.quat_to_matrix(et.q)
    back = tl.SE3.from_rt(R, et.t)
    ref = jl.SE3.from_rt(jl.quat_to_matrix(ej.q), ej.t)
    _close(ref.q, back.q, atol=2e-6)
    assert et.batch_shape == (8,)
    _close(ej.rotation_matrix(), et.rotation_matrix())


def test_sim3_matches_jax():
    """Sim3 apply / inverse / compose / matrix / from_matrix against JAX, and
    the round trips of ``tests/test_lie.py``."""
    rng = np.random.RandomState(7)
    q = _quats(rng, 8)
    t = rng.randn(8, 3).astype(np.float32)
    s = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    p = rng.randn(8, 3).astype(np.float32)
    J = jl.Sim3(jnp.asarray(q), jnp.asarray(t), jnp.asarray(s))
    T = tl.Sim3(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(s))
    _close(J.apply(jnp.asarray(p)), T.apply(torch.from_numpy(p)), atol=1e-5)
    for a, b in zip(J.inverse(), T.inverse()):
        _close(a, b, atol=1e-5)
    for a, b in zip(J.compose(J.inverse()), T @ T.inverse()):
        _close(a, b, atol=1e-5)
    _close(J.matrix(), T.matrix(), atol=1e-5)
    for a, b in zip(jl.Sim3.from_matrix(J.matrix()), tl.Sim3.from_matrix(T.matrix())):
        _close(a, b, atol=1e-5)
    np.testing.assert_allclose((T @ T.inverse()).apply(torch.from_numpy(p)).numpy(), p, atol=1e-4)
    se3 = tl.SE3(torch.from_numpy(q), torch.from_numpy(t))
    assert np.all(tl.Sim3.from_se3(se3).s.numpy() == 1.0)
    assert tl.Sim3.identity((2,)).s.shape == (2,)


def test_average_quaternions_matches_jax():
    rng = np.random.RandomState(8)
    base = _quats(rng, 1)[0]
    noise = (rng.uniform(-0.01, 0.01, (32, 3))).astype(np.float32)
    qs_j = jl.quat_multiply(jnp.broadcast_to(jnp.asarray(base), (32, 4)),
                            jl.so3_exp_quat(jnp.asarray(noise)))
    qs = torch.from_numpy(np.asarray(qs_j))
    avg = tl.average_quaternions(qs)
    _close(jl.average_quaternions(qs_j), avg, atol=1e-6)
    assert abs(float(torch.sum(avg * torch.from_numpy(base)))) > 0.9999
