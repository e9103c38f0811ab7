"""Port vs JAX: the mesh and the sharded ICP normal equations
(``parallel/mesh.py``, ``parallel/normal_equations.py``, ``parallel/ba.py``).

JAX's sharded functions run here, in the test process, on the 8-virtual-device
CPU mesh (1-D) and its 2 x 4 split (``tests/conftest.py``); the port's run in
Gloo ranks on the CPU, two and four of them (one launch per world size, every
case in it), on their 1-D mesh and their 2 x (world / 2) mesh. The inputs are
made from seeds with numpy and handed to both. Bounds, those of the JAX tests
(``tests/test_parallel.py``): H and b rtol 1e-4 / atol 1e-3, the cost 1e-5
relative (:45-47, :140-142); the moment Gram rtol 1e-5 / atol 1e-5 max|P|
(:182-183, :228-229); the dense joint-BA step within 5e-3 of the solution
JAX recovers (:95). On ``test_sharded_moment_gram_matches_single_device``'s
own data, the H and the LM cost that ``hb_cost_from_moments`` derives from
the sharded Gram against the direct sharded H, cost: H within 3e-4 of its
largest entry, the cost 1e-4 relative (:201-203); the port misses the cost
bound at two ranks (ROADMAP C.3), and that case is a strict expected
failure until the fix.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from dataset_pipeline_tpu.icp.moments import se3_exp_np
from dataset_pipeline_tpu.parallel import ba as jba
from dataset_pipeline_tpu.parallel.mesh import make_data_mesh, make_host_device_mesh, shard_rows
from dataset_pipeline_tpu.parallel.normal_equations import sharded_icp_hb, sharded_moment_gram
from dataset_pipeline_tpu_torch.icp.moments import hb_cost_from_moments
from dataset_pipeline_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
H_RTOL, H_ATOL, COST_RTOL = 1e-4, 1e-3, 1e-5
GRAM_RTOL = 1e-5
WORLDS = (2, 4)
CASES = ("icp", "icp_2d", "gram", "gram_2d", "dense_step")
MOMENT_H_ATOL, MOMENT_COST_RTOL = 3e-4, 1e-4  # of max|H|; tests/test_parallel.py:201-203


def correspondences(rng, m: int, C: int, w_random: bool):
    ps = rng.randn(m, 3).astype(np.float32)
    ns = rng.randn(m, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    pt = (ps + 0.02 * rng.randn(m, 3)).astype(np.float32)
    sid = rng.randint(0, C, m).astype(np.int32)
    tid = ((sid + 1) % C).astype(np.int32)
    w = rng.rand(m).astype(np.float32) if w_random else np.ones(m, np.float32)
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (C, 1))
    t = np.zeros((C, 3), np.float32)
    return dict(ps=ps, ns=ns, pt=pt, nt=ns.copy(), sid=sid, tid=tid, w=w, q=q, t=t, C=C)


def padded(c: dict, n: int) -> dict:
    """The rows of ``c`` with zero rows (w = 0) up to ``n``: JAX's shard_map
    takes a row count divisible by the mesh size."""
    keys = ("ps", "ns", "pt", "nt", "sid", "tid", "w")
    return {**c, **{k: np.concatenate([c[k], np.zeros((n - len(c[k]),) + c[k].shape[1:],
                                                        c[k].dtype)]) for k in keys if k in c}}


def jax_icp(mesh, c):
    args = [shard_rows(mesh, jnp.asarray(c[k])) for k in ("ps", "ns", "pt", "nt", "sid", "tid", "w")]
    H, b, cost = sharded_icp_hb(mesh, jnp.asarray(c["q"]), jnp.asarray(c["t"]), *args, c["C"])
    return np.asarray(H, np.float64), np.asarray(b, np.float64), float(cost)


def jax_gram(mesh, c):
    return np.asarray(sharded_moment_gram(
        mesh, *(shard_rows(mesh, jnp.asarray(c[k])) for k in ("ps", "ns", "pt", "nt", "w"))),
        np.float64)


@pytest.fixture(scope="module")
def cases():
    """Per case: the inputs (numpy) and JAX's result."""
    rng = np.random.RandomState(23)
    mesh8, mesh24 = make_data_mesh(), make_host_device_mesh(2, 4)
    out = {}
    # 515 rows: the port pads them to a multiple of its world, JAX to 520
    icp = correspondences(rng, 8 * 64 + 3, 3, w_random=False)
    out["icp"] = (icp, jax_icp(mesh8, padded(icp, 520)))
    icp2 = correspondences(rng, 8 * 32, 2, w_random=False)
    out["icp_2d"] = (icp2, jax_icp(mesh24, icp2))
    gram = correspondences(rng, 1024 * 8, 2, w_random=True)
    out["gram"] = (gram, jax_gram(mesh8, gram))
    gram2 = correspondences(rng, 8 * 64, 2, w_random=True)
    out["gram_2d"] = (gram2, jax_gram(mesh24, gram2))

    # test_parallel.py's linear joint-BA toy problem: one damped GN step solves it
    n_keep, m, R = 8, 4, 8 * 32
    rows = np.zeros((R, n_keep + 6 * m), np.float32)
    rows[:, :n_keep] = rng.randn(R, n_keep) * 0.3
    for i, img in enumerate(rng.randint(0, m, R)):
        rows[i, n_keep + 6 * img:n_keep + 6 * img + 6] = rng.randn(6)
    x_true = (rng.randn(n_keep + 6 * m) * 0.1).astype(np.float32)
    r = (rows @ x_true).astype(np.float32)
    w = np.ones(R, np.float32)
    xk, xi, _ = jba.joint_ba_step(mesh8, lambda a, b, c: (a, b, c),
                                  tuple(shard_rows(mesh8, jnp.asarray(a)) for a in (rows, r, w)),
                                  (P("data"),) * 3, n_keep, m, lam=1e-4)
    out["dense_step"] = (dict(rows=rows, r=r, w=w, n_keep=n_keep, m=m, x_true=x_true),
                         np.concatenate([np.asarray(xk), np.asarray(xi).reshape(-1)]))

    # test_parallel.py:test_sharded_moment_gram_matches_single_device's data:
    # one cloud pair, cloud 1 moved off the identity
    r9 = np.random.RandomState(9)
    M = 1024 * 8
    ps = r9.randn(M, 3).astype(np.float32)
    ns = r9.randn(M, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    pt = (ps + 0.03 * r9.randn(M, 3)).astype(np.float32)
    w = r9.rand(M).astype(np.float32)
    q = np.tile(np.asarray([1.0, 0, 0, 0]), (2, 1))
    t = np.zeros((2, 3))
    q[1], t[1] = se3_exp_np(np.asarray([0.01, -0.02, 0.005, 0.004, -0.003, 0.002]))
    out["moment_vs_direct"] = (dict(ps=ps, ns=ns, pt=pt, nt=ns.copy(), w=w,
                                    sid=np.zeros(M, np.int32), tid=np.ones(M, np.int32),
                                    q=q.astype(np.float32), t=t.astype(np.float32), q64=q, t64=t),
                               None)
    return out


@pytest.fixture(scope="module")
def port(cases):
    """Every case in one launch per world size: {world: rank results}."""
    inputs = {name: c for name, (c, _) in cases.items()}
    return {w: [out for out, _ in tmesh.launch(ranks.normal_equations, w, (inputs,))]
            for w in WORLDS}


def close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_results_match_jax(cases, port, world, case):
    """Every rank ends with the same replicated result, within the JAX
    tests' bounds of JAX's on the 8-device and 2 x 4 meshes."""
    c, want = cases[case]
    for r, out in enumerate(port[world]):
        got = out[case]
        what = f"{case}, world {world}, rank {r}"
        if case.startswith("icp"):
            close(got[0], want[0], H_RTOL, H_ATOL, what + " H")
            close(got[1], want[1], H_RTOL, H_ATOL, what + " b")
            close(got[2], want[2], COST_RTOL, 0, what + " cost")
        elif case.startswith("gram"):
            close(got, want, GRAM_RTOL, 1e-5 * np.abs(want).max(), what)
        else:
            close(got, c["x_true"], 0, 5e-3, what + " against the solution")
            close(got, want, 0, 5e-3, what + " against JAX's step")
        first = port[world][0][case]
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        first if isinstance(first, tuple) else (first,)):
            np.testing.assert_array_equal(a, b, err_msg=what + ": the ranks disagree")


def _moment_vs_direct(cases, port, world):
    c, _ = cases["moment_vs_direct"]
    for out in port[world]:
        P, H_d, cost_d = out["moment_vs_direct"]
        H_m, _, cost_m = hb_cost_from_moments([P], [(0, 1)], c["q64"], c["t64"], 2)
        yield H_m, H_d, cost_m, cost_d


@pytest.mark.parametrize("world", WORLDS)
def test_moment_h_matches_the_direct_h(cases, port, world):
    """The H that ``hb_cost_from_moments`` derives from the sharded moment
    Gram against the direct sharded H of the same rows (:201)."""
    for H_m, H_d, _, _ in _moment_vs_direct(cases, port, world):
        np.testing.assert_allclose(H_m, H_d, rtol=0, atol=MOMENT_H_ATOL * np.abs(H_d).max())


@pytest.mark.parametrize("world", [
    pytest.param(2, marks=pytest.mark.xfail(
        strict=True, reason="ROADMAP C.3: the plain B2's float32 chunk sums put the "
        "moment-derived cost 1.5e-4 from the direct cost")),
    4])
def test_moment_cost_matches_the_direct_cost(cases, port, world):
    """The LM cost derived from the sharded moment Gram against the direct
    sharded cost at JAX's bound (:203); JAX's own gap is 1.1e-5. The port
    meets it at four ranks (a quarter of the rows in each float32 sum) and
    misses it at two (C.3)."""
    for _, _, cost_m, cost_d in _moment_vs_direct(cases, port, world):
        np.testing.assert_allclose(cost_m, cost_d, rtol=MOMENT_COST_RTOL)


def test_initialize_distributed_noop_single_process(monkeypatch):
    """Without a coordinator the entry is a no-op that returns False."""
    for k in ("DPT_COORDINATOR", "DPT_NUM_PROCESSES", "DPT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_distributed() is False
    assert tmesh.cli_mesh(1, "", "cpu") is None
    mesh = tmesh.make_data_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    assert tmesh.mesh_axes(mesh) == ("data",)
    x = torch.arange(3.0)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x


def test_shard_rows_pads_with_zero_rows():
    """A rank's contiguous slice after zero padding to a multiple of the mesh
    size; every rank's slices together give the rows and the padding."""
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3) + 1
    parts = [tmesh.shard_rows(tmesh.Mesh(("hosts", "devices"), (2, 2), r, torch.device("cpu"),
                                         "gloo"), x) for r in range(4)]
    assert all(p.shape == (3, 3) for p in parts)
    whole = torch.cat(parts).numpy()
    np.testing.assert_array_equal(whole[:10], x)
    assert not whole[10:].any()


def test_ranks_to_launch_follows_the_flags(monkeypatch):
    for k in ("DPT_COORDINATOR", "DPT_NUM_PROCESSES", "DPT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert [tmesh.ranks_to_launch(d, m, "cpu") for d, m in
            ((0, ""), (1, ""), (2, ""), (1, "2x1"), (0, "2x2"), (3, "1x1"))] == [0, 0, 2, 2, 4, 0]
    monkeypatch.setenv("DPT_NUM_PROCESSES", "2")
    assert tmesh.ranks_to_launch(2, "", "cpu") == 0
    with pytest.raises(SystemExit, match="HxD"):
        tmesh.parse_topology("2by2")
    assert os.environ["DPT_NUM_PROCESSES"] == "2"
