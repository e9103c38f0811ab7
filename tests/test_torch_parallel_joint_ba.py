"""Port vs JAX: the sharded joint-BA systems (``parallel/joint_ba.py``,
``parallel/joint_ba_rig.py``) over four Gloo ranks on the CPU.

Scenes: those of ``tests/test_torch_joint_ba.py`` (two two-scan scenes of two
images each, ICP rows) and ``tests/test_torch_joint_ba_rig.py`` (two frames
of a two-camera rig with depth rows), built by the JAX package and carried
into the ranks as numpy; one launch of four ranks for the file. Four ranks
shard the four images one each (the ICP rows padded to a multiple of four)
and the two rig frames over four slots, two of them padding.

Each rank's normal-equation pieces are summed (Hkk, bk, cost) and gathered
(Hki, Hii, bi) over the mesh and held against JAX's one-device pieces
(compiled: ``test_torch_joint_ba.py`` shows its compiled and op-by-op
pieces within the rule of each other) by the
port's ``close_gram`` rule (rtol 1e-4 of sqrt(H_ii H_jj) / atol 1e-3, the
cost 1e-5; ``test_torch_joint_ba.py``); the step at two dampings against
JAX's on its 8-device mesh: the step within 2 % of its largest entry, the
cost 1e-5, the counts equal, every rank with the same step.
"""

import jax
import numpy as np
import pytest
import torch

import test_joint_ba_system as tjs
import test_torch_joint_ba as tj
import test_torch_joint_ba_rig as tjr
import torch_parallel_ranks as ranks
from dataset_pipeline_tpu.parallel import joint_ba as jjb
from dataset_pipeline_tpu.parallel import joint_ba_rig as jjr
from dataset_pipeline_tpu.parallel.mesh import make_data_mesh
from dataset_pipeline_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
WORLD = 4
LAMS = {"plain": (1e-3, 1.0), "rig": (1e-2, 1.0)}


def scene_data(scenes):
    return [dict(problem=ranks.problem_dict(s.problem), level_idx=s.level_idx,
                 icp=None if s.icp is None else tuple(np.asarray(a) for a in s.icp),
                 icp_weight=s.icp_weight) for s in scenes]


@pytest.fixture(scope="module")
def jax_side():
    """Per route: the ranks' inputs, JAX's one-device normal-equation
    pieces, and JAX's steps on the 8-device mesh, at the initial state."""
    routes = {
        "plain": (tjs._make_scenes()[1], jjb.pack_scenes, jjb.JointBASystem, jjb.make_state,
                  tj.jax_normal_equations, {}),
        "rig": ([tjr.depth_rig_scene()], jjr.pack_rig_scenes, jjr.RigJointBASystem,
                jjr.make_rig_state, tjr.jax_rig_normal_equations,
                {"depth_weight": tjr.DEPTH_WEIGHT})}
    args, want = {"rig_depth_weight": tjr.DEPTH_WEIGHT}, {}
    for name, (scenes, pack_fn, system_cls, make, normal_equations, kw) in routes.items():
        pack = pack_fn(make_data_mesh(1), scenes, optimize_intrinsics=True, **kw)
        system = system_cls(pack)
        st = make(pack)
        jv, js = system.visibility(st)
        pieces = jax.jit(lambda a, b, c, p=pack, f=normal_equations: f(p, a, b, c))(st, jv, js)
        pack8 = pack_fn(make_data_mesh(8), scenes, optimize_intrinsics=True, **kw)
        system8 = system_cls(pack8)
        st8 = make(pack8)
        v8, s8 = system8.visibility(st8)
        steps = {lam: tuple(np.asarray(x) for x in system8.step(st8, v8, s8, lam))
                 for lam in LAMS[name]}
        n = pack.m_pad if name == "plain" else pack.f_pad
        args[name] = {"scenes": scene_data(scenes), "state": tj.jax_state_np(st),
                      "lams": LAMS[name]}
        want[name] = {"pieces": pieces, "steps": steps, "n": n,
                      "cost": tuple(np.asarray(x) for x in system.cost(st, jv, js))}
    return args, want


@pytest.fixture(scope="module")
def port(jax_side):
    args, _ = jax_side
    return [out for out, _ in tmesh.launch(ranks.joint_ba, WORLD, (args,))]


@pytest.mark.parametrize("route", ["plain", "rig"])
def test_sharded_normal_equations_match_jax(jax_side, port, route):
    """The pieces summed and gathered over four ranks (the padding images
    or frames add nothing), and the frozen-visibility cost summed over them."""
    _, want = jax_side
    n = want[route]["n"]
    for out in port:
        got = out[route]
        assert got["pad"] == -(-n // WORLD) * WORLD
        Hkk, bk, Hki, Hii, bi, cost = got["pieces"]
        assert not Hii[n:].any()
        tj.check_normal_equations((Hkk, bk, Hki[:n], Hii[:n], bi[:n], cost), want[route]["pieces"])
        tc, tn = got["cost"]
        jc, jn = want[route]["cost"]
        assert int(tn) == int(jn)
        tj.close(tc, float(jc), tj.COST_RTOL, 0, "frozen-visibility cost")


@pytest.mark.parametrize("route", ["plain", "rig"])
def test_sharded_step_matches_jax_on_8_devices(jax_side, port, route):
    """The damped step: S and rhs summed over the ranks, the images' steps
    gathered, the same on every rank."""
    _, want = jax_side
    n = want[route]["n"]
    for lam, (jk, ji, jc, jn) in want[route]["steps"].items():
        for out in port:
            tk, ti, tc, tn = out[route]["steps"][lam]
            assert int(tn) == int(jn)
            tj.close(tc, float(jc), tj.COST_RTOL, 0, f"{route} step cost lam {lam}")
            tj.close_step(tk, jk, f"{route} x_keep lam {lam}")
            tj.close_step(ti[:n], ji[:n], f"{route} x_img lam {lam}")
            assert not ti[n:].any()
            np.testing.assert_array_equal(tk, port[0][route]["steps"][lam][0])
            np.testing.assert_array_equal(ti, port[0][route]["steps"][lam][1])
