"""Port vs JAX: the mesh-sharded photometric H,b (``parallel/photometric.py``)
and ``PhotometricOptimizer(mesh=...)``.

The problem is ``tests/test_parallel_photometric.py``'s (the two rendered
views of ``tests/scenes.synthetic_two_frame_problem``, image 1 perturbed),
carried into the port as numpy. JAX's sharded builders and its mesh
optimizer run here on the 8-virtual-device CPU mesh (chunks padded to 8 as
the JAX test pads them); the port's in two Gloo ranks on the CPU, one launch
for the whole file. Cases: the plain builder on the chunk of two images and
on a chunk of three (image 0 again), which the two ranks split unevenly;
the plain builder on that chunk with per-image geometry (JAX's
``geom_batched``: each image sees the level's rows in an order of its own,
so a rank that took another image's rows would not match); the rig builder (the images as a rig camera's: small extrinsics, the poses
as reference poses); the depth builder on synthetic depth maps; the mesh
optimizer over four iterations of scale 0.

Bounds, those of the JAX tests: per-image H, b rtol 1e-4 / atol 1e-3, the
cost 1e-5 relative, the counts equal (``test_parallel_photometric.py:67-71``);
the optimizer's poses within qvec 5e-6 / tvec 5e-5 (:102-103, :123-124).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parallel_ranks as ranks
from dataset_pipeline_tpu.models.lie import SE3 as JSE3
from dataset_pipeline_tpu.parallel.mesh import make_data_mesh
from dataset_pipeline_tpu.parallel.photometric import (
    make_sharded_hb_batch,
    make_sharded_hb_depth_batch,
    make_sharded_hb_rig_batch,
)
from dataset_pipeline_tpu.photometric.optimizer import PhotometricOptimizer
from dataset_pipeline_tpu.photometric.problem import build_image_pyramid
from dataset_pipeline_tpu_torch.parallel import mesh as tmesh
from test_parallel_photometric import _perturbed_problem

torch.set_num_threads(2)
H_RTOL, H_ATOL, COST_RTOL = 1e-4, 1e-3, 1e-5
Q_TOL, T_TOL = 5e-6, 5e-5
ITERATIONS = 4
EXTR = np.asarray([0.004, -0.002, 0.003, 0.02, 0.0, -0.01], np.float32)


def pad8(x, mask=False):
    """Pad the image axis to the 8-device mesh as the JAX test does: the
    last image repeated, its mask empty."""
    pad = 8 - x.shape[0]
    if mask:
        return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], bool)], 0)
    return jnp.concatenate([x, jnp.repeat(x[-1:], pad, 0)], 0)


@pytest.fixture(scope="module")
def jax_side():
    problem = _perturbed_problem()
    args = {"problem": ranks.problem_dict(problem), "level": 0, "iterations": ITERATIONS}
    mesh = make_data_mesh()
    opt = PhotometricOptimizer(problem, optimize_intrinsics=True)
    opt.current_scale = 0
    mask, s = opt._visibility(opt._occlusion_depths())[0][0][0]
    args["mask"], args["scale"] = np.asarray(mask), np.asarray(s)
    g, lv = problem.groups[0], problem.levels[0]
    radius = jnp.asarray(lv.radius, jnp.float32)
    want = {}
    for name, idx in (("hb_batch", [0, 1]), ("hb_batch_odd_chunk", [0, 1, 0])):
        i = jnp.asarray(idx)
        pyr = tuple(pad8(p[i]) for p in g.pyramid)
        want[name] = make_sharded_hb_batch(mesh)(
            g.camera, g.camera.params, pad8(g.poses.q[i]), pad8(g.poses.t[i]), lv.points,
            lv.neighbors, lv.fixed_descriptors, pyr, pad8(s[i]), pad8(mask[i], True), radius,
            True, True, geom_batched=False)
    idx, M = [0, 1, 0], lv.points.shape[0]
    rng = np.random.RandomState(5)
    perms = [np.arange(M)] + [rng.permutation(M) for _ in idx[1:]]
    nbr = np.asarray(lv.neighbors)
    gb = dict(idx=idx, points=np.stack([np.asarray(lv.points)[p] for p in perms]),
              neighbors=np.stack([np.argsort(p)[nbr[p]] for p in perms]).astype(nbr.dtype),
              desc=np.stack([np.asarray(lv.fixed_descriptors)[p] for p in perms]),
              mask=np.stack([np.asarray(mask)[k][p] for k, p in zip(idx, perms)]),
              scale=np.stack([np.asarray(s)[k][p] for k, p in zip(idx, perms)]))
    args["geom_batched"] = gb
    i = jnp.asarray(idx)
    want["hb_batch_geom_batched"] = make_sharded_hb_batch(mesh)(
        g.camera, g.camera.params, pad8(g.poses.q[i]), pad8(g.poses.t[i]),
        *(pad8(jnp.asarray(gb[k])) for k in ("points", "neighbors", "desc")),
        tuple(pad8(p[i]) for p in g.pyramid), pad8(jnp.asarray(gb["scale"])),
        pad8(jnp.asarray(gb["mask"]), True), radius, True, True, geom_batched=True)
    extr = JSE3.exp(jnp.asarray(EXTR))
    args["extr_q"], args["extr_t"] = np.asarray(extr.q), np.asarray(extr.t)
    pyr = tuple(pad8(p) for p in g.pyramid)
    want["hb_rig_batch"] = make_sharded_hb_rig_batch(mesh)(
        g.camera, g.camera.params, extr.q, extr.t, pad8(g.poses.q), pad8(g.poses.t), lv.points,
        lv.neighbors, lv.fixed_descriptors, pyr, pad8(s), pad8(mask, True), radius, True, True,
        geom_batched=False)
    H0, W0 = g.pyramid[0].shape[1:]
    yy, xx = np.mgrid[0:H0, 0:W0].astype(np.float32)
    depth = np.stack([2.2 + 0.1 * np.sin(xx / 17.0 + k) * np.cos(yy / 13.0) for k in range(2)])
    dpyr = build_image_pyramid(depth, len(g.pyramid))
    args["depth_pyramid"] = [np.asarray(p) for p in dpyr]
    want["hb_depth_batch"] = make_sharded_hb_depth_batch(mesh)(
        g.camera, g.camera.params, pad8(g.poses.q), pad8(g.poses.t), lv.points,
        tuple(pad8(p) for p in dpyr), pad8(s), pad8(mask, True), True, geom_batched=False)

    jp = _perturbed_problem()
    jopt = PhotometricOptimizer(jp, optimize_intrinsics=False, mesh=mesh)
    jopt.current_scale = 0
    jopt.run_on_current_scale(max_iterations=ITERATIONS)
    want["optimizer"] = (np.asarray(jp.groups[0].poses.q), np.asarray(jp.groups[0].poses.t))
    return args, {k: tuple(np.asarray(x) for x in v) for k, v in want.items()}


@pytest.fixture(scope="module")
def port(jax_side):
    args, _ = jax_side
    return [out for out, _ in tmesh.launch(ranks.photometric, 2, (args,))]


@pytest.mark.parametrize("name", ["hb_batch", "hb_batch_odd_chunk", "hb_batch_geom_batched",
                                  "hb_rig_batch", "hb_depth_batch"])
def test_sharded_hb_builders_match_jax(jax_side, port, name):
    """Per-image blocks gathered in image order and the summed cost and
    count, on both ranks, against JAX's shard_map'ed builder (its padding
    blocks zero)."""
    _, want = jax_side
    H, b, c, n = want[name]
    nb = 3 if name in ("hb_batch_odd_chunk", "hb_batch_geom_batched") else 2
    assert np.abs(H[nb:]).max() == 0.0 and int(n) > 0
    for r, out in enumerate(port):
        tH, tb, tc, tn = out[name]
        assert tH.shape == H[:nb].shape, (name, r)
        np.testing.assert_allclose(tH, H[:nb], rtol=H_RTOL, atol=H_ATOL, err_msg=f"{name} H")
        np.testing.assert_allclose(tb, b[:nb], rtol=H_RTOL, atol=H_ATOL, err_msg=f"{name} b")
        np.testing.assert_allclose(float(tc), float(c), rtol=COST_RTOL, err_msg=f"{name} cost")
        assert int(tn) == int(n)


def test_mesh_optimizer_matches_jax_mesh_optimizer(jax_side, port):
    """Four LM iterations of scale 0 with the H,b accumulation sharded over
    two ranks land where JAX's mesh optimizer does; both ranks hold the same
    poses, and the chunk was rounded up to a multiple of the mesh."""
    _, want = jax_side
    qa, ta = want["optimizer"]
    for out in port:
        q, t, cost, costs, chunk = out["optimizer"]
        assert chunk == 8 and cost < costs[0]
        np.testing.assert_allclose(q, qa, rtol=0, atol=Q_TOL)
        np.testing.assert_allclose(t, ta, rtol=0, atol=T_TOL)
    np.testing.assert_array_equal(port[0]["optimizer"][0], port[1]["optimizer"][0])
