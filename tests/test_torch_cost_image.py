"""Port vs JAX: ``PhotometricOptimizer.render_cost_image`` (the cost fixed /
variable / combined display modes) and ``check_for_optimum_numerically``.

The cases of ``tests/test_cost_image.py`` and
``tests/test_photometric_jacobians.py:308`` on the two-frame scene, both
packages from the same state and the same frozen observations (the JAX
visibility carried over): the same pixels are finite, and their costs agree
within 1e-4 relative (float32 sums of the descriptor norms in another order;
measured ~1e-5); with the observations cache on, the same. The numerical
optimum check flags the same state and, with ``go_to_optimum``, lowers the
frozen-visibility cost as JAX's does, to poses within 1e-6.
"""

import numpy as np
import pytest
import torch

import dataset_pipeline_tpu.photometric.optimizer as jpo
import jax.numpy as jnp
from dataset_pipeline_tpu.models.lie import SE3 as JSE3
from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
from scenes import synthetic_two_frame_problem
from test_torch_photometric import _to_port
from test_torch_rig import _vis_to_port

torch.set_num_threads(2)


@pytest.mark.parametrize("obs_cache", [False, True], ids=["dense", "obs_cache"])
def test_render_cost_image_matches_jax(obs_cache):
    jp = synthetic_two_frame_problem()
    tp = _to_port(jp)
    jo = jpo.PhotometricOptimizer(jp, optimize_intrinsics=False, variable_weight=1.0)
    to = tpo.PhotometricOptimizer(tp, optimize_intrinsics=False, variable_weight=1.0)
    jo.current_scale = to.current_scale = 0
    if obs_cache:  # the JAX package groups a cache's images by view size: own chunks
        jo.build_observations_cache()
        to.build_observations_cache()
    jv = jo._visibility(jo._occlusion_depths())
    tv = to._visibility(to._occlusion_depths()) if obs_cache else _vis_to_port(jv)
    imgs = {}
    for b in range(2):
        for which in ("fixed", "variable", "combined"):
            a = jo.render_cost_image(0, b, which, vis=jv)
            c = to.render_cost_image(0, b, which, vis=tv)
            assert c.shape == a.shape == (120, 160) and c.dtype == np.float32
            np.testing.assert_array_equal(np.isfinite(c), np.isfinite(a))
            f = np.isfinite(a)
            assert f.sum() > 500 and (c[f] >= 0).all()
            np.testing.assert_allclose(c[f], a[f], rtol=5e-4, atol=1e-4)
            imgs[which] = c
    f = np.isfinite(imgs["fixed"]) & np.isfinite(imgs["variable"])
    assert imgs["variable"][f].mean() < imgs["fixed"][f].mean()
    with pytest.raises(ValueError):
        to.render_cost_image(0, 0, "nope", vis=tv)


def test_check_for_optimum_numerically_matches_jax():
    jp = synthetic_two_frame_problem()
    g = jp.groups[0]
    d = np.zeros((2, 6), np.float32)
    d[1] = [0.01, -0.008, 0.006, 0.004, -0.003, 0.005]
    g.poses = JSE3.exp(jnp.asarray(d)).compose(g.poses)
    tp = _to_port(jp)
    jo = jpo.PhotometricOptimizer(jp, optimize_intrinsics=False)
    to = tpo.PhotometricOptimizer(tp, optimize_intrinsics=False)
    jo.current_scale = to.current_scale = 0
    jo._frozen_vis = jo._visibility(jo._occlusion_depths())
    to._frozen_vis = _vis_to_port(jo._frozen_vis)
    offsets = to._var_layout()
    np.testing.assert_array_equal(to._component_deltas(*offsets), jo._component_deltas(*offsets))
    params = [x.camera.params for x in to.p.groups]
    before = to._total_cost(params, [x.poses for x in to.p.groups], to._frozen_vis)
    kw = dict(go_to_optimum=True, immediate_step_threshold=np.inf, print_errors=False)
    assert not to.check_for_optimum_numerically(**kw)
    assert not jo.check_for_optimum_numerically(**kw)
    after = to._total_cost(params, [x.poses for x in to.p.groups], to._frozen_vis)
    assert after < before
    np.testing.assert_allclose(to.p.groups[0].poses.t.numpy(), np.asarray(jo.p.groups[0].poses.t),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(to.p.groups[0].poses.q.numpy(), np.asarray(jo.p.groups[0].poses.q),
                               rtol=0, atol=1e-6)


def test_intrinsics_deltas_and_run_schedule():
    """With intrinsics the validator's deltas are 0.1 for the first four
    parameters, then 1e-3 / 5e-4 per pose; ``run`` walks every scale down to
    0, calling ``on_scale_done`` after each."""
    jp = synthetic_two_frame_problem()
    to = tpo.PhotometricOptimizer(_to_port(jp), optimize_intrinsics=True)
    offsets = to._var_layout()
    d = to._component_deltas(*offsets)
    np.testing.assert_array_equal(d[:4], 0.1)
    np.testing.assert_array_equal(d[4:7], 1e-3)
    np.testing.assert_array_equal(d[7:10], 5e-4)
    seen = []
    out = to.run(max_iterations_per_scale=2, on_scale_done=lambda o, r: seen.append(
        (o.current_scale, r.iterations)))
    assert out is to.p and [s for s, _ in seen] == [0] and seen[0][1] <= 2
