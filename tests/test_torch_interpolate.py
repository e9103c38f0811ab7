"""Port vs JAX: ``ops/interpolate.py`` and the Huber / Tukey / none halves of
``ops/robust.py``.

The cases of ``tests/test_interpolate.py`` (exact values at pixel centres,
midpoint averages, the validity bounds, the pyramid coordinate convention,
analytic derivatives) run through both packages on the same seeded images
and coordinates, including points outside the image (whose values come from
clamped taps) and on the bounds. Values, derivatives and validity must be
equal bit for bit: both compute the same float32 expression op by op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_pipeline_tpu.ops import interpolate as ji
from dataset_pipeline_tpu.ops import robust as jr
from dataset_pipeline_tpu_torch.ops import interpolate as ti
from dataset_pipeline_tpu_torch.ops import robust as tr

torch.set_num_threads(2)


def _inputs(seed, h=9, w=13, n=500):
    rng = np.random.RandomState(seed)
    img0 = (rng.rand(h, w) * 255).astype(np.float32)
    img1 = (rng.rand(2 * h, 2 * w) * 255).astype(np.float32)
    x = rng.uniform(-1.5, w + 0.5, n).astype(np.float32)
    y = rng.uniform(-1.5, h + 0.5, n).astype(np.float32)
    x[:20] = np.arange(20) % w  # pixel centres and the bounds
    y[:20] = np.arange(20) % h
    x[20:24] = [-0.01, w - 1.0, w - 1.01, 0.0]
    z = rng.rand(n).astype(np.float32)
    return img0, img1, x, y, z


def _equal(ref, got):
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_bilinear_matches_jax(seed):
    img0, _, x, y, _ = _inputs(seed)
    J = (jnp.asarray(img0), jnp.asarray(x), jnp.asarray(y))
    T = (torch.from_numpy(img0), torch.from_numpy(x), torch.from_numpy(y))
    _equal(ji.bilinear(*J), ti.bilinear(*T))
    _equal(ji.bilinear_with_derivatives(*J), ti.bilinear_with_derivatives(*T))
    ok = ti.bilinear(*T)[1].numpy()
    assert ok.any() and not ok.all()


@pytest.mark.parametrize("seed", [2, 3])
def test_trilinear_matches_jax(seed):
    img0, img1, x, y, z = _inputs(seed)
    J = [jnp.asarray(a) for a in (img0, img1, x, y, z)]
    T = [torch.from_numpy(a) for a in (img0, img1, x, y, z)]
    _equal(ji.trilinear(*J), ti.trilinear(*T))
    _equal(ji.trilinear_with_derivatives(*J), ti.trilinear_with_derivatives(*T))


def test_exact_cases_of_the_reference_tests():
    y, x = np.mgrid[0:4, 0:5]
    img = torch.from_numpy((10 * y + x).astype(np.float32))
    v, ok = ti.bilinear(img, torch.tensor(2.0), torch.tensor(1.0))
    assert bool(ok) and float(v) == 12.0
    v, ok = ti.bilinear(img, torch.tensor(4.0), torch.tensor(1.0))
    assert not bool(ok)
    # a linear image: the analytic derivatives are its slopes
    _, dx, dy, ok = ti.bilinear_with_derivatives(img, torch.tensor(1.3), torch.tensor(2.2))
    assert bool(ok) and abs(float(dx) - 1.0) < 1e-5 and abs(float(dy) - 10.0) < 1e-5


@pytest.mark.parametrize("name", ["huber", "tukey", "none"])
def test_robust_matches_jax(name):
    rng = np.random.RandomState(4)
    k = jr.DEFAULT_DEPTH_TUKEY if name == "tukey" else jr.DEFAULT_COLOR_HUBER
    r = (rng.randn(1000) * 2 * k).astype(np.float32)
    r[:3] = [0.0, k, -k]
    for jf, tf in zip(jr.ROBUST[name], tr.ROBUST[name]):
        np.testing.assert_array_equal(tf(torch.from_numpy(r), k).numpy(),
                                      np.asarray(jf(jnp.asarray(r), k)))
    assert tr.DEFAULT_DEPTH_TUKEY == jr.DEFAULT_DEPTH_TUKEY
    assert tr.DEFAULT_COLOR_HUBER == jr.DEFAULT_COLOR_HUBER
