"""The geometry dispatch of ``ops/hb_geometry.py`` under
``photometric/optimizer.py:_hb_batch`` on the CPU: CPU tensors take the
plain version (``torch.func.jvp`` under ``vmap``) for every camera model,
launch nothing and count no ``hb_accumulate.geometry_kernel_rows``; the
kernel is chosen only for points on the card and the models it implements,
and ``project`` and ``jacobian`` hand anything else to the plain version.
The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu_torch import kernels
from dataset_pipeline_tpu_torch.models import cameras as cm
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.ops import hb_geometry as hg
from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps
from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
from dataset_pipeline_tpu_torch.utils.timing import stage

torch.set_num_threads(2)

PARAMS = {"PINHOLE": [150.0, 156.0, 79.5, 59.5], "SIMPLE_PINHOLE": [150.0, 79.5, 59.5],
          "OPENCV": [150.0, 156.0, 79.5, 59.5, 0.01, -0.002, 1e-4, -2e-4],
          "THIN_PRISM_FISHEYE": [150.0, 156.0, 79.5, 59.5, 0.28, 0.09, 2e-4, -3e-4, 2e-3, 1e-3,
                                 4e-4, -2e-4]}


def _batch_args(model, per_image, nb=2, M=500):
    """``_hb_batch``'s arguments on the CPU: a 160x120 camera, 4 pyramid
    levels, points (M,3) or (nb,M,3) about 3 in front of it, K = 4
    neighbours."""
    rng = np.random.RandomState(7)
    cam = cm.make_camera(model, 160, 120, PARAMS[model], device="cpu")
    shape = (nb, M) if per_image else (M,)
    pts = torch.from_numpy((rng.randn(*shape, 3) * [0.5, 0.5, 1.0] + [0, 0, 3]).astype(np.float32))
    pose = SE3.exp(torch.from_numpy((0.02 * rng.randn(nb, 6)).astype(np.float32)))
    pyr = [torch.from_numpy((rng.rand(nb, 120, 160) * 255).astype(np.float32))]
    for _ in range(3):
        h, w = pyr[-1].shape[1:]
        pyr.append(pyr[-1].reshape(nb, h // 2, 2, w // 2, 2).mean((2, 4)))
    flat, layout = tps.flatten_pyramid(pyr)
    nbr = torch.from_numpy(rng.randint(0, M, shape + (4,)))
    desc = torch.from_numpy(rng.randn(*shape, 4).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.1, 1.9, (nb, M)).astype(np.float32))
    contrib = torch.from_numpy(rng.rand(nb, M) < 0.9)
    return (cam, cam.params, pose.q, pose.t, pts, nbr, desc, flat, layout, scale, contrib, 0.004)


def _no_kernel(monkeypatch):
    """Fail the test if anything reaches the kernel library."""
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("the kernel library was loaded"))


@pytest.mark.parametrize("model", sorted(PARAMS))
@pytest.mark.parametrize("per_image", [False, True])
def test_cpu_tensors_take_the_plain_version(model, per_image, monkeypatch):
    """``_hb_batch`` on CPU tensors: the plain version gives the geometry,
    once in each mode, the kernel is never reached, nothing is launched and
    ``geometry_kernel_rows`` is not counted."""
    calls = []

    def spy(name):
        fn = getattr(hg, name)

        def wrapped(*a):
            calls.append(name)
            return fn(*a)

        monkeypatch.setattr(hg, name, wrapped)

    spy("project_plain")
    spy("jacobian_plain")
    _no_kernel(monkeypatch)
    args = _batch_args(model, per_image)
    before = dict(kernels.LAUNCHES)
    t = {}
    with stage(t, "hb_accumulate", torch.device("cpu")):
        H, b, cost, n = tpo._hb_batch(*args, True, True, timings=t)
    assert calls == ["project_plain", "jacobian_plain"]
    assert kernels.LAUNCHES == before and "hb_accumulate.geometry_kernel_rows" not in t
    V = len(PARAMS[model]) + 6
    assert H.shape == (2, V, V) and b.shape == (2, V) and int(n) > 0
    assert bool(torch.isfinite(H).all() and torch.isfinite(b).all() and torch.isfinite(cost))


@pytest.mark.parametrize("model,kernel", [("PINHOLE", True), ("SIMPLE_PINHOLE", True),
                                          ("OPENCV", False), ("SIMPLE_RADIAL", False),
                                          ("THIN_PRISM_FISHEYE", True)])
def test_the_kernel_is_chosen_by_device_and_camera_model(model, kernel):
    cam = SimpleNamespace(spec=cm.CAMERA_MODELS[model])
    assert hg.uses_kernel(cam, SimpleNamespace(device=torch.device("cuda", 0))) is kernel
    assert hg.uses_kernel(cam, torch.zeros(4, 3)) is False
    assert set(hg.KERNEL_MODELS) <= set(cm.CAMERA_MODELS)


@pytest.mark.parametrize("model", ["PINHOLE", "OPENCV"])
def test_the_kernel_wrappers_refuse_what_the_kernel_does_not_take(model, monkeypatch):
    """CPU tensors, or a model the kernel does not implement, never reach
    the entry points: ``project`` and ``jacobian`` return the plain
    version's result bit for bit and launch nothing."""
    cam, params, q, t, pts = _batch_args(model, False)[:5]
    d = torch.rand(2, 500)
    _no_kernel(monkeypatch)
    before = dict(kernels.LAUNCHES)
    for a, b in zip(hg.project(cam, params, q, t, pts), hg.project_plain(cam, params, q, t, pts)):
        assert torch.equal(a, b)
    assert torch.equal(hg.jacobian(cam, params, q, t, pts, 0.004, d, d, d, True, True),
                       hg.jacobian_plain(cam, params, q, t, pts, 0.004, d, d, d, True, True))
    assert kernels.LAUNCHES == before
