"""The Gram dispatch of ``ops/hb_gram.py:gram_assemble`` under
``photometric/optimizer.py:_hb_batch`` and ``_hb_rig_batch`` on the CPU:
CPU tensors take the plain ``gram_assemble_plain``, launch nothing and count
no ``hb_accumulate.gram_kernel_rows``; J on the card always goes to the
kernel, which takes float32 J up to 24 wide and refuses anything else, so
that nothing on the card falls back to the plain body. Where the kernel is
chosen the optimizer counts nb x M rows and returns the kernel's result
unchanged. The kernel itself is held to the plain body under emulation
(``tests/test_torch_kernels_emulated.py``) and on the card
(``tests/test_torch_cuda.py``)."""

import inspect
import re
from types import SimpleNamespace

import pytest
import torch

from dataset_pipeline_tpu_torch import kernels
from dataset_pipeline_tpu_torch.models.lie import SE3
from dataset_pipeline_tpu_torch.ops import hb_gram
from dataset_pipeline_tpu_torch.parallel import joint_ba
from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
from dataset_pipeline_tpu_torch.utils.timing import stage
from test_torch_hb_geometry import _batch_args

torch.set_num_threads(2)


def _rig_args(model, per_image):
    """``_hb_rig_batch``'s arguments: ``_batch_args``'s chunk as the
    reference poses, extrinsics a small motion."""
    cam, params, q, t, *rest = _batch_args(model, per_image)
    extr = SE3.exp(torch.tensor([0.01, -0.02, 0.005, 0.002, 0.001, -0.003]))
    return (cam, params, extr.q, extr.t, q, t, *rest)


def _spy_plain(monkeypatch):
    calls = []
    plain = hb_gram.gram_assemble_plain

    def wrapped(*a):
        calls.append(a[0].shape)
        return plain(*a)

    monkeypatch.setattr(hb_gram, "gram_assemble_plain", wrapped)
    return calls


@pytest.mark.parametrize("rig", [False, True])
@pytest.mark.parametrize("per_image", [False, True])
def test_cpu_tensors_take_the_plain_body(rig, per_image, monkeypatch):
    """On the CPU the plain body runs once per call, the kernel never,
    nothing is launched and ``gram_kernel_rows`` is not counted."""
    calls = _spy_plain(monkeypatch)
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("the kernel ran"))
    fn, args = (tpo._hb_rig_batch, _rig_args("PINHOLE", per_image)) if rig else (
        tpo._hb_batch, _batch_args("PINHOLE", per_image))
    before = dict(kernels.LAUNCHES)
    t = {}
    with stage(t, "hb_accumulate", torch.device("cpu")):
        H, b, cost, n = fn(*args, True, True, timings=t)
    V = 4 + (12 if rig else 6)
    assert calls == [(2, 500, V)] and H.shape == (2, V, V) and int(n) > 0
    assert kernels.LAUNCHES == before and "hb_accumulate.gram_kernel_rows" not in t
    assert "hb_accumulate.gram" in t


@pytest.mark.parametrize("rig", [False, True])
def test_where_the_kernel_is_chosen_it_counts_the_rows_and_its_result_is_returned(rig,
                                                                                monkeypatch):
    """With the kernel chosen (stood in for by the plain body on the CPU),
    the optimizer calls it once with the plain body's arguments, counts nb x
    M ``gram_kernel_rows`` and returns its result as it is, inside the
    ``hb_accumulate.gram`` span."""
    got = []

    def kernel(*a):
        got.append(a)
        return hb_gram.gram_assemble_plain(*a)

    monkeypatch.setattr(hb_gram, "uses_kernel", lambda J: True)
    monkeypatch.setattr(hb_gram, "gram_assemble", kernel)
    calls = _spy_plain(monkeypatch)
    fn, args = (tpo._hb_rig_batch, _rig_args("SIMPLE_PINHOLE", False)) if rig else (
        tpo._hb_batch, _batch_args("SIMPLE_PINHOLE", False))
    t = {}
    with stage(t, "hb_accumulate", torch.device("cpu")):
        out = fn(*args, True, True, timings=t)
    assert len(got) == 1 and len(calls) == 1  # the stand-in's own call of the plain body
    assert t["hb_accumulate.gram_kernel_rows"] == 2 * 500 and t["hb_accumulate.gram"] > 0
    ref = hb_gram.gram_assemble_plain(*got[0])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device,dtype,V,kernel", [
    ("cuda", torch.float32, 6, True), ("cuda", torch.float32, 9, True),
    ("cuda", torch.float32, 10, True), ("cuda", torch.float32, 16, True),
    ("cuda", torch.float32, 18, True), ("cuda", torch.float32, 19, True),
    ("cuda", torch.float32, 24, True), ("cuda", torch.float64, 10, True),
    ("cpu", torch.float32, 10, False)])
def test_the_kernel_is_chosen_by_device_dtype_and_width(device, dtype, V, kernel):
    """Every J on the card takes the kernel (float64 or too wide J then
    raises in the wrapper); CPU J takes the plain body."""
    J = SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(8, 1000, V))
    assert hb_gram.uses_kernel(J) is kernel


def _gram_args(J):
    return (J, torch.zeros(2, 50), torch.ones(2, 50, dtype=torch.bool),
            torch.zeros(50, 4, dtype=torch.int64), torch.zeros(50, 4),
            torch.ones(2, 50, dtype=torch.bool))


@pytest.mark.parametrize("device,dtype,V", [
    ("cpu", torch.float32, 10), ("cpu", torch.float64, 10), ("cuda", torch.float64, 10),
    ("cuda", torch.float32, 25), ("cuda", torch.float16, 24)])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(device, dtype, V, monkeypatch):
    """CPU tensors, and on the card float64 J or J wider than 24, never
    reach the entry point: on the CPU the wrapper returns the plain body's
    result, on the card it raises; nothing is launched."""
    J = (torch.zeros(2, 50, V, dtype=dtype) if device == "cpu" else
         SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(2, 50, V)))
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("the kernel ran"))
    before = dict(kernels.LAUNCHES)
    if device == "cpu":
        for a, b in zip(hb_gram.gram_assemble(*_gram_args(J)),
                        hb_gram.gram_assemble_plain(*_gram_args(J))):
            assert torch.equal(a, b)
    else:
        with pytest.raises(ValueError, match="the kernel takes"):
            hb_gram.gram_assemble(*_gram_args(J))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype,V", [(torch.float64, 10), (torch.float32, 25)])
def test_the_dispatch_on_the_card_raises_rather_than_take_the_plain_body(dtype, V, monkeypatch):
    """J on the card that the kernel cannot take raises from the dispatch;
    the plain body is never called."""
    calls = _spy_plain(monkeypatch)
    J = SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=(2, 50, V))
    with pytest.raises(ValueError, match="the kernel takes"):
        hb_gram.gram_assemble(*_gram_args(J))
    assert calls == []


def test_joint_ba_keeps_the_plain_body_in_float64():
    """Joint BA's ``_image_gram`` calls the plain ``gram_assemble_plain`` on
    float64 J on purpose, never the kernel's dispatch."""
    src = inspect.getsource(joint_ba._image_gram)
    assert "gram_assemble_plain(J[None].double()" in src
    assert not re.search(r"\bgram_assemble\(|hb_gram\.", inspect.getsource(joint_ba))
    assert joint_ba.gram_assemble_plain is hb_gram.gram_assemble_plain
