"""The spans and counts inside the registrator's H,b accumulation
(``utils/timing.py``: ``stage``, ``span``, ``count``; the optimizer's
``_lm_accumulate`` and ``_hb_*``), on the CPU at a toy size.

- With ``timings=None`` nothing is recorded, no profiler range is opened,
  no CUDA event is made and nothing synchronises.
- With a dict, the six span keys and two counts appear after one
  ``hb_accumulate`` stage, the children inside it; the counts equal a hand
  count over the same calls; H, b and the cost are bit-equal either way.
- Under ``torch.profiler`` (and in a ``device_trace`` Chrome trace) the
  children are ranges inside ``hb_accumulate``.
- On the card (stood in for by fake events here) a span records a pair of
  events and reads them only after its stage's closing synchronisation.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from dataset_pipeline_tpu_torch.photometric import optimizer as tpo
from dataset_pipeline_tpu_torch.tools import image_registrator as reg
from dataset_pipeline_tpu_torch.utils import profiling, timing
from dataset_pipeline_tpu_torch.utils.synthetic import write_scene

torch.set_num_threads(2)

CHILDREN = ("hb_accumulate.geometry", "hb_accumulate.sample", "hb_accumulate.gram",
            "hb_accumulate.assemble")
SPAN_KEYS = CHILDREN + ("hb_accumulate.geometry.host", "hb_accumulate.gram.host")
COUNTS = ("hb_accumulate.rows", "hb_accumulate.residuals")
RANGES = ("hb_accumulate",) + CHILDREN


@pytest.fixture(scope="module")
def opt(tmp_path_factory):
    """The CLI's optimizer (fixed and variable residuals of weight 1,
    intrinsics optimised) on a two-image 160x120 scene at scale 0, its
    visibility and variable descriptors computed."""
    root = str(tmp_path_factory.mktemp("scene"))
    write_scene(root, 160, 120, 2800.0 * 160 / 3072, 2, 3000, seed=3, device="cpu")
    args, params = reg.parse_args([
        "--scan_alignment_path", os.path.join(root, "scene.mlp"), "--image_base_path",
        os.path.join(root, "images"), "--state_path", os.path.join(root, "state"),
        "--output_folder_path", os.path.join(root, "out"), "--device", "cpu"])
    problem, _, _, _ = reg.build_problem(args, params, torch.device("cpu"),
                                         timing.StageTimer(torch.device("cpu")))
    o = reg.make_optimizer(problem, args, params)
    o.current_scale = 0
    o.refresh()
    assert o.fixed_weight > 0 and o.variable_weight > 0
    return o


def _accumulate(o, timings):
    o.timings = timings
    try:
        with o._stage("hb_accumulate"):
            return o._lm_accumulate(o._frozen_vis)
    finally:
        o.timings = None


def _range_names(prof):
    return [e.name for e in prof.events() if e.name in RANGES]


def test_no_timings_records_nothing_and_opens_no_range(opt):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        H, b, cost, _ = _accumulate(opt, None)
    assert _range_names(prof) == []
    assert np.isfinite(H).all() and np.isfinite(b).all() and cost > 0


def test_spans_and_counts_appear_inside_the_stage(opt):
    t = {}
    _accumulate(opt, t)
    assert set(t) == {"hb_accumulate"} | set(SPAN_KEYS) | set(COUNTS)
    assert all(isinstance(t[k], float) and t[k] > 0 for k in ("hb_accumulate",) + SPAN_KEYS)
    assert all(type(t[k]) is int for k in COUNTS)
    assert sum(t[k] for k in CHILDREN) <= t["hb_accumulate"]
    assert t["hb_accumulate.geometry.host"] <= t["hb_accumulate.geometry"] + 1e-6
    assert 0 < t["hb_accumulate.residuals"] < t["hb_accumulate.rows"]


def test_counts_equal_a_hand_count(opt):
    """Rows: images x points of every ``_hb_batch`` call, one per level and
    residual type; residuals: the counts those calls return."""
    rows = residuals = calls = 0
    g = opt.p.groups[0]
    for bi, b in enumerate(opt._batches[0]):
        for l, level in enumerate(opt.p.levels):
            mask, sc = opt._frozen_vis[0][l][bi]
            for desc, extra, _ in opt._residual_sets(l, b):
                m = mask if extra is None else mask & extra
                out = tpo._hb_batch(g.camera, g.camera.params, g.poses.q[b.idx_dev],
                                    g.poses.t[b.idx_dev], level.points, level.neighbors, desc,
                                    b.flat, b.layout, sc, m, level.radius, True, True, b.pairs)
                rows += b.nb * level.points.shape[0]
                residuals += int(out[3])
                calls += 1
    assert calls == 2 * len(opt.p.levels)  # fixed and variable residuals on every level
    t = {}
    _accumulate(opt, t)
    assert (t["hb_accumulate.rows"], t["hb_accumulate.residuals"]) == (rows, residuals)


def test_the_cpu_geometry_counts_no_kernel_rows_and_launches_nothing(opt):
    """On the CPU ``_hb_batch`` takes the plain geometry (``ops/hb_geometry.py``):
    no ``hb_accumulate.geometry_kernel_rows``, no launch of either mode."""
    from dataset_pipeline_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    t = {}
    _accumulate(opt, t)
    assert "hb_accumulate.geometry_kernel_rows" not in t and t["hb_accumulate.rows"] > 0
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("model", ["PINHOLE", "THIN_PRISM_FISHEYE"])
def test_the_occlusion_projection_through_a_lens_is_spanned_and_counted(opt, model):
    """Under a camera with a lens the refresh's ``occlusion`` stage holds
    the span ``occlusion_depths.project`` and counts every (image, scan
    point) pair in ``occlusion_depths.distorted_points``; a pinhole camera
    records neither, and outside a stage nothing is recorded."""
    from dataset_pipeline_tpu_torch.models import cameras as cm

    g = opt.p.groups[0]
    pinhole = g.camera
    if model != "PINHOLE":
        g.camera = cm.make_camera(model, pinhole.width, pinhole.height,
                                  torch.cat([pinhole.params, torch.tensor(
                                      [0.28, 0.09, 2e-4, -3e-4, 2e-3, 1e-3, 4e-4, -2e-4])]),
                                  device="cpu")
    try:
        t = {}
        opt.timings = t
        with opt._stage("occlusion"):
            occl = opt._occlusion_depths()
        outside = {}
        opt.timings = outside
        assert torch.equal(opt._occlusion_depths()[0], occl[0]) and outside == {}
    finally:
        opt.timings = None
        g.camera = pinhole
    lens = model != "PINHOLE"
    assert ("occlusion_depths.project" in t) is lens
    assert t.get("occlusion_depths.distorted_points") == (
        g.num_images * opt.p.occlusion_points.shape[0] if lens else None)


def test_results_bit_equal_with_and_without_timings(opt):
    H0, b0, c0, _ = _accumulate(opt, None)
    H1, b1, c1, _ = _accumulate(opt, {})
    np.testing.assert_array_equal(H1, H0)
    np.testing.assert_array_equal(b1, b0)
    assert c1 == c0


def test_children_are_profiler_ranges_inside_the_stage(opt):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _accumulate(opt, {})
    events = [e for e in prof.events() if e.name in RANGES]
    outer = [e for e in events if e.name == "hb_accumulate"]
    assert len(outer) == 1
    lo, hi = outer[0].time_range.start, outer[0].time_range.end
    for name in CHILDREN:
        inner = [e for e in events if e.name == name]
        assert inner, name
        assert all(lo <= e.time_range.start <= e.time_range.end <= hi for e in inner)


def test_a_device_trace_of_one_iteration_holds_the_ranges(opt, tmp_path):
    state = [(g.camera.params.clone(), g.poses) for g in opt.p.groups]
    opt.timings = {}
    try:
        with profiling.device_trace(str(tmp_path)):
            opt.run_on_current_scale(max_iterations=1)
    finally:
        opt.timings = None
        opt._apply_state([p for p, _ in state], opt.p.rig_extrinsics, [q for _, q in state])
        opt.refresh()
    (name,) = os.listdir(tmp_path)
    names = {ev.get("name") for ev in json.load(open(tmp_path / name))["traceEvents"]}
    assert set(RANGES) <= names


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` that logs what is done with it."""

    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.log.append("event")
        self.t = None

    def record(self):
        self.t = time.perf_counter()
        self.log.append("record")

    def elapsed_time(self, end):
        self.log.append("read")
        return 1e3 * (end.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda.Event`` and ``torch.cuda.synchronize`` replaced by
    loggers, ``torch.profiler.record_function`` counted; yields the log."""
    log = []
    _FakeEvent.log = log
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: log.append("sync"))
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        log.append(f"range {name}")
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    yield log


def test_on_the_card_none_makes_no_event_range_or_sync(fake_card):
    dev = torch.device("cuda")
    with timing.stage(None, "hb_accumulate", dev):
        with timing.span(None, "hb_accumulate.geometry", dev, host=True):
            pass
        timing.count(None, "hb_accumulate.rows", 5)
    assert fake_card == []


def test_on_the_card_a_span_reads_its_events_after_the_stage_syncs(fake_card):
    dev = torch.device("cuda")
    t = {}
    with timing.stage(t, "hb_accumulate", dev):
        with timing.span(t, "hb_accumulate.geometry", dev, host=True):
            time.sleep(0.002)
        with timing.span(t, "hb_accumulate.sample", dev):
            pass
        assert "hb_accumulate.geometry" not in t and "read" not in fake_card
        assert t["hb_accumulate.geometry.host"] >= 0.002
    assert fake_card[:2] == ["range hb_accumulate", "sync"]
    assert fake_card.count("sync") == 2 and fake_card.count("event") == 4
    assert fake_card.index("read") > len(fake_card) - 1 - fake_card[::-1].index("sync")
    assert "range hb_accumulate.geometry" in fake_card and "range hb_accumulate.sample" in fake_card
    assert t["hb_accumulate.geometry"] >= 0.002 and "hb_accumulate.sample.host" not in t
    assert sum(t[k] for k in ("hb_accumulate.geometry", "hb_accumulate.sample")) <= t["hb_accumulate"]


def test_on_the_card_a_span_outside_a_stage_of_its_dict_raises(fake_card):
    dev = torch.device("cuda")
    with pytest.raises(RuntimeError, match="open stage"):
        with timing.stage({}, "other", dev):
            with timing.span({}, "hb_accumulate.sample", dev):
                pass


def test_counts_print_as_integers():
    text = timing.stages_text({"hb_accumulate": 1.23456, "hb_accumulate.rows": 36300000})
    assert text == "hb_accumulate 1.235; counts: hb_accumulate.rows 36300000"
    assert timing.stages_text({"occlusion": 0.5}) == "occlusion 0.500"
