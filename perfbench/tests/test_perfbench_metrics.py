"""The per-layer readers and the yardstick's arithmetic on hand-built inputs."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, trace
from perfbench.roofline import pyramid_sample as b3


class Ev:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, dev, a, b):
        self._n, self._d, self._a, self._b = name, dev, a, b

    def is_user_annotation(self):
        return self._n.startswith("perfbench.")

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda s: events})()})()


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def test_union_of_intervals():
    assert trace.union_seconds([]) == 0
    assert trace.union_seconds([(0, 10), (5, 20), (30, 40), (35, 36)]) == pytest.approx(30e-9)


def test_summary_of_a_synthetic_trace():
    """Window 0..1000 ns; kernels over 100..300 and 250..400 and 700..800;
    the host in aten::item over the first gap's middle."""
    events = [Ev("perfbench.window", CPU, 0, 1000), Ev("perfbench.hb_accumulate", CPU, 0, 600),
              Ev("perfbench.hb_accumulate", CUDA, 0, 600),
              Ev("aten::item", CPU, 420, 680), Ev("k_a", CUDA, 100, 300), Ev("k_b", CUDA, 250, 400),
              Ev("k_a", CUDA, 700, 800), Ev("early", CUDA, -50, 50)]
    s = trace.summarize(Prof(events), ["k_a"])
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(450e-9)  # 0..50 clipped, 100..400, 700..800
    assert s["device_ops"][0] == ["k_a", pytest.approx(300e-9)]
    assert s["kernels"]["k_a"] == [pytest.approx(200e-9), pytest.approx(100e-9)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps == {"perfbench.hb_accumulate:aten::item": pytest.approx(300e-9),
                    "perfbench.hb_accumulate": pytest.approx(50e-9), "host": pytest.approx(200e-9)}
    record = {"profile": s}
    for cell in ("register", "gt"):
        read = harness.load_reader(f"device_idle_share.{cell}")
        assert read(record) == pytest.approx(55.0)
    assert harness.load_reader("device_idle_share.gt")({"profile": dict(s, busy_s=0.0)}) is None


@pytest.mark.parametrize("metric,stages,per,expect", [
    ("hb_accumulate_ms.register", {"hb_accumulate": 3.0, "lm_ladder": 1.0}, ("iterations", 6), 500.0),
    ("refresh_ms.register", {"occlusion": 0.6, "visibility": 0.3, "variable_descriptors": 0.3},
     ("iterations", 6), 200.0),
    ("lm_ladder_ms.register", {"hb_accumulate": 3.0, "lm_ladder": 1.2}, ("iterations", 6), 200.0),
    ("occlusion_ms.gt", {"occlusion": 0.32, "gt_depth": 1.0}, ("images", 32), 10.0),
    ("gt_depth_ms.gt", {"occlusion": 0.32, "gt_depth": 0.64}, ("images", 32), 20.0),
    ("d2h_ms.gt", {"d2h": 0.16}, ("images", 32), 5.0),
])
def test_stage_readers_per_unit_of_work(metric, stages, per, expect):
    read = harness.load_reader(metric)
    assert read({"stages": stages, per[0]: per[1]}) == pytest.approx(expect)
    assert read({"stages": {}, per[0]: per[1]}) is None


def test_b3_bytes_of_a_hand_built_launch():
    """Two levels of a 16 x 16 image (level 1 is 8 x 8 at offset 256), two
    observations at scale 0.5 (levels 1 and 0) in one image: their taps
    touch rows y, y+1 at columns x, x+1 of both levels."""
    from dataset_pipeline_tpu_torch.ops.pyramid_sample import pyramid_layout

    layout = pyramid_layout([(16, 16), (8, 8)])
    # full-res (3.5, 3.5): level 0 taps (3..4, 3..4), level 1 at (1.5, 1.5) -> taps (1..2, 1..2)
    # full-res (11.5, 3.5): level 0 taps x 11..12 rows 3..4; level 1 x 5..6 rows 1..2
    pix = torch.tensor([[[3.5, 3.5], [11.5, 3.5]]])
    scale = torch.tensor([[0.5, 0.5]])
    floats = set()
    for x, y in ((3, 3), (11, 3)):
        for r in (y, y + 1):
            floats |= {r * 16 + x, r * 16 + x + 1}
    for x, y in ((1, 1), (5, 1)):
        for r in (y, y + 1):
            floats |= {256 + r * 8 + x, 256 + r * 8 + x + 1}
    sectors = {f // 8 for f in floats}
    assert b3.distinct_sectors(layout, pix, scale) == len(sectors)
    nbytes, flops = b3.launch_work(layout, pix, scale, with_derivs=True)
    assert nbytes == 32 * len(sectors) + 2 * (8 + 4 + 16 + 1) and flops == 200
    assert b3.bound_seconds(nbytes, flops) == pytest.approx(nbytes / 3.35e12)
    read = harness.load_reader("b3_roofline_share.register")
    assert read({"b3": {"seconds": 2e-3, "bound_s": 1e-3}}) == pytest.approx(50.0)
    assert read({}) is None
