"""The readers of the program's spans and counts inside H,b on hand-built
records (each one's value, and None where the program records nothing, as
a program without the spans does), and a traced toy run that reports every
one of them."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests.toy import run_toy, toy_base

STAGES = {"hb_accumulate": 6.0, "hb_accumulate.geometry": 3.6, "hb_accumulate.geometry.host": 3.0,
          "hb_accumulate.sample": 0.06, "hb_accumulate.gram": 1.2, "hb_accumulate.gram.host": 0.6,
          "hb_accumulate.assemble": 0.12, "hb_accumulate.rows": 4000, "hb_accumulate.residuals": 1000}
READERS = {"hb_geometry_ms.register": 600.0, "hb_geometry_host_ms.register": 500.0,
           "hb_sample_ms.register": 10.0, "hb_gram_ms.register": 200.0,
           "hb_gram_host_ms.register": 100.0, "hb_assemble_ms.register": 20.0,
           "hb_residual_share.register": 25.0}


@pytest.mark.parametrize("metric,expect", sorted(READERS.items()))
def test_reader_of_a_program_span_or_count(metric, expect):
    read = harness.load_reader(metric)
    assert read({"stages": STAGES, "iterations": 6}) == pytest.approx(expect)
    old = {k: v for k, v in STAGES.items() if k == "hb_accumulate"}
    assert read({"stages": old, "iterations": 6}) is None
    assert read({}) is None


def test_no_share_of_no_rows():
    read = harness.load_reader("hb_residual_share.register")
    assert read({"stages": dict(STAGES, **{"hb_accumulate.rows": 0})}) is None


def test_a_traced_toy_run_reports_every_reader(tmp_path):
    res = run_toy(toy_base(tmp_path), "toy.register", trace=True)
    assert res["correct"] is True
    got = {m: res["metrics"][m]["value"] for m in READERS}
    assert all(v > 0 for v in got.values())
    children = ("hb_geometry_ms.register", "hb_sample_ms.register", "hb_gram_ms.register",
                "hb_assemble_ms.register")
    assert sum(got[m] for m in children) <= res["metrics"]["hb_accumulate_ms.register"]["value"]
    assert got["hb_residual_share.register"] < 100.0
