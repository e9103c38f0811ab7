"""The reader of the geometry kernel's share of H,b's rows on hand-built
records: its value, and None where the program counts no kernel rows (a
program without the kernel, or on the CPU) or no rows."""

from __future__ import annotations

import pytest

from perfbench import harness

STAGES = {"hb_accumulate": 6.0, "hb_accumulate.rows": 4000, "hb_accumulate.residuals": 1000}


@pytest.mark.parametrize("kernel_rows,expect", [(4000, 100.0), (1000, 25.0), (0, 0.0)])
def test_share_of_the_rows_the_kernel_computed(kernel_rows, expect):
    read = harness.load_reader("hb_geometry_kernel_share.register")
    stages = dict(STAGES, **{"hb_accumulate.geometry_kernel_rows": kernel_rows})
    assert read({"stages": stages, "iterations": 6}) == pytest.approx(expect)


def test_no_share_without_the_count_or_the_rows():
    read = harness.load_reader("hb_geometry_kernel_share.register")
    assert read({"stages": STAGES, "iterations": 6}) is None
    assert read({"stages": dict(STAGES, **{"hb_accumulate.rows": 0,
                                            "hb_accumulate.geometry_kernel_rows": 0})}) is None
    assert read({}) is None


def test_the_metric_is_declared_for_both_register_cells():
    metrics = {x["name"]: x for x in harness.load_benchmark()["per_layer"]}
    m = metrics["hb_geometry_kernel_share.register"]
    assert (m["layer"], m["moves"], m["source"]) == ("H,b geometry", "lm_iteration_s",
                                                      "program_counter")
    assert m["workloads"] == ["dslr_register.scale0", "dslr_register.coarse"]
