"""The reader of the Gram kernel's share of H,b's rows on hand-built records:
its value, and None where the program counts no Gram kernel rows (a program
without the kernel, or on the CPU) or no rows."""

from __future__ import annotations

import pytest

from perfbench import harness

STAGES = {"hb_accumulate": 6.0, "hb_accumulate.rows": 4000, "hb_accumulate.residuals": 1000,
          "hb_accumulate.geometry_kernel_rows": 4000}


@pytest.mark.parametrize("kernel_rows,expect", [(4000, 100.0), (1000, 25.0), (0, 0.0)])
def test_share_of_the_rows_the_gram_kernel_computed(kernel_rows, expect):
    read = harness.load_reader("hb_gram_kernel_share.register")
    stages = dict(STAGES, **{"hb_accumulate.gram_kernel_rows": kernel_rows})
    assert read({"stages": stages, "iterations": 6}) == pytest.approx(expect)


def test_no_share_without_the_count_or_the_rows():
    read = harness.load_reader("hb_gram_kernel_share.register")
    assert read({"stages": STAGES, "iterations": 6}) is None
    assert read({"stages": dict(STAGES, **{"hb_accumulate.rows": 0,
                                            "hb_accumulate.gram_kernel_rows": 0})}) is None
    assert read({}) is None


def test_the_metric_is_declared_for_the_three_register_cells():
    metrics = {x["name"]: x for x in harness.load_benchmark()["per_layer"]}
    m = metrics["hb_gram_kernel_share.register"]
    assert (m["layer"], m["moves"], m["source"], m["unit"], m["better"]) == (
        "H,b residuals and Gram products", "lm_iteration_s", "program_counter", "%", "higher")
    assert m["workloads"] == ["dslr_register.scale0", "dslr_register.coarse",
                              "dslr_fisheye.full_res"]
