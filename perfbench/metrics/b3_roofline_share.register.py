"""Kernel B3's share of its roofline, in %: the least time its launches'
inputs need (``perfbench/roofline/pyramid_sample.py``, at 3.35 TB/s and
67 TFLOP/s) over their kernel time summed by name from the device trace,
over the launches of the traced window's first LM iteration."""


def read(record):
    b3 = record.get("b3")
    if not b3 or b3["seconds"] <= 0:
        return None
    return 100.0 * b3["bound_s"] / b3["seconds"]
