"""The geometry kernel's ``jacobian`` mode's share of its roofline, in %:
the least time its launches' inputs need (``perfbench/roofline/hb_geometry.py``,
at 3.35 TB/s and 67 TFLOP/s) over their kernel time summed by name
(``hb_jacobian_kernel``) from the device trace, over the launches of the
traced window's first iteration. None where the program launched none."""


def read(record):
    geometry = record.get("hb_geometry")
    if not geometry or geometry["seconds"] <= 0:
        return None
    return 100.0 * geometry["bound_s"] / geometry["seconds"]
