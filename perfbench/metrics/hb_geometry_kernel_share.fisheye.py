"""The share of H,b's geometry rows that the geometry kernel computed under
the lens, in %: the program's count ``hb_accumulate.geometry_kernel_rows``
over ``hb_accumulate.rows``. None where the program counts no kernel rows."""


def read(record):
    stages = record.get("stages", {})
    rows = stages.get("hb_accumulate.rows")
    kernel_rows = stages.get("hb_accumulate.geometry_kernel_rows")
    if not rows or kernel_rows is None:
        return None
    return 100.0 * kernel_rows / rows
