"""The share of H,b's rows whose residuals and Gram products the Gram kernel
computed, in %: the program's count ``hb_accumulate.gram_kernel_rows`` over
``hb_accumulate.rows`` (images x points of every accumulation call, once per
residual type). None where the program counts no Gram kernel rows."""


def read(record):
    stages = record.get("stages", {})
    rows = stages.get("hb_accumulate.rows")
    kernel_rows = stages.get("hb_accumulate.gram_kernel_rows")
    if not rows or kernel_rows is None:
        return None
    return 100.0 * kernel_rows / rows
