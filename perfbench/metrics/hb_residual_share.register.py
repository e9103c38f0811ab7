"""The share of H,b's geometry rows that became residuals, in %: the
program's counts ``hb_accumulate.residuals`` over ``hb_accumulate.rows``
(images x points of every accumulation call, once per residual type)."""


def read(record):
    stages = record.get("stages", {})
    rows, residuals = stages.get("hb_accumulate.rows"), stages.get("hb_accumulate.residuals")
    if not rows or residuals is None:
        return None
    return 100.0 * residuals / rows
