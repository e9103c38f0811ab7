"""Arithmetic the per-layer readers share."""


def stage_ms(record, stages, per):
    """Milliseconds of the named stages summed, per unit of ``record[per]``
    (iterations or images); None where the run recorded none of them."""
    seen = [record.get("stages", {}).get(s) for s in stages]
    n = record.get(per, 0)
    if not n or all(v is None for v in seen):
        return None
    return 1e3 * sum(v for v in seen if v is not None) / n
