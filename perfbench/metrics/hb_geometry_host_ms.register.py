"""The host's seconds enqueuing H,b's geometry per LM iteration: the
program's ``hb_accumulate.geometry.host`` (host clock inside the geometry
span, no synchronisation) over the window's iterations."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('hb_accumulate.geometry.host',), 'iterations')
