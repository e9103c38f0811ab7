"""The host's seconds enqueuing H,b's residuals and Gram products per LM
iteration: the program's ``hb_accumulate.gram.host`` over the window's
iterations."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('hb_accumulate.gram.host',), 'iterations')
