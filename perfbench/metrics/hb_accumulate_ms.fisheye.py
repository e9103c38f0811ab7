"""H,b accumulation per LM iteration under the lens: the optimizer's
``hb_accumulate`` stage seconds over the window's iterations."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('hb_accumulate',), 'iterations')
