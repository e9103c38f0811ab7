"""H,b's host assembly per LM iteration: the program's
``hb_accumulate.assemble`` span (the ``cat``, the one device-to-host copy
and the numpy loop into the big system) over the window's iterations."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('hb_accumulate.assemble',), 'iterations')
