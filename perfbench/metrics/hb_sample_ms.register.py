"""Kernel B3 inside H,b per LM iteration: the program's
``hb_accumulate.sample`` span (``pyramid_sample`` with derivatives, CUDA
events on the card) over the window's iterations."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('hb_accumulate.sample',), 'iterations')
