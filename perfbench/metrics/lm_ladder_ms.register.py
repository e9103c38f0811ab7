"""The LM ladder per iteration: the optimizer's ``lm_ladder`` stage
seconds over the window's iterations."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('lm_ladder',), 'iterations')
