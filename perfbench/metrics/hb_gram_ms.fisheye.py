"""H,b's residuals and Gram products per LM iteration under the lens (18
columns a row): the program's ``hb_accumulate.gram`` span over the window's
iterations."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('hb_accumulate.gram',), 'iterations')
