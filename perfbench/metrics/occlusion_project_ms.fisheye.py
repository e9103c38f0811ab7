"""The splat centres' projection through the lens per LM iteration: the
program's ``occlusion_depths.project`` span (CUDA events on the card) over
the window's iterations. None where the program records no such span."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('occlusion_depths.project',), 'iterations')
