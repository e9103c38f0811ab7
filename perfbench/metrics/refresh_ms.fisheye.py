"""The refresh per LM iteration under the lens: the optimizer's
``occlusion``, ``visibility`` and ``variable_descriptors`` stage seconds
over the window's iterations (an episode refreshes once more than it
iterates)."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('occlusion', 'visibility', 'variable_descriptors'), 'iterations')
