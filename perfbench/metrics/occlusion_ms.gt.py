"""Occlusion rendering per image: the harness's synchronised spans around
``render_occlusion_depth`` over the window's images."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('occlusion',), 'images')
