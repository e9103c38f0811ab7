"""The copies of both depth maps to the host per image: the spans around
the two ``.cpu().numpy()`` conversions."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('d2h',), 'images')
