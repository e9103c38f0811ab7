"""Visibility, the view counts and keep, and the ground-truth z-buffer per
image: the spans around ``_visible_mask`` and ``_gt_depth_image``."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('gt_depth',), 'images')
