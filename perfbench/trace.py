"""What a traced run reads from ``torch.profiler``: the device's busy time
(the union of its operations' intervals, a frozen copy of the arithmetic of
``dataset_pipeline_tpu_torch/tools/registrator_profile.py:profile_base``),
the window, the device operations that took most time, the longest idle
gaps named by what the host was doing, and the intervals of named kernels.

The events stay in memory (``kineto_results``); no trace file is written.
Spans of the harness are ``torch.profiler.record_function`` ranges named
``perfbench.<name>``; the window is the range ``perfbench.window``.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

WINDOW = "perfbench.window"
TOP = 10


def union_seconds(spans) -> float:
    """Seconds covered by the union of (start, end) intervals in ns."""
    busy, end = 0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-9


def span(name: str, on: bool):
    """A ``perfbench.<name>`` range when tracing, else nothing."""
    return torch.profiler.record_function(f"perfbench.{name}") if on else nullcontext()


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def summarize(prof, kernel_names=()) -> dict:
    """busy_s, window_s, the top device operations and idle gaps, and per
    name in ``kernel_names`` the durations (s) of the kernels whose name holds
    it, in the order they ran."""
    dev_type = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW]
    if not win:
        raise RuntimeError("the traced window has no perfbench.window range")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, cpu = [], []
    for e in events:
        if e.is_user_annotation() or e.name().startswith("perfbench."):
            if e.device_type() != dev_type:  # a span's copy on the device timeline is no work
                cpu.append((e.start_ns(), e.end_ns(), e.name()))
            continue
        if e.device_type() == dev_type:
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if b > a:
                dev.append((a, b, e.name()))
        elif not e.name().startswith("cuda"):
            cpu.append((e.start_ns(), e.end_ns(), e.name()))
    busy = union_seconds([(a, b) for a, b, _ in dev])
    by_name: dict = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    kernels = {k: [(b - a) * 1e-9 for a, b, n in sorted(dev) if k in n] for k in kernel_names}
    return dict(busy_s=busy, window_s=(w1 - w0) * 1e-9,
                device_ops=sorted(([n[:200], s] for n, s in by_name.items()), key=lambda r: -r[1])[:TOP],
                idle_gaps=_idle_gaps(dev, cpu, w0, w1), kernels=kernels)


def _innermost(s, e, names, points, depth: int = 16):
    """Per point (ns), the name of the latest-started of the ``depth``
    events that began last before it and still run at it, or None."""
    j = np.searchsorted(s, points, side="right") - 1
    out = [None] * len(points)
    for k in range(depth):
        c = j - k
        ok = (c >= 0) & (e[np.maximum(c, 0)] >= points)
        for i in np.nonzero(ok)[0]:
            if out[i] is None:
                out[i] = names[c[i]]
    return out


def _idle_gaps(dev, cpu, w0: int, w1: int):
    """The idle time between device operations, summed by what the host was
    doing at the middle of each gap: the innermost ``perfbench.`` span and,
    inside it, the innermost host operation."""
    gaps, end = [], w0
    for a, b, _ in sorted(dev):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    if not gaps or not cpu:
        return []
    cpu = sorted(cpu)
    mids = np.array([(a + b) // 2 for a, b in gaps], np.int64)
    spans = [c for c in cpu if c[2].startswith("perfbench.") and c[2] != WINDOW]
    ops = [c for c in cpu if not c[2].startswith("perfbench.")]
    where = _innermost(np.array([c[0] for c in spans], np.int64), np.array([c[1] for c in spans], np.int64),
                       [c[2] for c in spans], mids) if spans else [None] * len(gaps)
    what = _innermost(np.array([c[0] for c in ops], np.int64), np.array([c[1] for c in ops], np.int64),
                      [c[2] for c in ops], mids) if ops else [None] * len(gaps)
    out: dict = {}
    for (a, b), w, op in zip(gaps, where, what):
        label = ":".join(x for x in (w, op) if x) or "host"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return sorted(([k[:200], v] for k, v in out.items()), key=lambda r: -r[1])[:TOP]
