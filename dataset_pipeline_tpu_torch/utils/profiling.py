"""Device tracing.

Port of ``dataset_pipeline_tpu/utils/profiling.py``; stage timing is in
``utils/timing.py``, whose stages and spans are ``record_function`` ranges
in the trace. ``device_trace`` records a ``torch.profiler`` trace (CPU
and, where there is a card, CUDA activity) of the block and writes it as a
Chrome trace (``chrome://tracing``, Perfetto) into ``trace_dir`` or
``$DPT_TRACE_DIR``; with neither it costs nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Optional

import torch

_TRACE_IDS = itertools.count()


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` into
    ``<trace_dir>/trace_<pid>_<n>.json`` (one file per traced block of a
    process). Enabled by passing a dir or setting ``DPT_TRACE_DIR``."""
    trace_dir = trace_dir or os.environ.get("DPT_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
