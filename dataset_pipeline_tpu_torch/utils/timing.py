"""Per-stage wall-clock accounting for the tools and the engines, and the
timers of the measurement tools (median by CUDA events, repeat slope).

A ``stage`` is synchronised and timed on the host clock; a ``span`` is a
child of the innermost open stage of the same ``timings`` dict, timed by a
pair of CUDA events on the card (the host clock on the CPU) without any
synchronisation, its seconds added when that stage ends. Both open a
``torch.profiler.record_function`` range of their name, so that under the
profiler they sit on the clock of the device's activity. ``timings=None``
costs nothing: no range, no event, no synchronisation."""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

# per thread, the open stages, innermost last: (timings, pending event pairs)
_OPEN = threading.local()


def _open_stages() -> list:
    if not hasattr(_OPEN, "stages"):
        _OPEN.stages = []
    return _OPEN.stages


@contextmanager
def stage(timings: dict | None, name: str, device: torch.device):
    """Add the seconds spent in the block to ``timings[name]``. On a CUDA
    device the block is bracketed by synchronizations, so queued kernels are
    charged to the stage that launched them; the event pairs of its child
    spans are read after the closing one. ``timings=None`` costs nothing."""
    if timings is None:
        yield
        return
    pending: list = []
    stages = _open_stages()
    with torch.profiler.record_function(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        stages.append((timings, pending))
        try:
            yield
        finally:
            stages.pop()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
            for key, a, b in pending:
                timings[key] = timings.get(key, 0.0) + a.elapsed_time(b) * 1e-3


@contextmanager
def span(timings: dict | None, name: str, device: torch.device, host: bool = False):
    """Add the block's seconds to ``timings[name]``: on a CUDA device by a
    pair of events on the current stream, read when the innermost open
    ``stage`` of ``timings`` ends, on the CPU by the host clock. With
    ``host``, ``timings[name + ".host"]`` gets the host's seconds in the
    block, the time to enqueue its work. Never synchronises."""
    if timings is None:
        yield
        return
    cuda = device.type == "cuda"
    if cuda:
        owner = [p for t, p in _open_stages() if t is timings]
        if not owner:
            raise RuntimeError(f"span {name!r} on the card needs an open stage of its timings")
    with torch.profiler.record_function(name):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            seconds = time.perf_counter() - t0
            if cuda:
                b = torch.cuda.Event(enable_timing=True)
                b.record()
                owner[-1].append((name, a, b))
            else:
                timings[name] = timings.get(name, 0.0) + seconds
            if host:
                timings[name + ".host"] = timings.get(name + ".host", 0.0) + seconds


def within_stage(timings: dict | None) -> dict | None:
    """``timings`` if one of its stages is open on this thread, so that its
    spans will be read, else None: for code that runs both inside a stage
    and outside any."""
    return timings if timings is not None and any(t is timings for t, _ in _open_stages()) else None


def count(timings: dict | None, name: str, n: int) -> None:
    """Add the integer ``n`` to ``timings[name]`` (nothing with ``None``)."""
    if timings is not None:
        timings[name] = timings.get(name, 0) + int(n)


def stages_text(timings: dict) -> str:
    """``name seconds, ...`` of a ``timings`` dict, its integer counts
    after them as ``; counts: name n, ...``."""
    text = ", ".join(f"{k} {v:.3f}" for k, v in timings.items() if not isinstance(v, int))
    counts = ", ".join(f"{k} {v}" for k, v in timings.items() if isinstance(v, int))
    return text + (f"; counts: {counts}" if counts else "")


class StageTimer:
    """Wall seconds and call counts per named stage, written as the JAX
    tools' ``timing.json`` (``{name: {"total_s": s, "count": n}}``). On a CUDA
    device each stage is bracketed by synchronizations."""

    def __init__(self, device: torch.device):
        self.device = device
        self.totals: dict = {}
        self.counts: dict = {}

    @contextmanager
    def stage(self, name: str):
        seconds: dict = {}
        try:
            with stage(seconds, name, self.device):
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + seconds.get(name, 0.0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return "\n".join(
            f"{n}: {self.totals[n]:.3f}s total, {self.counts[n]} calls, "
            f"{self.totals[n] / max(self.counts[n], 1) * 1000:.1f}ms avg"
            for n in sorted(self.totals, key=lambda n: -self.totals[n]))

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({n: {"total_s": self.totals[n], "count": self.counts[n]}
                       for n in self.totals}, f, indent=1)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_s(fn, device) -> float:
    """Host seconds of ``fn()``, the device's work included."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def median_ms(fn, device, warmup: int = 2, reps: int = 9, inner: int = 1) -> float:
    """Median milliseconds of ``fn()``: CUDA events on the card, the host
    clock on the CPU. With ``inner`` > 1 each reading brackets that many
    back-to-back calls, one more call going ahead of it, so that on the card
    the host's time in a wrapper hides behind the call before it."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            if inner > 1:
                fn()
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / inner)
        else:
            times.append(1e3 * wall_s(lambda: [fn() for _ in range(inner)], device) / inner)
    return float(np.median(times))


def slope_s(call, R: int, device, reps: int = 2) -> float:
    """Seconds per repeat of ``call(repeats)``: ``(T(R) - T(1)) / (R - 1)``,
    each T the best of ``reps`` after a warm-up."""
    def t_of(repeats):
        call(repeats)
        return min(wall_s(lambda: call(repeats), device) for _ in range(reps))

    return max((t_of(R) - t_of(1)) / (R - 1), 1e-9)
