"""Per-stage wall-clock accounting for the tools and the engines, and the
timers of the measurement tools (median by CUDA events, repeat slope)."""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

import numpy as np
import torch


@contextmanager
def stage(timings: dict | None, name: str, device: torch.device):
    """Add the seconds spent in the block to ``timings[name]``. On a CUDA
    device the block is bracketed by synchronizations, so queued kernels are
    charged to the stage that launched them. ``timings=None`` costs nothing."""
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


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
