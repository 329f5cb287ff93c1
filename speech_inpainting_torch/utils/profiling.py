"""Profiler traces, throughput meters and flop counts.

Counterpart of speech_inpainting_tpu/utils/profiling.py:
  - `trace(log_dir)` records `torch.profiler` around a block (the CPU, and
    the card where there is one) and writes a Chrome trace, viewable in
    Perfetto or chrome://tracing;
  - `ThroughputMeter` turns step times into steps/s and audio-s/s over a
    sliding window;
  - `estimate_cost(fn, *args)` counts the flops of one call by
    `torch.utils.flop_counter.FlopCounterMode` (matrix products and
    convolutions, 2 per multiply-add, as XLA's cost analysis counts them).
    torch has no count of the bytes a call moves, so the result has no
    "bytes accessed" key, where XLA's has one;
  - `measure(fn, *args)` gives the median wall seconds of a forced call
    and, where flops were counted, GFLOP/s.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from .timing import force


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the with-block (CPU activity, and CUDA activity where a card
    is present); on leaving it, write the Chrome trace to
    `log_dir/trace.json`. Yields the `torch.profiler.profile`, whose
    `key_averages()` tabulates the same events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))


class ThroughputMeter:
    """Audio-seconds per second and steps per second over a sliding window
    of the last `window` steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._audio: list = []

    def step(self, audio_seconds: float = 0.0):
        self._times.append(time.perf_counter())
        self._audio.append(audio_seconds)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._audio.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return (len(self._times) - 1) / (self._times[-1] - self._times[0])

    @property
    def audio_sec_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return sum(self._audio[1:]) / (self._times[-1] - self._times[0])


def estimate_cost(fn, *args) -> dict:
    """{"flops": …} of one call fn(*args) without gradient, counted by
    FlopCounterMode; empty where it counted none."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return {"flops": float(flops)} if flops else {}


def measure(fn, *args, iters: int = 5) -> dict:
    """Median wall seconds of fn(*args), each call forced to complete after
    one warm-up, and GFLOP and GFLOP/s where flops were counted."""
    cost = estimate_cost(fn, *args)
    with torch.no_grad():
        force(fn(*args))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            force(fn(*args))
            times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    out = {"seconds": sec}
    if cost.get("flops"):
        out["gflops"] = cost["flops"] / 1e9
        out["gflops_per_sec"] = cost["flops"] / sec / 1e9
    return out
