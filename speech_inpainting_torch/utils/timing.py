"""Wall-clock timing with forced completion.

Counterpart of speech_inpainting_tpu/utils/timing.py. A CUDA launch returns
before the card has run it, so a timer must wait for the work: `force`
reads one element of every tensor leaf back to the host (a device-to-host
copy of one element, which waits for the stream that wrote it), the JAX
package's barrier. `differenced_time` and `differenced_or_fallback` are the
JAX package's loop-count differencing, which cancels a constant cost per
timed window (dispatch, the final read-back) from the per-iteration time.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves


def force(tree):
    """Synchronise by reading one element of every tensor leaf of `tree`
    (nested dicts, lists and tuples) to the host; returns `tree`."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.numel():
            leaf.detach().reshape(-1)[:1].cpu()
    return tree


def timeit(fn: Callable, *args, iters: int = 5, warmup: int = 1, **kw):
    """Median wall seconds per call of fn(*args, **kw), each call forced to
    complete, after `warmup` calls."""
    for _ in range(warmup):
        force(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def differenced_time(run_window: Callable[[int], float], n1: int = 2,
                     n2: int = 12, reps: int = 2, attempts: int = 3):
    """Per-iteration seconds by loop-count differencing, or None.

    `run_window(n)` runs n back-to-back iterations and waits once on the
    last output, returning its wall seconds. (T(n2) − T(n1)) / (n2 − n1)
    cancels the constant cost of a window; each T is the least of `reps`
    runs. A delta that is not positive, or larger than the short window's
    own per-iteration time (impossible when the constant cost is not
    negative), is noise: the measurement is retried up to `attempts` times
    and None returned if none is credible, never a clamped delta."""
    for _ in range(attempts):
        t1 = min(run_window(n1) for _ in range(reps))
        t2 = min(run_window(n2) for _ in range(reps))
        dt = (t2 - t1) / (n2 - n1)
        if 0.0 < dt <= t1 / n1:
            return dt
    return None


def differenced_or_fallback(run_window: Callable[[int], float],
                            fallback_s: float, **kw):
    """(per-iteration seconds, differenced?): `differenced_time`, or
    (`fallback_s`, False) where it gives None. The fallback should be the
    least of several synchronised samples: the noise that defeats the
    differencing inflates a single sample too."""
    dt = differenced_time(run_window, **kw)
    return (fallback_s, False) if dt is None else (dt, True)
