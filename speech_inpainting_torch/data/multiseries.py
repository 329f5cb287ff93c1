"""Multi-rate series alignment: LCM length matching and aligned clipping.

The port's own copy of speech_inpainting_tpu/data/multiseries.py (numpy
only; the port imports nothing of the JAX package), behaviour matched to
I_da/src/multiseries.py:5-115: series sampled at different hops (audio 1,
HuBERT codes 320, f0 80, mel 256) are truncated to a whole number of LCM
units, repeat-padded up to a minimum length, and clipped with sample-scale
starts that are unit-aligned. Randomness is an explicit Generator argument.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def match_length(series_hops: Sequence[Tuple[np.ndarray, int]],
                 min_length: int = 1) -> List[np.ndarray]:
    """Truncate each (series, hop) to a common whole-unit duration; repeat to
    reach `min_length` samples (error past 100 repeats)."""
    series = [s for s, _ in series_hops]
    hops = [h for _, h in series_hops]
    unit = int(np.lcm.reduce(hops))                   # samples per unit
    frames_per_unit = [unit // h for h in hops]
    n_unit = min(s.shape[-1] // f for s, f in zip(series, frames_per_unit))
    out = [s[..., :n_unit * f] for s, f in zip(series, frames_per_unit)]

    matched_samples = out[0].shape[-1] * hops[0]
    if matched_samples < min_length:
        n_repeat = 1 + min_length // matched_samples
        if n_repeat >= 100:
            raise RuntimeError(
                f"series would need {n_repeat}x repetition to reach "
                f"min_length={min_length}; input looks wrong")
        out = [np.concatenate([s] * n_repeat, axis=-1) for s in out]
    return out


def clip_segment(series_hops, len_segment: int, start: int):
    """Clip every series to [start, start+len_segment) in sample scale;
    both values should be multiples of the hop LCM."""
    return [s[..., start // h:start // h + len_segment // h]
            for s, h in series_hops]


def clip_segment_random(series_hops, len_segment: int,
                        rng: np.random.Generator):
    """Random-start aligned clip; series must already be length-matched."""
    series0, hop0 = series_hops[0]
    limit = series0.shape[-1] * hop0 - len_segment
    start = int(rng.integers(0, limit + 1)) if limit > 0 else 0
    return clip_segment(series_hops, len_segment, start)
