"""Long-form informed inpainting: windowed streaming over a recording of any
length.

Counterpart of speech_inpainting_tpu/infer/longform.py. Masks on the global
20 ms frame grid (hop 441 at 22.05 kHz, hop 320 at 16 kHz) are coalesced
where they lie within 2 frames of each other (`merge_mask_spans`), each is
given a frame-aligned window of one fixed size around it (`plan_windows`),
the windows go through `InformedInpainter.batch` in batches of a fixed size
(the last padded by repeating a window), pipelined `depth` deep on the
inpainter's device with the patches copied back to pinned host memory, and
only each mask's resynthesised span (with up to one frame of margin) is
crossfade-pasted into a copy of the recording. Inside a window, the other
masks' spans are zeroed too, so that no corrupt audio serves as context;
the patch is scaled by the inverse of the gain that the inpainter's peak
normalisation gave its masked window.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from .serving import PipelinedRunner, to_host

S22, S16 = 441, 320        # samples per 20 ms frame at 22.05 k / 16 k


@dataclasses.dataclass(frozen=True)
class LongFormConfig:
    window_frames: int = 200    # 4.0 s of context per mask
    batch: int = 8              # windows per batch call
    depth: int = 4              # pipelined batches in flight
    crossfade_s: float = 0.01   # paste crossfade (10 ms)
    margin_frames: int = 2      # keep masks this far from window edges


def plan_windows(total_frames: int, mask_pos, mask_len, window_frames: int,
                 margin: int = 2):
    """Map global-frame masks onto frame-aligned windows: (win_start,
    rel_pos) int64 arrays, window w covering global frames [win_start,
    win_start + window_frames) with its mask at rel_pos, centred where it
    can be and clamped at the recording's edges. Masks must fit:
    mask_len <= window_frames − 2·margin."""
    mask_pos = np.asarray(mask_pos, np.int64)
    mask_len = np.asarray(mask_len, np.int64)
    if mask_pos.ndim != 1 or mask_pos.shape != mask_len.shape:
        raise ValueError("mask_pos/mask_len must be equal-length 1-D arrays")
    if np.any(mask_len < 1):
        raise ValueError("mask_len must be >= 1 frame")
    if np.any(mask_len > window_frames - 2 * margin):
        raise ValueError(
            f"mask_len {int(mask_len.max())} exceeds window capacity "
            f"{window_frames - 2 * margin} (window {window_frames} frames, "
            f"margin {margin}); raise LongFormConfig.window_frames")
    if np.any(mask_pos < 0) or np.any(mask_pos + mask_len > total_frames):
        raise ValueError("mask spans must lie inside the recording")
    center = mask_pos + mask_len // 2
    hi = max(total_frames - window_frames, 0)
    win_start = np.clip(center - window_frames // 2, 0, hi)
    # the edge clamp can push the mask into the margin: pull the window back
    win_start = np.minimum(win_start, np.maximum(mask_pos - margin, 0))
    win_start = np.maximum(win_start,
                           np.minimum(mask_pos + mask_len + margin,
                                      total_frames) - window_frames)
    win_start = np.clip(win_start, 0, hi)
    return win_start.astype(np.int64), (mask_pos - win_start).astype(np.int64)


def merge_mask_spans(mask_pos, mask_len, *, gap_frames: int = 2):
    """Coalesce masks whose spans touch or lie within `gap_frames` of each
    other into one span (sorted by start), so that one window's paste
    margin cannot overwrite a neighbour's inpainted output."""
    pos = np.asarray(mask_pos, np.int64)
    ln = np.asarray(mask_len, np.int64)
    if len(pos) <= 1:
        return pos, ln
    o = np.argsort(pos)
    pos, ln = pos[o], ln[o]
    out_p, out_l = [int(pos[0])], [int(ln[0])]
    for p, n in zip(pos[1:], ln[1:]):
        if p <= out_p[-1] + out_l[-1] + gap_frames:
            out_l[-1] = max(out_p[-1] + out_l[-1], int(p + n)) - out_p[-1]
        else:
            out_p.append(int(p))
            out_l.append(int(n))
    return np.asarray(out_p, np.int64), np.asarray(out_l, np.int64)


def _crossfade_paste(y: np.ndarray, patch: np.ndarray, start: int,
                     fade: int, *, fade_in: bool = True,
                     fade_out: bool = True) -> None:
    """Paste `patch` into y[start:start + len(patch)] in place, with
    complementary linear ramps over its first and last `fade` samples
    (`fade_in`/`fade_out` False drops a ramp, where the patch has no clean
    margin on that side)."""
    n = len(patch)
    lo, hi = max(start, 0), min(start + n, len(y))
    if hi <= lo:
        return
    seg = patch[lo - start:hi - start].astype(np.float64)
    w = np.ones(n, np.float64)
    f = min(fade, n // 2)
    if f > 0:
        ramp = np.linspace(0.0, 1.0, f + 2)[1:-1]
        if fade_in:
            w[:f] = ramp
        if fade_out:
            w[-f:] = ramp[::-1]
    w = w[lo - start:hi - start]
    y[lo:hi] = (y[lo:hi] * (1.0 - w) + seg * w).astype(y.dtype)


@dataclasses.dataclass
class _Job:
    """One recording's windows: the zero-padded waves, the merged masks,
    their windows, and the output being pasted into."""
    cfg: LongFormConfig
    wav22: np.ndarray
    wav16: np.ndarray
    mask_pos: np.ndarray
    mask_len: np.ndarray
    win_start: np.ndarray
    rel: np.ndarray
    out: np.ndarray
    spans: list

    @property
    def starts(self) -> range:
        """The first window of each batch."""
        return range(0, len(self.win_start), self.cfg.batch)

    def window_batch(self, i0: int):
        """The batch of windows i0 … i0 + batch − 1 (the last window
        repeated past the end) as `InformedInpainter.batch` arguments, and
        each window's inverse normalisation gain."""
        Wf, M = self.cfg.window_frames, len(self.win_start)
        idx = [min(i0 + j, M - 1) for j in range(self.cfg.batch)]
        w22 = np.stack([self.wav22[self.win_start[i] * S22:
                                   (self.win_start[i] + Wf) * S22]
                        for i in idx])
        w16 = np.stack([self.wav16[self.win_start[i] * S16:
                                   (self.win_start[i] + Wf) * S16]
                        for i in idx])
        # the other masks' spans are corrupt too: zero those in the window
        for j, i in enumerate(idx):
            for k in range(M):
                if k == i:
                    continue
                a = max(int(self.mask_pos[k] - self.win_start[i]), 0)
                b = min(int(self.mask_pos[k] + self.mask_len[k]
                            - self.win_start[i]), Wf)
                if b > a:
                    w22[j, a * S22:b * S22] = 0.0
                    w16[j, a * S16:b * S16] = 0.0
        # the inverse of the inpainter's peak_normalize of the masked window
        gains = []
        for j, i in enumerate(idx):
            m = w22[j].copy()
            m[self.rel[i] * S22:(self.rel[i] + self.mask_len[i]) * S22] = 0.0
            gains.append(max(float(np.abs(m).max()), 1e-10) / 0.95)
        return ((w22, w16, self.rel[idx], self.mask_len[idx]),
                np.asarray(gains))

    def paste(self, done: np.ndarray, i0: int, gains: np.ndarray) -> None:
        """Paste the patches of the batch that starts at window i0 (done:
        its inpainted windows, (batch, T)) into `out`."""
        fade = int(self.cfg.crossfade_s * 22050)
        for j in range(min(self.cfg.batch, len(self.win_start) - i0)):
            i = i0 + j
            lead = int(min(self.rel[i], 1))               # ≤ 1 frame margin
            a = int((self.rel[i] - lead) * S22)
            b_full = int((self.rel[i] + self.mask_len[i] + 1) * S22)
            b = min(b_full, done.shape[1])
            patch = done[j, a:b].astype(np.float64) * gains[j]
            start = int(self.win_start[i] * S22 + a)
            # no clean margin on a side → no ramp there
            _crossfade_paste(self.out, patch, start, fade,
                             fade_in=lead > 0, fade_out=b == b_full)
            self.spans.append((start, min(start + (b - a), len(self.out))))


class LongFormInpainter:
    """Windowed informed inpainting over recordings of any length, on the
    device of the `InformedInpainter` it wraps.

    Call with the full-length 22.05 k and 16 k waveforms and the masks on
    the global 20 ms frame grid; returns the inpainted 22.05 k waveform (a
    copy: the input is never modified) and the pasted sample spans.
    """

    def __init__(self, inpainter, cfg: LongFormConfig = LongFormConfig()):
        assert cfg.window_frames > 2 * cfg.margin_frames > 0
        assert cfg.batch >= 1 and cfg.depth >= 1
        self.cfg = cfg
        self._inp = inpainter

    def plan(self, wav22, wav16, mask_pos, mask_len) -> _Job:
        """The windows of one recording, ready to run and paste."""
        cfg = self.cfg
        wav22 = np.asarray(wav22, np.float32)
        wav16 = np.asarray(wav16, np.float32)
        out = wav22.copy()
        Wf, mg = cfg.window_frames, cfg.margin_frames
        total = min(len(wav22) // S22, len(wav16) // S16)
        # a tail pad of `margin` frames (up to a whole window for a short
        # recording) keeps a mask at the recording's end `margin` frames
        # inside its window, with zeros as context past the end
        padded = max(total + mg, Wf)
        wav22 = np.pad(wav22, (0, max(padded * S22 - len(wav22), 0)))
        wav16 = np.pad(wav16, (0, max(padded * S16 - len(wav16), 0)))
        if np.any(np.asarray(mask_pos) + np.asarray(mask_len) > total):
            raise ValueError("mask spans must lie inside the recording")
        mask_pos, mask_len = merge_mask_spans(mask_pos, mask_len)
        win_start, rel = plan_windows(padded, mask_pos, mask_len, Wf, mg)
        return _Job(cfg, wav22, wav16, mask_pos, mask_len, win_start, rel,
                    out, [])

    def __call__(self, wav22, wav16, mask_pos, mask_len):
        job = self.plan(wav22, wav16, mask_pos, mask_len)
        runner = PipelinedRunner(
            lambda *a: self._inp.batch(*a)["inpainted"],
            depth=self.cfg.depth, fetch=to_host)
        pending = collections.deque()
        for i0 in job.starts:
            args, gains = job.window_batch(i0)
            pending.append((i0, gains))
            for done in runner.submit(*args):
                job.paste(done.numpy(), *pending.popleft())
        for done in runner.drain():
            job.paste(done.numpy(), *pending.popleft())
        return job.out, job.spans


__all__ = ["LongFormConfig", "LongFormInpainter", "merge_mask_spans",
           "plan_windows"]
