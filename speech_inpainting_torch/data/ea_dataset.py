"""I_ea training dataset: padded 16 kHz waveforms and per-frame centroid
labels with per-item random mask positions.

The port's own numpy copy of speech_inpainting_tpu/data/ea_dataset.py (that
module needs no JAX, but the port imports nothing of the JAX package); its
batches equal the JAX package's bit for bit:
  - preprocessing (load → mean/var normalise → pad to max_length) is cached
    as one memory-mapped .npy per split, keyed by a content hash of the
    file list and the parameters;
  - items carry the raw normalised wave and mask_pos; the trainer masks
    [pos·320+80, (pos+len)·320−1) on the device (train/ea.py);
  - mask positions are drawn per item from a seeded per-epoch Generator,
    pos ∈ [0, (min(len, max)−80)/320 − mask_len);
  - labels: the [pos, pos+len) slice of the utterance's frame labels.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from .audio import load_wav


def _meanvar(x: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    return (x - x.mean()) / np.sqrt(x.var() + eps)


def plan_buckets(lengths: Sequence[int], n_buckets: int,
                 *, max_length: Optional[int] = None) -> list:
    """Quantile length buckets for `EADataset.batches(buckets=...)`.

    The reference pads EVERY utterance to max_wav_length
    (I_ea/dataset/dataset.py:49-63 pads to the processor max) — on a corpus
    whose lengths vary (LJSpeech: ~1-10 s) that wastes most of the padded
    compute. Buckets trade K batch shapes for near-tight padding: each
    utterance pads only to its bucket's length. Returns ascending bucket
    lengths; the last covers the
    longest utterance (clamped to `max_length` if given, matching the
    dataset's truncation).
    """
    assert n_buckets >= 1
    ls = np.asarray(lengths, np.int64)
    if max_length is not None:
        ls = np.minimum(ls, max_length)
    qs = np.quantile(ls, np.linspace(0, 1, n_buckets + 1)[1:],
                     method="higher").astype(np.int64)
    return sorted(set(int(q) for q in qs))


class EADataset:
    """Fixed-shape item source for the I_ea loop.

    Args:
      wav_paths: utterance wav files (16 kHz or resampled on load)
      labels: per-utterance (frames,) int centroid labels (full utterance)
      max_length: padded waveform length in samples (reference 161539)
      mask_length: mask length in 20 ms frames
      cache_dir: where the preprocessed .npy cache lives (None → in-memory)
    """

    def __init__(self, wav_paths: Sequence, labels: Sequence[np.ndarray],
                 *, max_length: int = 161539, mask_length: int = 20,
                 normalize: bool = True, cache_dir: Optional[str] = None,
                 sr: int = 16000):
        assert len(wav_paths) == len(labels)
        self.paths = [str(p) for p in wav_paths]
        self.labels = [np.asarray(l).reshape(-1).astype(np.int32)
                       for l in labels]
        self.max_length = max_length
        self.mask_length = mask_length
        self.normalize = normalize
        self.sr = sr
        self.max_frames = (max_length - 80) // 320
        self._load_or_build_cache(cache_dir)

    # ---- preprocessing cache -------------------------------------------

    def _cache_key(self) -> str:
        h = hashlib.sha256()
        h.update(json.dumps({
            "paths": self.paths, "max_length": self.max_length,
            "normalize": self.normalize, "sr": self.sr}).encode())
        return h.hexdigest()[:16]

    def _build(self):
        n = len(self.paths)
        waves = np.zeros((n, self.max_length), np.float32)
        lengths = np.zeros((n,), np.int32)
        for i, p in enumerate(self.paths):
            wav, _ = load_wav(p, target_sr=self.sr)
            if self.normalize:
                wav = _meanvar(wav)
            t = min(len(wav), self.max_length)
            waves[i, :t] = wav[:t]
            lengths[i] = t
        return waves, lengths

    def _load_or_build_cache(self, cache_dir):
        if cache_dir is None:
            self.waves, self.lengths = self._build()
            return
        os.makedirs(cache_dir, exist_ok=True)
        key = self._cache_key()
        wpath = Path(cache_dir, f"waves_{key}.npy")
        lpath = Path(cache_dir, f"lengths_{key}.npy")
        if not (wpath.exists() and lpath.exists()):
            waves, lengths = self._build()
            np.save(wpath, waves)
            np.save(lpath, lengths)
        self.waves = np.load(wpath, mmap_mode="r")
        self.lengths = np.load(lpath, mmap_mode="r")

    # ---- batching -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.paths)

    def batches(self, batch_size: int, *, epoch: int = 0, seed: int = 1234,
                shuffle: bool = True, drop_last: bool = True,
                buckets: Optional[Sequence[int]] = None) -> Iterator[dict]:
        """Fixed-shape batches {wav, attn_mask, mask_pos, labels}.

        With `buckets` (ascending padded lengths, e.g. from `plan_buckets`),
        each utterance pads only to the smallest bucket covering it and
        batches are grouped per bucket — K batch shapes instead of one,
        near-tight padding instead of max-length padding, as HF/torch
        per-batch dynamic padding, with its caveat: HuBERT's conv-frontend
        GroupNorm normalizes each channel over time INCLUDING pad frames,
        and the conv positional embedding convolves across them (both
        HF-parity semantics, models/hubert.py), so outputs are weakly
        pad-length-dependent.
        Use a single bucket (the default) for bit-reproducibility against
        the reference's fixed max-length padding. Bucket batch order is
        shuffled so training interleaves lengths. With drop_last, a
        bucket's sub-batch_size remainder SPILLS into the next (larger)
        bucket rather than being dropped — bucket membership is
        length-determined, so dropping would exclude the same utterances
        every epoch; only the final bucket's remainder is dropped (the
        same contract as unbucketed drop_last, where the shuffle rotates
        it). Bucket lengths are clamped to max_length."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        order = rng.permutation(len(self)) if shuffle \
            else np.arange(len(self))
        if buckets is None:
            groups = [(self.max_length, order)]
        else:
            bl = sorted({min(int(b), self.max_length) for b in buckets})
            assert bl[0] > 80 + 320 * self.mask_length, \
                f"bucket {bl[0]} leaves no room for a {self.mask_length}" \
                "-frame mask"
            longest = int(np.max(np.asarray(self.lengths)))
            if bl[-1] < longest:
                bl.append(min(self.max_length, longest))
            lens = np.asarray(self.lengths)[order]
            which = np.searchsorted(bl, lens, side="left")
            groups = [(blen, order[which == k]) for k, blen in enumerate(bl)]
        plan = []
        spill = order[:0]
        for gi, (pad_len, idxs) in enumerate(groups):
            if len(spill):
                idxs = np.concatenate([spill, idxs])
                spill = order[:0]
            if drop_last:
                end = (len(idxs) // batch_size) * batch_size
                if gi + 1 < len(groups):
                    spill = idxs[end:]
            else:
                end = len(idxs)
            plan.extend((pad_len, idxs[s:s + batch_size])
                        for s in range(0, end, batch_size))
        if buckets is not None and shuffle:
            plan = [plan[j] for j in rng.permutation(len(plan))]
        L = self.mask_length
        for pad_len, idx in plan:
            wav = np.asarray(self.waves[idx, :pad_len])
            lengths = np.asarray(self.lengths[idx])
            attn = (np.arange(pad_len)[None, :]
                    < lengths[:, None]).astype(np.int32)
            max_pos = (np.minimum(lengths, pad_len) - 80) // 320 - L
            mask_pos = rng.integers(0, np.maximum(max_pos, 1)).astype(np.int32)
            n_frames = (pad_len - 80) // 320
            labels = np.stack([
                np.pad(self.labels[i], (0, max(0, n_frames
                                               - len(self.labels[i]))))
                [mask_pos[k]:mask_pos[k] + L]
                for k, i in enumerate(idx)])
            yield dict(wav=wav, attn_mask=attn, mask_pos=mask_pos,
                       labels=labels.astype(np.int32))
