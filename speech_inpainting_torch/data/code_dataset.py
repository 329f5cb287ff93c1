"""I_da datasets: CodeDataset (units, f0, speaker, audio, loss mel) and
F0DatasetTPU (f0 only), with one-time cached preprocessing, and the speaker
embedders.

Counterpart of speech_inpainting_tpu/data/code_dataset.py, behaviour
matched to I_da/src/dataset.py:246-545:
  - per utterance: 16 kHz audio → ×0.95 inf-norm → speaker id and d-vector
    → f0 (tracked on the device by ops/f0.py, after zero-padding to a
    multiple of F0_PAD_BUCKET samples and trimmed back: the padding moves
    the last frames' NCCF windows and median, so it is kept as JAX keeps
    it) → z-normalised → full-band loss mel → LCM length matching of
    (audio 1, code 320, f0 80, mel 256);
  - batches of aligned random segment clips, the order and the clips from
    one numpy Generator seeded by SeedSequence([seed, epoch]);
  - the preprocessing cache is content-addressed (`_item_key`).
The f0 normalisation is per utterance unless `f0_stats`, a flat
{"f0_mean", "f0_std"} dict (CodeDataset also takes one per speaker id), is
given. Speaker embeddings: `torchscript_embedder` loads the reference's
TorchScript wav2mel + Resemblyzer d-vector pair; `mel_stats_embedder` is
the self-contained stand-in (log-mel mean ⊕ std) that `inpaint_da` and the
datasets use by default. The mel, the f0 tracker and the default embedder
run on `device` (the CUDA card unless "cpu" is asked for); the rest is
numpy on the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..device import full_f32, resolve_device
from ..ops.f0 import F0Config, extract_f0, normalize_nonzero
from ..ops.mel import VOCODER_MEL_16K_FULLBAND, MelConfig, mel_spectrogram
from .audio import load_wav, peak_normalize
from .manifests import parse_speaker
from .multiseries import clip_segment_random, match_length

# 25 ms windows every 10 ms at 16 kHz, the full band
EMBED_MEL_16K = MelConfig(sampling_rate=16000, n_fft=400, num_mels=80,
                          hop_size=160, win_size=400, fmax=None)
F0_PAD_BUCKET = 8000  # utterances are tracked zero-padded to 0.5 s buckets


def mel_stats_embedder(dim: int = 256, device=None):
    """Deterministic speaker embedding: mean ⊕ std over time of a
    25 ms / 10 ms log-mel, tiled/truncated to `dim` and L2-normalised.
    Returns embed(wav (T,) float 16 kHz, sr) → (dim,) float32 numpy; the
    mel runs on `device` (the CUDA card unless "cpu" is asked for)."""
    device = resolve_device(device)

    def embed(wav: np.ndarray, sr: int) -> np.ndarray:
        if sr != 16000:
            raise ValueError(f"mel_stats_embedder takes 16 kHz audio, "
                             f"got {sr} Hz")
        x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
        with torch.inference_mode(), full_f32():
            mel = mel_spectrogram(x, EMBED_MEL_16K).cpu().numpy()
        stats = np.concatenate([mel.mean(axis=1), mel.std(axis=1)])
        reps = int(np.ceil(dim / stats.size))
        emb = np.tile(stats, reps)[:dim].astype(np.float32)
        return emb / (np.linalg.norm(emb) + 1e-8)

    return embed


def torchscript_embedder(wav2mel_path: str, embedder_path: str,
                         device=None):
    """The reference's TorchScript wav2mel + d-vector embedder pair on
    `device` (the CUDA card unless "cpu" is asked for): embed(wav, sr) →
    numpy d-vector."""
    device = resolve_device(device)
    wav2mel = torch.jit.load(wav2mel_path, map_location=device)
    embedder = torch.jit.load(embedder_path, map_location=device).eval()

    def embed(wav: np.ndarray, sr: int) -> np.ndarray:
        t = torch.from_numpy(np.asarray(wav, np.float32))[None].to(device)
        mel = wav2mel(t, sr)
        with torch.no_grad():
            return embedder.embed_utterance(mel).cpu().numpy()

    return embed


def _extract_f0_bucketed(wav: np.ndarray, cfg: F0Config,
                         device=None) -> np.ndarray:
    """Pad to a length bucket, track on `device`, trim: float32 (frames,)."""
    device = resolve_device(device)
    n = len(wav)
    pad = (-n) % F0_PAD_BUCKET
    x = torch.as_tensor(np.pad(np.asarray(wav, np.float32), (0, pad)),
                        device=device)
    with torch.inference_mode(), full_f32():
        f0 = extract_f0(x, cfg).cpu().numpy()
    return f0[:cfg.num_frames(n)]


def _normalize_voiced(f0: np.ndarray, mean: float, std: float) -> np.ndarray:
    """ops/f0.py's normalize_nonzero of a float32 track, on the host."""
    return normalize_nonzero(torch.from_numpy(f0), mean,
                             max(std, 1e-8)).numpy()


@dataclasses.dataclass(frozen=True)
class CodeDatasetConfig:
    segment_size: int = 8960
    code_hop_size: int = 320
    mel: MelConfig = VOCODER_MEL_16K_FULLBAND
    f0: F0Config = F0Config()
    f0_hop: int = 80
    multispkr: Optional[str] = "_"    # parse_speaker method; falsy =
                                      # single-speaker (dataset.py:288 gates
                                      # parsing behind `if path_to_name:`)
    f0_normalize: bool = True
    embedding_dim: int = 256


class CodeDataset:
    """(files, codes) from a JSON-lines manifest → aligned training items."""

    def __init__(self, files: Sequence, codes: Sequence[np.ndarray],
                 cfg: CodeDatasetConfig = CodeDatasetConfig(), *,
                 f0_stats: Optional[Dict] = None,
                 embedder: Optional[Callable] = None,
                 cache_dir: Optional[str] = None, device=None):
        assert len(files) == len(codes)
        self.device = resolve_device(device)
        self.files = [str(f) for f in files]
        self.codes = [np.asarray(c).astype(np.int64) for c in codes]
        self.cfg = cfg
        self.f0_stats = f0_stats
        self.embedder = embedder or mel_stats_embedder(cfg.embedding_dim,
                                                       device=self.device)
        if cfg.multispkr:
            self.id_to_spkr = sorted({parse_speaker(f, cfg.multispkr)
                                      for f in self.files})
        else:                         # single-speaker (falsy multispkr)
            self.id_to_spkr = ["A"]
        self.spkr_to_id = {s: i for i, s in enumerate(self.id_to_spkr)}
        self._cache_dir = cache_dir
        self.items = [self._load_item(i) for i in range(len(self.files))]

    # ---- preprocessing ---------------------------------------------------

    def _item_key(self, idx: int) -> str:
        h = hashlib.sha256()
        h.update(json.dumps({
            "file": self.files[idx], "code": self.codes[idx].tolist(),
            "seg": self.cfg.segment_size,
            "mel": dataclasses.asdict(self.cfg.mel),
            "f0n": self.cfg.f0_normalize}, default=str).encode())
        return h.hexdigest()[:20]

    def _spk_stats(self, spk_idx: int):
        stats = self.f0_stats or {"f0_mean": 0.0, "f0_std": 1.0}
        if isinstance(stats, dict) and spk_idx in stats:
            stats = stats[spk_idx]
        return float(stats["f0_mean"]), float(stats["f0_std"])

    def _preprocess(self, idx: int) -> dict:
        cfg = self.cfg
        wav, sr = load_wav(self.files[idx], target_sr=16000)
        audio = peak_normalize(wav, 0.95)
        spkr = (self.spkr_to_id[parse_speaker(self.files[idx],
                                              cfg.multispkr)]
                if cfg.multispkr else 0)
        emb = np.asarray(self.embedder(audio, sr), np.float32)

        f0 = _extract_f0_bucketed(audio, cfg.f0, self.device)
        if cfg.f0_normalize:
            mean, std = self._spk_stats(spkr)
            if self.f0_stats is None:           # per-utterance fallback
                voiced = f0[f0 > 0]
                mean = float(voiced.mean()) if voiced.size else 0.0
                std = float(voiced.std()) if voiced.size else 1.0
            f0 = _normalize_voiced(f0, mean, std)

        x = torch.as_tensor(audio, device=self.device)
        with torch.inference_mode(), full_f32():
            mel = mel_spectrogram(x, cfg.mel).cpu().numpy()
        code = self.codes[idx]

        audio_m, code_m, f0_m, mel_m = match_length(
            [(audio, 1), (code, cfg.code_hop_size), (f0, cfg.f0_hop),
             (mel, cfg.mel.hop_size)], min_length=cfg.segment_size)
        return dict(audio=audio_m.astype(np.float32), code=code_m,
                    f0=f0_m[None].astype(np.float32),
                    mel=mel_m.astype(np.float32), emb=emb,
                    spkr=np.array([spkr], np.int64))

    def _load_item(self, idx: int) -> dict:
        if self._cache_dir is None:
            return self._preprocess(idx)
        os.makedirs(self._cache_dir, exist_ok=True)
        path = Path(self._cache_dir, self._item_key(idx) + ".npz")
        if path.exists():
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        item = self._preprocess(idx)
        np.savez(path, **item)
        return item

    # ---- batching ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        return self.items[idx]

    def clip(self, idx: int, rng: np.random.Generator) -> dict:
        cfg = self.cfg
        it = self.items[idx]
        audio, code, f0, mel = clip_segment_random(
            [(it["audio"], 1), (it["code"], cfg.code_hop_size),
             (it["f0"], cfg.f0_hop), (it["mel"], cfg.mel.hop_size)],
            cfg.segment_size, rng)
        return dict(audio=audio[None], code=code, f0=f0, mel_loss=mel,
                    emb=it["emb"], spkr=it["spkr"])

    def batches(self, batch_size: int, *, epoch: int = 0, seed: int = 1234,
                shuffle: bool = True, drop_last: bool = True
                ) -> Iterator[dict]:
        """numpy batches: audio (B, 1, S), code (B, S/320) and spkr (B, 1)
        int32, f0 (B, 1, S/80), mel_loss (B, n_mels, S/256) and emb (B, E)
        float32."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        order = rng.permutation(len(self)) if shuffle else np.arange(len(self))
        end = (len(order) // batch_size) * batch_size if drop_last \
            else len(order)
        for s in range(0, end, batch_size):
            items = [self.clip(i, rng) for i in order[s:s + batch_size]]
            yield {k: np.stack([it[k] for it in items]).astype(
                np.int32 if k in ("code", "spkr") else np.float32)
                for k in items[0]}


class F0DatasetTPU:
    """F0Dataset (I_da/src/dataset.py:452-545): f0-only random clips for the
    pitch quantizer's trainer; f0 hop 80 samples (5 ms), segments in sample
    scale. The JAX package's name is kept; the tracking runs on
    `device`."""

    def __init__(self, files: Sequence, *, segment_size: int = 16640,
                 f0_cfg: F0Config = F0Config(), f0_normalize: bool = True,
                 f0_stats: Optional[Dict] = None,
                 cache_dir: Optional[str] = None, device=None):
        device = resolve_device(device)
        self.files = [str(f) for f in files]
        self.segment_size = segment_size
        self.f0_cfg = f0_cfg
        self.hop = f0_cfg.hop
        self.f0s: List[np.ndarray] = []
        for f in self.files:
            cached = None
            if cache_dir:
                os.makedirs(cache_dir, exist_ok=True)
                key = hashlib.sha256(
                    (f + str(segment_size)).encode()).hexdigest()[:20]
                p = Path(cache_dir, f"f0_{key}.npy")
                cached = np.load(p) if p.exists() else None
            if cached is None:
                wav, _ = load_wav(f, target_sr=f0_cfg.sr)
                f0 = _extract_f0_bucketed(peak_normalize(wav, 0.95), f0_cfg,
                                          device)
                if f0_normalize:
                    stats = f0_stats or {}
                    voiced = f0[f0 > 0]
                    mean = stats.get("f0_mean",
                                     float(voiced.mean()) if voiced.size
                                     else 0.0)
                    std = stats.get("f0_std",
                                    float(voiced.std()) if voiced.size
                                    else 1.0)
                    f0 = _normalize_voiced(f0, mean, std)
                cached = f0.astype(np.float32)
                if cache_dir:
                    np.save(p, cached)
            (f0_m,) = match_length([(cached, self.hop)],
                                   min_length=segment_size)
            self.f0s.append(f0_m)

    def __len__(self) -> int:
        return len(self.files)

    def batches(self, batch_size: int, *, epoch: int = 0, seed: int = 1234,
                shuffle: bool = True) -> Iterator[dict]:
        """{"f0": (B, 1, segment_size/80) float32} batches, the last partial
        one dropped."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        order = rng.permutation(len(self)) if shuffle else np.arange(len(self))
        end = (len(order) // batch_size) * batch_size
        for s in range(0, end, batch_size):
            clips = [clip_segment_random([(self.f0s[i], self.hop)],
                                         self.segment_size, rng)[0]
                     for i in order[s:s + batch_size]]
            yield {"f0": np.stack(clips)[:, None, :].astype(np.float32)}
